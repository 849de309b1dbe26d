"""3-D grid-sharded dense-cell engine — counterpart of
emdee_tpu/distributed/grid_sharded.py (the Lennard-Jones part: NVE and CSVR
NVT).

The (M, M, M, C) slot grid is cut into an (nz, ny, nx) mesh of shards of
(mz, my, mx) cells (`distributed/mesh.py`); a state's per-slot leaves are
(sz, sy, sx, mz, my, mx, C, …), the shards this process holds (all of them
on a `LocalMesh`, its own on a `DistMesh`).  Every exchange between shards
goes through the mesh's `shift` (the reference's `ppermute`):

- **Force pass**: each shard's (mz+2, my+2, mx+2, C) ghost grid is built by
  successive z, y and x exchanges of one boundary layer, so that edges and
  corners arrive in two hops (`_ghost3`).  The force kernel's GHOST mode
  (`cell_kernel.ghost_forces`, K2) walks the full 27-cell shell from the
  ghost grid, taking each periodic shift from the neighbour's global cell
  index on raw coordinates: the forces of any decomposition equal the
  one-card kernel's bit for bit.  The reference runs K2's half shell with
  reaction ghosts and folds them back with three more exchanges; the full
  shell needs no reaction rows, no fold and no second exchange.
- **Rebin**: the shift rebin's three passes (z, y, x), each over own, left
  and right windows built by one exchange along the pass axis, with each
  row's global coordinate (`rebin_window_kernel.rebin_window_pass`, K6).
  Atom migration between shards is that exchange.
- **Reductions**: energies, the kinetic energy of CSVR and the sticky flag
  are reduced over the shards (`psum`, `pmax`).

Nothing in a rollout waits for the device; the flag stays there until the
caller reads it.  A (1, 1, 1) mesh is the one-card engine's geometry; its
leapfrog here, like the reference's grid engine, carries no Kahan
compensation.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from emdee_tpu_torch.distributed.mesh import DistMesh, GridMesh, validate_grid_config
from emdee_tpu_torch.neighbors.cell_dense import (
    CellDenseConfig,
    CellDenseState,
    CSVRConfig,
    LangevinConfig,
    _box,
    _f32,
    _stale,
    gather_dense_atoms,
    resolve_backend,
)
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel

# Grid axis k (0 = z, 1 = y, 2 = x) ↔ position component (x = 0, y = 1, z = 2).
_COORD_OF_AXIS = (2, 1, 0)


def _grid_leaves(state: CellDenseState, config: CellDenseConfig) -> CellDenseState:
    """(M³, C, …) leaves → (M, M, M, C, …) grid layout (axes z, y, x)."""
    m = config.cells_per_dim

    def to_grid(a):
        if isinstance(a, torch.Tensor) and a.dim() >= 2 and a.shape[0] == config.num_cells:
            return a.reshape((m, m, m) + tuple(a.shape[1:]))
        return a

    return CellDenseState(*(to_grid(a) for a in state))


def _flat_leaves(state: CellDenseState, config: CellDenseConfig) -> CellDenseState:
    """(M, M, M, C, …) grid leaves → (M³, C, …)."""
    m = config.cells_per_dim

    def to_flat(a):
        if isinstance(a, torch.Tensor) and a.dim() >= 4 and tuple(a.shape[:3]) == (m, m, m):
            return a.reshape((config.num_cells,) + tuple(a.shape[3:]))
        return a

    return CellDenseState(*(to_flat(a) for a in state))


def _is_slot_leaf(a) -> bool:
    return isinstance(a, torch.Tensor) and a.dim() >= 3


def distribute_grid(state: CellDenseState, config: CellDenseConfig, mesh: GridMesh) -> CellDenseState:
    """One-card CellDenseState → the grid-sharded state of this process's
    shards on the mesh's device: per-slot leaves (sz, sy, sx, mz, my, mx,
    C, …), scalars replicated."""
    locs = validate_grid_config(config, mesh)
    nz, ny, nx = mesh.shape
    lo, n = mesh.base, mesh.local_shape

    def shard(a):
        if not isinstance(a, torch.Tensor):
            return a
        if not _is_slot_leaf(a):
            return a.to(mesh.device)
        rest = tuple(a.shape[3:])
        blocks = a.reshape((nz, locs[0], ny, locs[1], nx, locs[2]) + rest)
        blocks = blocks.permute((0, 2, 4, 1, 3, 5) + tuple(range(6, 6 + len(rest))))
        own = blocks[lo[0] : lo[0] + n[0], lo[1] : lo[1] + n[1], lo[2] : lo[2] + n[2]]
        return own.contiguous().to(mesh.device)

    return CellDenseState(*(shard(a) for a in _grid_leaves(state, config)))


def gather_grid_state(state: CellDenseState, config: CellDenseConfig, mesh: GridMesh) -> CellDenseState:
    """Grid-sharded state → the one-card CellDenseState ((M³, C, …)
    leaves) on the mesh's device; on a `DistMesh` every rank takes part
    (an all-gather) and gets the whole state."""
    m = config.cells_per_dim
    nz, ny, nx = mesh.shape

    def unshard(a):
        if not _is_slot_leaf(a):
            return a
        if isinstance(mesh, DistMesh):
            import torch.distributed as dist

            sent = a.to(torch.uint8) if a.dtype == torch.bool else a.contiguous()
            parts = [torch.empty_like(sent) for _ in range(int(np.prod(mesh.shape)))]
            dist.all_gather(parts, sent, group=mesh.group)
            a = torch.cat(parts).reshape((nz, ny, nx) + tuple(a.shape[3:])).to(a.dtype)
        rest = tuple(a.shape[6:])
        grid = a.permute((0, 3, 1, 4, 2, 5) + tuple(range(6, 6 + len(rest))))
        return grid.reshape((m, m, m) + rest)

    return _flat_leaves(CellDenseState(*(unshard(a) for a in state)), config)


def gather_grid_atoms(state: CellDenseState, config: CellDenseConfig, num_atoms: int, mesh: GridMesh):
    """Grid-sharded state → (N, 3) positions and velocities by atom id
    (numpy, host)."""
    return gather_dense_atoms(gather_grid_state(state, config, mesh), num_atoms)


def reconfigure_grid_state(state: CellDenseState, config: CellDenseConfig, mesh: GridMesh):
    """The reference's NPT geometry re-derive for a grid-sharded run."""
    raise NotImplementedError("reconfigure_grid_state is not ported yet (ROADMAP item 11)")


def _ghost3(g: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """(F, sz, sy, sx, mz, my, mx, C) → (F, sz, sy, sx, mz+2, my+2, mx+2, C):
    the z, then y, then x boundary layers of the neighbour shards, so that
    edges and corners arrive in two hops."""
    for axis in range(3):
        dim, n = 4 + axis, g.shape[4 + axis]
        lo = mesh.shift(g.narrow(dim, n - 1, 1), axis, -1)  # the −axis neighbour's top layer
        hi = mesh.shift(g.narrow(dim, 0, 1), axis, +1)
        g = torch.cat([lo, g, hi], dim=dim)
    return g


def _window(x: torch.Tensor, mesh: GridMesh, axis: int, d: int) -> torch.Tensor:
    """Each cell's d = ±1 neighbour along grid axis `axis` for (F, sz, sy,
    sx, mz, my, mx, C) x: the local layers shifted by one, the missing layer
    from the neighbour shard."""
    dim, n = 4 + axis, x.shape[4 + axis]
    if d > 0:
        return torch.cat([x.narrow(dim, 1, n - 1), mesh.shift(x.narrow(dim, 0, 1), axis, +1)], dim=dim)
    return torch.cat([mesh.shift(x.narrow(dim, n - 1, 1), axis, -1), x.narrow(dim, 0, n - 1)], dim=dim)


def make_grid_sharded_sim(
    config: CellDenseConfig,
    model: LennardJonesModel,
    dt: float,
    mesh: GridMesh,
    backend: str = "auto",
    uniform_params=None,
    coulomb=None,
    excl_tables=None,
    thermostat=None,
    barostat=None,
    bonded=None,
    excl_leftover=None,
    atom_params=None,
    atom_charges=None,
):
    """(rollout, energy) closures on a grid-sharded state (`distribute_grid`).

    backend: 'auto' (the kernels K2 and K6 for CUDA tensors, their plain
    versions for CPU tensors), 'cuda' or 'torch' (the plain versions on any
    device).  uniform_params: optional (half_sigma, twice_sqrt_eps) floats
    shared by every atom (`detect_uniform_params`); the ghost grids then
    carry positions only.  thermostat: None (leapfrog NVE, no Kahan
    compensation, as the reference's grid engine) or `CSVRConfig` (the
    synced kick-drift-kick with one global rescale a step: the kinetic
    energy summed over the shards, one draw from the rollout's `rng`, a
    `torch.Generator` on the mesh's device seeded alike on every rank).

    Not ported yet, each raising NotImplementedError: Langevin, barostat and
    spill configs (ROADMAP item 11), the per-shard streaming backend (K5's
    sharded entries, item 11), coulomb, excl_tables, bonded, excl_leftover,
    atom_params and atom_charges (the molecular grid, item 11.2, K2c-G)."""
    from emdee_tpu_torch.dynamics.bussi import _csvr_alpha2, csvr_draws
    from emdee_tpu_torch.neighbors import cell_kernel
    from emdee_tpu_torch.neighbors.rebin_kernel import SENTINEL_BITS
    from emdee_tpu_torch.neighbors.rebin_window_kernel import rebin_window_pass

    molecular = (("coulomb", coulomb), ("excl_tables", excl_tables), ("bonded", bonded),
                 ("excl_leftover", excl_leftover), ("atom_params", atom_params), ("atom_charges", atom_charges))
    for name, value in molecular:
        if value is not None:
            raise NotImplementedError(f"{name} on the grid-sharded engine is not ported yet (ROADMAP item 11.2, K2c-G)")
    if isinstance(thermostat, LangevinConfig):
        raise NotImplementedError("Langevin on the grid-sharded engine is not ported yet (ROADMAP item 11)")
    if thermostat is not None and not isinstance(thermostat, CSVRConfig):
        raise ValueError(f"unknown thermostat {thermostat!r}")
    if barostat is not None:
        raise NotImplementedError("the barostat on the grid-sharded engine is not ported yet (ROADMAP item 11)")
    if config.spill:
        raise NotImplementedError("spill configs on the grid-sharded engine are not ported yet (ROADMAP item 11)")
    if backend in ("cuda_streaming", "pallas_streaming"):
        raise NotImplementedError("the per-shard streaming backend (K5's sharded entries) is not ported yet "
                                  "(ROADMAP item 11)")
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}: use 'auto', 'cuda' or 'torch'")

    mz, my, mx = validate_grid_config(config, mesh)
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    lead = mesh.local_shape
    shards = math.prod(lead)
    dev = mesh.device
    dt_f = _f32(dt)
    half_dt = _f32(np.float32(0.5) * np.float32(dt))
    ndof = 3.0 * config.num_atoms - 3.0
    uniform = uniform_params is not None

    def b_global(axis: int) -> torch.Tensor:
        """(shards·mz, my·mx, 1) int32: each cell's global coordinate along
        grid axis `axis`, as K6 reads it (planes = the shards' z layers)."""
        loc = (mz, my, mx)[axis]
        idx = mesh.axis_index(axis)[:, None] * loc + torch.arange(loc, device=dev)
        shape = [1] * 6
        shape[axis], shape[3 + axis] = lead[axis], loc
        full = idx.reshape(shape).expand(tuple(lead) + (mz, my, mx))
        return full.reshape(shards * mz, my * mx, 1).to(torch.int32).contiguous()

    b_axes = [b_global(axis) for axis in range(3)]
    # The routing fill of empty position slots, and the ghost grids' mark of them.
    sentinel = torch.full((), SENTINEL_BITS, dtype=torch.int32, device=dev).view(torch.float32)
    nan = torch.full((), float("nan"), dtype=torch.float32, device=dev)

    def forces_of(pos3, valid, hs, tse, compute_energy=False):
        """(forces (3, …), e, w) of the local shards; pos3 (3, sz, sy, sx,
        mz, my, mx, C)."""
        g = torch.where(valid, pos3, nan)
        if not uniform:
            g = torch.cat([g, hs[None], tse[None]])
        return cell_kernel.ghost_forces(
            _ghost3(g, mesh), lead, mesh.base, config, model, uniform_params=uniform_params,
            compute_energy=compute_energy, backend=resolve_backend(backend, pos3),
        )

    def rebin(pos3, vel3, inv_m, hs, tse, aid, valid, overflow, f3=None):
        """The per-shard shift rebin: three K6 passes (z, y, x) over the
        transported fields stacked as int32.  Returns the routed (pos3, vel3,
        inv_m, hs, tse, aid, valid, overflow, f3)."""
        box_t = _box(config.box, pos3)
        posw = torch.where(valid, pos3 - torch.floor(pos3 / box_t) * box_t, sentinel)
        parts = [posw, vel3, inv_m[None], hs[None], tse[None]] + ([] if f3 is None else [f3])
        x = torch.cat([p.view(torch.int32) for p in parts] + [aid[None]])
        nf, shape = x.shape[0], x.shape
        flat = (nf, shards * mz, my * mx, c)
        for axis in range(3):
            out, ovf = rebin_window_pass(
                x.reshape(flat), _window(x, mesh, axis, -1).reshape(flat), _window(x, mesh, axis, +1).reshape(flat),
                b_axes[axis], box_t, _COORD_OF_AXIS[axis], m, c, ns, backend=resolve_backend(backend, x),
            )
            x = out.reshape(shape)
            overflow = overflow | ovf
        aid = x[-1]
        valid = aid < ns
        xf = x[:-1].view(torch.float32)  # empty slots: the fill, 0 beyond the positions
        pos3 = torch.where(valid, xf[0:3], 0.0)
        return pos3, xf[3:6], xf[6], xf[7], xf[8], aid, valid, overflow, (None if f3 is None else xf[9:12])

    def stale(pos3, ref3, valid):
        d = pos3 - ref3
        return _stale(d[0], d[1], d[2], valid, config)

    def unpack(st: CellDenseState):
        return (st.positions.movedim(-1, 0).contiguous(), st.velocities.movedim(-1, 0).contiguous(),
                st.inv_masses, st.half_sigma, st.twice_sqrt_eps, st.atom_id, st.valid)

    def lengths_of(num_steps, rebin_every):
        blocks, rem = divmod(num_steps, rebin_every)
        return [rebin_every] * blocks + ([rem] if rem else [])

    def rollout(state: CellDenseState, num_steps: int, rebin_every: int = 10,
                rng: Optional[torch.Generator] = None) -> CellDenseState:
        """Blocked rollout: rebin every `rebin_every` steps, then run that
        many steps; the flag is OR'd over the shards at the end.  A CSVR
        rollout needs `rng`, a `torch.Generator` on the mesh's device."""
        if thermostat is not None and rng is None:
            raise ValueError("a thermostatted rollout needs an rng: a torch.Generator on the mesh's device")
        if num_steps == 0:
            return state
        pos3, vel3, inv_m, hs, tse, aid, valid = unpack(state)
        ref3, overflow = state.ref_positions.movedim(-1, 0), state.overflow
        f = forces_of(pos3, valid, hs, tse)[0]
        if thermostat is None:
            # Leapfrog: velocities ride half a step ahead, so no force field
            # crosses a rebin; a closing half un-kick re-syncs.
            vel3 = torch.where(valid, vel3 + half_dt * f * inv_m, 0.0)
        for length in lengths_of(num_steps, rebin_every):
            pos3, vel3, inv_m, hs, tse, aid, valid, overflow, f = rebin(
                pos3, vel3, inv_m, hs, tse, aid, valid, overflow, None if thermostat is None else f)
            ref3 = pos3
            for _ in range(length):
                if thermostat is None:
                    x = torch.where(valid, pos3 + dt_f * vel3, pos3)
                    f = forces_of(x, valid, hs, tse)[0]
                    vel3 = torch.where(valid, vel3 + dt_f * f * inv_m, 0.0)
                else:
                    v_half = vel3 + half_dt * f * inv_m
                    x = torch.where(valid, pos3 + dt_f * v_half, pos3)
                    f = forces_of(x, valid, hs, tse)[0]
                    v = v_half + half_dt * f * inv_m
                    kin = 0.5 * torch.sum(torch.where(valid, v**2 / torch.clamp(inv_m, min=1e-30), 0.0))
                    kin = mesh.psum(kin)
                    r1, sum_r2 = csvr_draws(rng, ndof, v)
                    alpha2 = _csvr_alpha2(r1, sum_r2, torch.clamp(kin, min=1e-30), ndof,
                                          thermostat.kB * thermostat.temperature, dt_f, thermostat.tau)
                    vel3 = torch.sqrt(torch.clamp(alpha2, min=0.0)) * v
                pos3 = x
            overflow = overflow | stale(pos3, ref3, valid)
        if thermostat is None:
            f = forces_of(pos3, valid, hs, tse)[0]
            vel3 = torch.where(valid, vel3 - half_dt * f * inv_m, 0.0)
        return state._replace(
            positions=pos3.movedim(0, -1).contiguous(), velocities=vel3.movedim(0, -1).contiguous(),
            inv_masses=inv_m, half_sigma=hs, twice_sqrt_eps=tse, atom_id=aid, valid=valid,
            ref_positions=ref3.movedim(0, -1).contiguous(), step=state.step + num_steps,
            overflow=mesh.pmax(overflow),
        )

    def energy(state: CellDenseState):
        """(potential energy, virial, kinetic energy) as 0-d tensors, summed
        over every shard."""
        pos3, vel3, inv_m, hs, tse, _, valid = unpack(state)
        _, e, w = forces_of(pos3, valid, hs, tse, compute_energy=True)
        pe = torch.sum(torch.where(valid, e, 0.0))
        vir = torch.sum(torch.where(valid, w, 0.0))
        ke = 0.5 * torch.sum(torch.where(valid, vel3**2 / torch.clamp(inv_m, min=1e-30), 0.0))
        out = mesh.psum(torch.stack([pe, vir, ke]))
        return out[0], out[1], out[2]

    def forces(state: CellDenseState, compute_energy: bool = False):
        """(forces (sz, sy, sx, mz, my, mx, C, 3), e, w) of a grid-sharded
        state: the rollout's force pass, for checks."""
        pos3, _, _, hs, tse, _, valid = unpack(state)
        f, e, w = forces_of(pos3, valid, hs, tse, compute_energy)
        return f.movedim(0, -1), e, w

    rollout.forces = forces
    return rollout, energy


__all__ = [
    "distribute_grid",
    "gather_grid_atoms",
    "gather_grid_state",
    "make_grid_sharded_sim",
    "reconfigure_grid_state",
]
