"""Slab-sharded dense-cell engine: z-slabs of cells, one a shard —
counterpart of emdee_tpu/distributed/cell_dense_sharded.py, on the
(D, 1, 1) mesh of `distributed/mesh.py` (`make_mesh`).

- The (M³, C) slot grid (cell-major, z slowest) is cut along z: shard d
  owns cell layers [d·Mloc, (d+1)·Mloc).  A state keeps its (cells, C, …)
  leaves: all M³ cells on a `LocalMesh` (every shard in this process), a
  rank's own Mloc·M² on a `DistMesh`.
- The force pass exchanges each shard's top and bottom cell layers with
  its ring neighbours (`mesh.shift`, the reference's `ppermute`), builds a
  z-extended local grid and evaluates the full 27-cell shell with
  centre-only accumulation (`_local_forces`): each pair is computed by
  both owners, so no force travels back.
- Rebinning is the global sort `_rebin` of `neighbors/cell_dense.py` at
  every block start, atom migration between slabs included: on a
  `DistMesh` every rank runs it on the all-gathered slots, identically,
  and keeps its own rows.  The integrator is velocity Verlet (kick, drift,
  kick) without a mid-block wrap and without the dense engine's Kahan
  compensation, as the reference's.

Plain torch ops on the card as on the CPU, the reference having no
Pallas kernel here, but for `_rebin`, which launches the sort rebin
kernel for CUDA tensors (the plain rebin's bits).  Displacements take the port's minimum image of the raw
difference, d − L·round(d/L), with the box a 0-d device tensor.
Requires cells_per_dim % D == 0 and ≥ 2 layers a shard when D > 1.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from emdee_tpu_torch.core.pbc import displacement
from emdee_tpu_torch.core.types import _f32
from emdee_tpu_torch.distributed.mesh import GridMesh
from emdee_tpu_torch.neighbors.cell_dense import (
    CellDenseConfig,
    CellDenseState,
    _box,
    _needs_rebin,
    _rebin,
)
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel, pair_interaction

_FULL_SHELL = [
    (dz, dy, dx)
    for dz in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
]
# The per-slot leaves of a state, which the rebin moves and a shard holds
# its own rows of.
_SLOT_LEAVES = ("positions", "velocities", "inv_masses", "half_sigma", "twice_sqrt_eps", "atom_id", "valid",
                "ref_positions", "charges")


def validate_sharded_config(config: CellDenseConfig, num_devices: int) -> int:
    """Cell layers a shard; raises if M does not divide over the shards or
    leaves fewer than 2 layers on each of several shards."""
    m = config.cells_per_dim
    if m % num_devices != 0:
        raise ValueError(
            f"cells_per_dim {m} must divide evenly over {num_devices} devices"
        )
    m_loc = m // num_devices
    if num_devices > 1 and m_loc < 2:
        raise ValueError(
            f"{m_loc} cell layer(s) per device — need ≥ 2 so halos don't alias"
        )
    return m_loc


def _slab_count(mesh: GridMesh) -> int:
    if tuple(mesh.shape[1:]) != (1, 1):
        raise ValueError(f"the slab engine takes a (D, 1, 1) mesh (`make_mesh`), got {tuple(mesh.shape)}")
    return mesh.shape[0]


def _halo_exchange(layers_lo, layers_hi, mesh: GridMesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(my bottom layer, my top layer) → (lower halo, upper halo), each
    (L, …) over this process's L shards: the lower halo is the left
    neighbour's top layer, the upper the right neighbour's bottom one.  On
    a mesh of one shard `shift` returns its input, which is the periodic
    wrap of the shard's own grid."""
    lead = layers_lo.shape[0]
    ring = lambda x, d: mesh.shift(x.reshape((1, lead, 1, 1) + tuple(x.shape[1:])), 0, d).reshape(x.shape)  # noqa: E731
    return ring(layers_hi, -1), ring(layers_lo, +1)


def _local_forces(pos, hs, tse, valid, model: LennardJonesModel, config: CellDenseConfig, m_loc: int,
                  mesh: GridMesh, compute_energy: bool):
    """Per-shard force pass over a z-extended cell grid: pos (L·Mloc·M², C,
    3), this process's shards' slots; returns per-slot forces (and, with
    `compute_energy`, half-split energies and virials).

    The 27 offsets in the reference's order, each neighbour block from the
    extended grid (z through its halo layers, y and x by periodic rolls);
    the self pair masked only in the (0, 0, 0) block; masked pairs at
    r² = 1."""
    m, c = config.cells_per_dim, config.capacity
    lead = pos.shape[0] // (m_loc * m * m)
    box = _box(config.box, pos)
    # One (L, Mloc, M², C, 6) table a shard: positions, half σ, 2√ε, valid.
    table = torch.cat([pos, hs[..., None], tse[..., None], valid[..., None].to(pos.dtype)], dim=-1)
    grid = table.reshape(lead, m_loc, m * m, c, 6)
    halo_lo, halo_hi = _halo_exchange(grid[:, :1], grid[:, -1:], mesh)
    ext = torch.cat([halo_lo, grid, halo_hi], dim=1).reshape(lead, m_loc + 2, m, m, c, 6)

    forces = torch.zeros_like(pos)
    energies = torch.zeros_like(hs) if compute_energy else None
    virials = torch.zeros_like(hs) if compute_energy else None
    eye = torch.eye(c, dtype=torch.bool, device=pos.device)
    for dz, dy, dx in _FULL_SHELL:
        blk = torch.roll(ext[:, 1 + dz : 1 + dz + m_loc], shifts=(-dy, -dx), dims=(2, 3)).reshape(-1, c, 6)
        dv = displacement(pos[:, :, None, :], blk[:, None, :, :3], box)
        r2 = dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1] + dv[..., 2] * dv[..., 2]
        ok = valid[:, :, None] & (blk[:, None, :, 5] > 0.5)
        if (dz, dy, dx) == (0, 0, 0):
            ok = ok & ~eye[None]
        r2s = torch.where(ok, r2, 1.0)
        e, mre = pair_interaction(r2s, model, hs[:, :, None], tse[:, :, None], blk[:, None, :, 3], blk[:, None, :, 4])
        g = torch.where(ok, mre / r2s, 0.0)
        forces = forces + torch.stack([torch.sum(g * dv[..., k], dim=-1) for k in range(3)], dim=-1)
        if compute_energy:
            energies = energies + 0.5 * torch.sum(torch.where(ok, e, 0.0), dim=-1)
            virials = virials + 0.5 * torch.sum(torch.where(ok, mre, 0.0), dim=-1)
    return forces, energies, virials


def _own(state: CellDenseState, rows: slice) -> CellDenseState:
    return state._replace(**{k: getattr(state, k)[rows] for k in _SLOT_LEAVES if getattr(state, k) is not None})


def make_sharded_cell_dense_sim(config: CellDenseConfig, model: LennardJonesModel, dt: float, mesh: GridMesh):
    """(rollout, energy) for the slab-sharded dense-cell engine.

    rollout(state, num_steps, rebin_every=10) — the single-card
    `make_cell_dense_sim`'s contract: each block starts with the global
    sort rebin (which also permutes the carried forces), runs
    `rebin_every` kick-drift-kick steps (the remainder last) and ORs the
    skin/2 staleness check (`_needs_rebin`, reduced over the mesh) into the
    sticky flag.  energy(state) → (pe, virial, ke), each summed over the
    mesh.  The state is `distribute_cell_dense`'s."""
    ndev = _slab_count(mesh)
    m_loc = validate_sharded_config(config, ndev)
    per_shard = m_loc * config.cells_per_dim**2
    own_rows = slice(mesh.base[0] * per_shard, (mesh.base[0] + mesh.local_shape[0]) * per_shard)
    dt_f = _f32(dt)
    half_dt = _f32(np.float32(0.5) * np.float32(dt))

    def pass_of(state: CellDenseState, compute_energy: bool):
        return _local_forces(state.positions, state.half_sigma, state.twice_sqrt_eps, state.valid, model, config,
                             m_loc, mesh, compute_energy)

    def rebin(state: CellDenseState, forces):
        """The global sort rebin: every shard's slots gathered, `_rebin` on
        the whole grid (the same on every rank), each keeping its rows."""
        whole = state._replace(**{k: mesh.all_gather(getattr(state, k))
                                  for k in _SLOT_LEAVES if getattr(state, k) is not None})
        whole, forces = _rebin(whole, config, forces=mesh.all_gather(forces))
        state = _own(whole, own_rows)
        return state._replace(overflow=mesh.pmax(state.overflow)), forces[own_rows]

    def one_step(state: CellDenseState, forces):
        # No mid-block wrap: positions are wrapped at rebin time, and the
        # minimum image tolerates the ≤ skin/2 overhang.
        inv_m = state.inv_masses[..., None]
        v_half = state.velocities + half_dt * forces * inv_m
        new_pos = torch.where(state.valid[..., None], state.positions + dt_f * v_half, state.positions)
        state = state._replace(positions=new_pos, velocities=v_half)
        new_forces = pass_of(state, False)[0]
        new_vel = state.velocities + half_dt * new_forces * inv_m
        return state._replace(velocities=new_vel, step=state.step + 1), new_forces

    def rollout(state: CellDenseState, num_steps: int, rebin_every: int = 10) -> CellDenseState:
        blocks, rem = divmod(num_steps, rebin_every)
        forces = pass_of(state, False)[0]
        for length in [rebin_every] * blocks + ([rem] if rem else []):
            state, forces = rebin(state, forces)
            for _ in range(length):
                state, forces = one_step(state, forces)
            state = state._replace(overflow=state.overflow | mesh.pmax(_needs_rebin(state, config)))
        return state

    def energy(state: CellDenseState):
        _, e, w = pass_of(state, True)
        pe = torch.sum(torch.where(state.valid, e, 0.0))
        vir = torch.sum(torch.where(state.valid, w, 0.0))
        ke = 0.5 * torch.sum(torch.where(
            state.valid[..., None],
            state.velocities**2 / torch.clamp(state.inv_masses[..., None], min=1e-30),
            0.0,
        ))
        return mesh.psum(pe), mesh.psum(vir), mesh.psum(ke)

    rollout.forces = lambda state, compute_energy=False: pass_of(state, compute_energy)
    return rollout, energy


def distribute_cell_dense(state: CellDenseState, mesh: GridMesh) -> CellDenseState:
    """Place an initialised CellDenseState on the slab mesh's device (by
    default the CUDA card, `make_mesh`): every cell on a `LocalMesh`, a
    rank's own z-slab of Mloc·M² cells on a `DistMesh`; scalars
    replicated."""
    ndev = _slab_count(mesh)
    cells = state.positions.shape[0]
    if cells % ndev:
        raise ValueError(f"{cells} cells do not divide over {ndev} slabs")
    per = cells // ndev
    lo = mesh.base[0] * per
    state = _own(state, slice(lo, lo + mesh.local_shape[0] * per))
    return CellDenseState(*(a.to(mesh.device) if isinstance(a, torch.Tensor) else a for a in state))


def gather_cell_dense(state: CellDenseState, mesh: GridMesh) -> CellDenseState:
    """The whole (M³, C, …) state on the mesh's device: on a `DistMesh`
    every rank takes part (an all-gather) and gets every slab."""
    return state._replace(**{k: mesh.all_gather(getattr(state, k))
                             for k in _SLOT_LEAVES if getattr(state, k) is not None})
