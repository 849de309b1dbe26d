"""Spatial domain decomposition over a 1-D slab mesh (slabs along z) —
counterpart of emdee_tpu/distributed/domain.py, on the (D, 1, 1) mesh of
`distributed/mesh.py` (`make_mesh`).

Atom-table formulation: each slab's force pass evaluates its owned rows
against all owned + ghost columns, O(N_slab²) — the reference's simplest
sharded engine, for small and medium systems and for the ghost and
ownership semantics; the O(N) multi-card engine is `grid_sharded`.  Each
step, every slab

1. packs the atoms within a halo width of its faces into fixed halo buffers
   (`_halo_pack`) and exchanges them with its ±1 ring neighbours
   (`mesh.shift`, the reference's `ppermute`);
2. computes forces for its owned atoms against owned + ghost candidates,
   in chunks of 2,048 rows (`_shard_forces`) — full accumulation, so no
   force travels back;
3. integrates its owned atoms (velocity Verlet, positions wrapped every
   step).

Ownership is refreshed every `resort_every` steps by `redistribute`, a
global stable sort of the atom table into slab-major slots; between
refreshes a halo margin (`halo_skin`) keeps the ghost set a superset of
what the cutoff needs, and the sticky `overflow` flag reports a full slot
block, a full halo buffer or an atom that drifted more than `halo_skin`
in z within a block.

A state's leaves keep the reference's flat (D·S, …) leading axis on a
`LocalMesh` (every slab in this process); on a `DistMesh` a rank holds its
own (S, …) block, `redistribute` sorts the all-gathered table identically
on every rank and each keeps its own slots.  The sort and the halo packs
are gathers to unique destinations, so reruns are bitwise.  Displacements
take the port's minimum image of the raw difference, d − L·round(d/L)
(`core/pbc.py` `displacement`), and every division is by a 0-d device
tensor (the box, the slab width), so slab edges fall where the CPU puts
them.  Plain torch ops on the card as on the CPU: the reference has no
Pallas kernel here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from emdee_tpu_torch.core.pbc import displacement, wrap
from emdee_tpu_torch.core.types import LJParams, _f32, _tensor
from emdee_tpu_torch.distributed.mesh import GridMesh
from emdee_tpu_torch.neighbors.cell_dense import _box
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel, pair_interaction

_EMPTY_ID = int(np.iinfo(np.int32).max)


class ShardedState(NamedTuple):
    """Slab-sharded simulation state: leading axis = (local slabs)·slot_capacity."""

    positions: torch.Tensor  # (L*S, 3) float32
    velocities: torch.Tensor  # (L*S, 3) float32
    masses: torch.Tensor  # (L*S,) float32
    half_sigma: torch.Tensor  # (L*S,) float32
    twice_sqrt_eps: torch.Tensor  # (L*S,) float32
    atom_id: torch.Tensor  # (L*S,) int32 — original index; int32 max on empty slots
    valid: torch.Tensor  # (L*S,) bool
    step: torch.Tensor  # () int32
    overflow: torch.Tensor  # () bool — slot/halo capacity or staleness violated


class DomainConfig(NamedTuple):
    """Static decomposition geometry (the reference's fields)."""

    num_devices: int
    slot_capacity: int  # owned-atom slots per slab
    halo_capacity: int  # ghost slots per face
    box: float
    cutoff: float
    halo_skin: float  # extra halo width covering drift between resorts
    resort_every: int

    @property
    def halo_width(self) -> float:
        return self.cutoff + self.halo_skin

    @property
    def slab_width(self) -> float:
        return self.box / self.num_devices


def suggest_domain_config(
    num_atoms: int,
    box: float,
    cutoff: float,
    num_devices: int,
    halo_skin: float = 0.5,
    resort_every: int = 20,
    slot_multiplier: float = 1.3,
    halo_multiplier: float = 1.6,
) -> DomainConfig:
    """Slot and halo capacities from the mean density, with the reference's
    margins; raises if a slab is narrower than two halo widths (atoms would
    ghost through several slabs)."""
    density = num_atoms / box**3
    slab = box / num_devices
    halo_w = cutoff + halo_skin
    if num_devices > 1 and slab < 2.0 * halo_w:
        raise ValueError(
            f"slab width {slab:.3f} < 2×halo width {2 * halo_w:.3f}: too many "
            f"devices for this box (atoms would ghost through multiple slabs)"
        )
    slot = int(np.ceil(num_atoms / num_devices * slot_multiplier)) + 8
    halo = int(np.ceil(density * box * box * halo_w * halo_multiplier)) + 8
    return DomainConfig(
        num_devices=num_devices,
        slot_capacity=_round_up8(slot),
        halo_capacity=_round_up8(halo),
        box=box,
        cutoff=cutoff,
        halo_skin=halo_skin,
        resort_every=resort_every,
    )


def _round_up8(x: int) -> int:
    return -(-x // 8) * 8


def _check_mesh(config: DomainConfig, mesh: GridMesh) -> None:
    if tuple(mesh.shape) != (config.num_devices, 1, 1):
        raise ValueError(f"a {config.num_devices}-slab config needs a ({config.num_devices}, 1, 1) mesh, "
                         f"got {tuple(mesh.shape)}")


# ---------------------------------------------------------------------------
# Global redistribution: sort atoms into the slab-major slot layout.
# ---------------------------------------------------------------------------

# The atom table's packed columns: positions, velocities, mass, half σ,
# 2√ε, the atom id's bits, valid (0/1).
_POS, _VEL, _MASS, _HS, _TSE, _ID, _VALID = slice(0, 3), slice(3, 6), 6, 7, 8, 9, 10


def _pack(state: ShardedState) -> torch.Tensor:
    return torch.cat([state.positions, state.velocities, state.masses[:, None], state.half_sigma[:, None],
                      state.twice_sqrt_eps[:, None], state.atom_id[:, None].view(torch.float32),
                      state.valid[:, None].to(torch.float32)], dim=1)


def _sort_to_slots(table: torch.Tensor, config: DomainConfig, overflow: torch.Tensor):
    """The global bin-and-sort of the reference's `redistribute` on the
    packed (D·S, 11) table: slab from the wrapped z, stable argsort, each
    slab's atoms to slots slab·S + rank.  Written as a gather — slot j of
    slab b takes the (j − b·S)-th atom of b in table order — so every slot
    has one source.  Returns (the new global table's fields, the flag)."""
    d, s = config.num_devices, config.slot_capacity
    total = d * s
    dev = table.device
    box, width = _box(config.box, table), _box(config.slab_width, table)
    valid = table[:, _VALID] > 0.5
    z = table[:, 2]
    zw = z - torch.floor(z / box) * box
    slab = torch.clamp((zw / width).to(torch.int64), 0, d - 1)
    slab = torch.where(valid, slab, d)

    order = torch.argsort(slab, stable=True)
    # Each slab's first sorted row and count, by a binary search on the
    # sorted keys (a CUDA `bincount` reads its size back to the host).
    starts = torch.searchsorted(slab[order], torch.arange(d + 2, device=dev))
    counts = starts[1:] - starts[:-1]
    slot = torch.arange(total, device=dev)
    block, rank = slot // s, slot % s
    new_valid = rank < counts[block]
    src = order[torch.clamp(starts[block] + rank, max=total - 1)]
    moved = table[src]
    keep = new_valid[:, None]
    fields = dict(
        positions=torch.where(keep, moved[:, _POS], 0.0),
        velocities=torch.where(keep, moved[:, _VEL], 0.0),
        masses=torch.where(new_valid, moved[:, _MASS], 1.0),
        half_sigma=torch.where(new_valid, moved[:, _HS], 0.0),
        twice_sqrt_eps=torch.where(new_valid, moved[:, _TSE], 0.0),
        atom_id=torch.where(new_valid, moved[:, _ID].contiguous().view(torch.int32), _EMPTY_ID),
        valid=new_valid,
    )
    return fields, overflow | (torch.max(counts[:d]) > s)


def _own_rows(fields: dict, config: DomainConfig, mesh: GridMesh) -> dict:
    """This process's slabs' slot blocks of a global table."""
    s = config.slot_capacity
    lo = mesh.base[0] * s
    return {k: v[lo : lo + mesh.local_shape[0] * s] for k, v in fields.items()}


def redistribute(state: ShardedState, config: DomainConfig, mesh: GridMesh) -> ShardedState:
    """Re-sort every atom into its owning slab's slot block: the global
    stable sort of the whole atom table (all-gathered on a `DistMesh`, the
    same on every rank), each process keeping its own slabs' slots.  Empty
    slots get atom id int32 max; the flag rises if a slab holds more than
    S atoms."""
    fields, overflow = _sort_to_slots(mesh.all_gather(_pack(state)), config, state.overflow)
    return state._replace(overflow=overflow, **_own_rows(fields, config, mesh))


def distribute(positions, velocities, masses, params: LJParams, config: DomainConfig, mesh: GridMesh) -> ShardedState:
    """Host entry: dense (N, …) arrays → the slot layout of this process's
    slabs on the mesh's device (by default the CUDA card, `make_mesh`).
    Every rank of a `DistMesh` passes the same arrays."""
    _check_mesh(config, mesh)
    n = positions.shape[0]
    total = config.num_devices * config.slot_capacity
    if n > total:
        raise ValueError(f"{n} atoms exceed total slot capacity {total}")
    dev = mesh.device
    pad = total - n

    def pad0(x, fill=0.0):
        x = _tensor(x, np.float32, dev)
        return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])

    atom_id = torch.cat([torch.arange(n, dtype=torch.int32, device=dev),
                         torch.full((pad,), n, dtype=torch.int32, device=dev)])
    valid = torch.arange(total, device=dev) < n
    table = torch.cat([pad0(positions), pad0(velocities), pad0(masses, 1.0)[:, None],
                       pad0(params.half_sigma)[:, None], pad0(params.twice_sqrt_eps)[:, None],
                       atom_id[:, None].view(torch.float32), valid[:, None].to(torch.float32)], dim=1)
    fields, overflow = _sort_to_slots(table, config, torch.zeros((), dtype=torch.bool, device=dev))
    return ShardedState(step=torch.zeros((), dtype=torch.int32, device=dev), overflow=overflow,
                        **_own_rows(fields, config, mesh))


# ---------------------------------------------------------------------------
# Per-slab force pass with halo exchange.
# ---------------------------------------------------------------------------


def _halo_pack(pos, hs, tse, sel, halo_cap):
    """Compact each slab's selected atoms' (pos, params) into fixed halo
    buffers, in slot order: (L, S, …) → (L, H, …) buffers, zero past the
    count, and (L,) flags of a slab that selected more than H.  Slot h
    gathers the (h+1)-th selected atom (a binary search on the running
    count), so each buffer slot has one source."""
    lead = sel.shape[0]
    count = torch.cumsum(sel.to(torch.int64), dim=1)
    want = torch.arange(1, halo_cap + 1, device=sel.device).expand(lead, halo_cap).contiguous()
    src = torch.clamp(torch.searchsorted(count, want), max=sel.shape[1] - 1)
    buf_valid = want <= count[:, -1:]

    def take(x):
        if x.dim() == 2:
            return torch.where(buf_valid, torch.gather(x, 1, src), 0.0)
        got = torch.gather(x, 1, src[..., None].expand(lead, halo_cap, x.shape[2]))
        return torch.where(buf_valid[..., None], got, 0.0)

    return take(pos), take(hs), take(tse), buf_valid, count[:, -1] > halo_cap


def _shard_forces(pos, hs, tse, valid, model: LennardJonesModel, config: DomainConfig, mesh: GridMesh, *,
                  compute_energy: bool, row_chunk: int = 2048):
    """Forces (and, with `compute_energy`, half-split energies and virials)
    of this process's owned atoms: (L·S, …) blocks in, (forces, e, w,
    halo flags of the L slabs) out.

    Each slab sends the atoms within a halo width of its low face to its
    left neighbour and those of its high face to its right one, measured
    from the slab's centre (so an atom that left its slab goes out through
    the face it is near, even at D = 2); it gets its right neighbour's
    low-face atoms as right ghosts and its left neighbour's high-face atoms
    as left ghosts (at D = 2 both from the one other slab; at D = 1 no
    halo).  Owned rows are then evaluated against
    owned + ghost columns in chunks of `row_chunk` rows; a row meets itself
    only in the owned block, which the slab ≥ 2 × halo width rule of
    `suggest_domain_config` guarantees."""
    lead, s_cap = mesh.local_shape[0], config.slot_capacity
    pos, hs, tse, valid = (x.reshape((lead, s_cap) + tuple(x.shape[1:])) for x in (pos, hs, tse, valid))
    box = _box(config.box, pos)

    if config.num_devices > 1:
        # Each atom's offset from its slab's centre, periodically: within
        # a halo width of the low face below −w/2 + halo_w, of the high
        # face above w/2 − halo_w.  (The reference measures the offsets
        # from each face, periodically; at D = 2 the offset from the far
        # face of an atom that left its slab wraps by a box, and the atom
        # goes out as a ghost through both faces — ROADMAP fault R11.)
        width = _box(config.slab_width, pos)
        centre = (mesh.axis_index(0).to(pos.dtype)[:, None] + 0.5) * width
        offset = displacement(pos[..., 2], centre, box)
        reach = _f32(config.halo_width) - 0.5 * width
        pk_l = _halo_pack(pos, hs, tse, valid & (offset < reach), config.halo_capacity)
        pk_r = _halo_pack(pos, hs, tse, valid & (offset > -reach), config.halo_capacity)

        def exchange(pk, d):
            # One (L, H, 6) buffer a face: positions, half σ, 2√ε, valid.
            buf = torch.cat([pk[0], pk[1][..., None], pk[2][..., None], pk[3][..., None].to(pos.dtype)], dim=-1)
            got = mesh.shift(buf.reshape((1, lead, 1, 1) + tuple(buf.shape[1:])), 0, d)
            got = got.reshape(buf.shape)
            return got[..., :3], got[..., 3], got[..., 4], got[..., 5] > 0.5

        # Our low-edge atoms go to the left neighbour: the right neighbour's
        # low-edge atoms are our right ghosts, and vice versa.
        ghost_r = exchange(pk_l, +1)
        ghost_l = exchange(pk_r, -1)
        halo_over = pk_l[4] | pk_r[4]
        col_pos, col_hs, col_tse, col_valid = (torch.cat([own, gl, gr], dim=1) for own, gl, gr in
                                               zip((pos, hs, tse, valid), ghost_l, ghost_r))
    else:
        col_pos, col_hs, col_tse, col_valid = pos, hs, tse, valid
        halo_over = torch.zeros(lead, dtype=torch.bool, device=pos.device)

    col_id = torch.arange(col_pos.shape[1], device=pos.device)
    forces, energies, virials = [], [], []
    for start in range(0, s_cap, row_chunk):
        rows = slice(start, min(start + row_chunk, s_cap))
        dv = displacement(pos[:, rows, None, :], col_pos[:, None, :, :], box)
        r2 = dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1] + dv[..., 2] * dv[..., 2]
        same = torch.arange(rows.start, rows.stop, device=pos.device)[:, None] == col_id[None, :]
        ok = valid[:, rows, None] & col_valid[:, None, :] & ~same
        r2s = torch.where(ok, r2, 1.0)
        e, mre = pair_interaction(r2s, model, hs[:, rows, None], tse[:, rows, None],
                                  col_hs[:, None, :], col_tse[:, None, :])
        e = torch.where(ok, e, 0.0)
        mre = torch.where(ok, mre, 0.0)
        g = mre / r2s
        forces.append(torch.stack([torch.sum(g * dv[..., k], dim=-1) for k in range(3)], dim=-1))
        if compute_energy:
            energies.append(0.5 * torch.sum(e, dim=-1))
            virials.append(0.5 * torch.sum(mre, dim=-1))
    flat = lambda parts: torch.cat(parts, dim=1).reshape((lead * s_cap,) + tuple(parts[0].shape[2:]))  # noqa: E731
    if compute_energy:
        return flat(forces), flat(energies), flat(virials), halo_over
    return flat(forces), None, None, halo_over


# ---------------------------------------------------------------------------
# Sharded step + rollout.
# ---------------------------------------------------------------------------


def make_sharded_step(config: DomainConfig, mesh: GridMesh, model: LennardJonesModel, dt: float):
    """Build (rollout_fn, energy_fn) for the slab-sharded system.

    rollout_fn(state, num_blocks) advances resort_every·num_blocks steps:
    each block redistributes ownership once, then runs `resort_every`
    velocity-Verlet steps with a halo exchange a step; the block ends with
    the staleness guard.  energy_fn(state) → (pe, virial) summed over the
    mesh.  Nothing waits for the device; the flags (halo and slot overflow,
    staleness) are reduced over the mesh (`pmax`) and stay sticky."""
    _check_mesh(config, mesh)
    dt_f = _f32(dt)
    half_dt = _f32(np.float32(0.5) * np.float32(dt))
    halo_skin = _f32(config.halo_skin)

    def forces_of(state):
        f, _, _, over = _shard_forces(state.positions, state.half_sigma, state.twice_sqrt_eps, state.valid,
                                      model, config, mesh, compute_energy=False)
        return f, mesh.pmax(torch.any(over))

    def energy_fn(state: ShardedState):
        _, e, v, _ = _shard_forces(state.positions, state.half_sigma, state.twice_sqrt_eps, state.valid,
                                   model, config, mesh, compute_energy=True)
        lead = mesh.local_shape[0]
        return mesh.psum(e.reshape(lead, -1).sum(1).sum()), mesh.psum(v.reshape(lead, -1).sum(1).sum())

    def one_step(state: ShardedState, forces):
        box = _box(config.box, state.positions)
        inv_m = torch.where(state.valid, 1.0 / state.masses, 0.0)[:, None]
        v_half = state.velocities + half_dt * forces * inv_m
        new_pos = wrap(state.positions + dt_f * v_half, box)
        state = state._replace(positions=new_pos)
        new_forces, over = forces_of(state)
        new_vel = v_half + half_dt * new_forces * inv_m
        return state._replace(velocities=new_vel, step=state.step + 1, overflow=state.overflow | over), new_forces

    def rollout(state: ShardedState, num_blocks: int) -> ShardedState:
        for _ in range(num_blocks):
            state = redistribute(state, config, mesh)
            ref_z = state.positions[:, 2]
            forces, over = forces_of(state)
            state = state._replace(overflow=state.overflow | over)
            for _ in range(config.resort_every):
                state, forces = one_step(state, forces)
            # Staleness guard: ownership is refreshed only at block starts,
            # and the halo covers an atom at most `halo_skin` past its slab
            # face.  An atom that drifted further may have lost pairs
            # (asymmetrically): trip the sticky flag.
            dz = displacement(state.positions[:, 2], ref_z, _box(config.box, ref_z))
            stale = torch.max(torch.where(state.valid, torch.abs(dz), 0.0)) > halo_skin
            state = state._replace(overflow=state.overflow | mesh.pmax(stale))
        return state

    return rollout, energy_fn


def gather_sharded(state: ShardedState, mesh: GridMesh) -> ShardedState:
    """The whole (D·S, …) state on the mesh's device: on a `DistMesh`
    every rank takes part (an all-gather) and gets every slab."""
    return state._replace(**{k: mesh.all_gather(getattr(state, k))
                             for k in ("positions", "velocities", "masses", "half_sigma", "twice_sqrt_eps",
                                       "atom_id", "valid")})


def gather_dense(state: ShardedState, num_atoms: int):
    """Undo the slot layout: dense (N, 3) positions and velocities ordered
    by original atom id (numpy, host).  On a `DistMesh`, pass the state
    through `gather_sharded` first."""
    keep = state.valid.cpu().numpy()
    order = state.atom_id.cpu().numpy()[keep]
    pos = np.zeros((num_atoms, 3), np.float32)
    vel = np.zeros((num_atoms, 3), np.float32)
    pos[order] = state.positions.cpu().numpy()[keep]
    vel[order] = state.velocities.cpu().numpy()[keep]
    return pos, vel
