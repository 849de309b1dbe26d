"""C-tight straggler engine: slot capacity near the occupancy mean, with the
occupancy tail parked in a small auxiliary buffer — counterpart of
emdee_tpu/neighbors/cell_dense_straggler.py (uniform-LJ NVE).

- The slot grid stores C_t atoms per cell (pair work ∝ C_t²).
- Atoms beyond C_t at a rebin park in a fixed (A,) buffer ("stragglers"),
  each with its parked cell and its pad-slot rank; a sticky flag records A
  overflow.
- Grid↔grid pairs go through the force kernel on the C_t grid.  Straggler
  pairs go through the straggler pass (K3), one of two:
  - `strag_pass="kernel"`: each pencil row (z, y) lists, in an int32
    (M², Kn) table, the aux atoms parked in its wrapped 9-hood (z±1, y±1);
    every center atom of the row pairs with that list, and every aux atom
    pairs with its parked cell's 27 neighbor cells and with the other aux
    atoms (`straggler_kernel.straggler_forces`: CUDA on the card, its plain
    version elsewhere);
  - `strag_pass="xla"`: the reference's 27-row gather pass in plain torch
    ops, with the Newton reactions folded onto the grid by the fixed-order
    add of `core/scatter.py` (no float atomics).
- The rebin widens the grid to C_w (the aux atoms go back into their
  parked cells' pad slots), runs the ±1-cell routing at C_w (K4), splits at
  C_t and re-parks the tail in ascending flat order.
- Energies and virials go through the wide state: `energy` rebuilds the C_w
  grid and runs the per-atom force kernel with energies (K2b).

The TPU engine's bf16 one-hot list products (`_hood_matrix`, `_split3`,
`_build_strag_rows`, `_fold_strag_react`) exist because the MXU gathers by
matrix products; here the list table is built with a cumsum and a scatter,
in the reference's order, with its Kn-overflow flag.  Nothing in the
rollout waits for the device: flags stay on it, the re-park is a stable
sort of fixed size.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from emdee_tpu_torch.core.types import LJParams
from emdee_tpu_torch.neighbors.cell_dense import (
    CellDenseConfig,
    CellDenseState,
    _box,
    _comp_add,
    _f32,
    _numpy,
    _rebin_shift_core,
    _stale,
    _tensor,
    cell_dense_init,
    state_from_numpy,
    state_to_numpy,
    suggest_cell_dense_config,
)
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel, pair_interaction


class StragglerConfig(NamedTuple):
    """Static geometry of the straggler engine."""

    grid: CellDenseConfig  # capacity = C_t (the kernel capacity)
    wide_capacity: int  # C_w: rebin routing capacity (> C_t)
    aux_capacity: int  # A: straggler buffer slots
    kn: int  # per-pencil-row 9-hood straggler list width

    @property
    def wide(self) -> CellDenseConfig:
        return self.grid._replace(capacity=self.wide_capacity)

    @property
    def sentinel(self) -> int:
        # ONE atom-id sentinel for both capacities (the wide one bounds it).
        return self.wide.num_slots


def suggest_straggler_config(
    num_atoms: int,
    box: float,
    cutoff: float,
    switch: float,
    skin: float = 0.35,
    tight_capacity: Optional[int] = None,
    wide_capacity: Optional[int] = None,
    aux_capacity: int = 128,
    kn: int = 16,
) -> StragglerConfig:
    """Tight-capacity config: C_t defaults to 4 below the mean+2.5σ
    capacity, C_w to C_t + 10 rounded up to a multiple of 8."""
    base = suggest_cell_dense_config(num_atoms, box, cutoff, switch, skin)
    if tight_capacity is None:
        tight_capacity = base.capacity - 4
    if wide_capacity is None:
        wide_capacity = -(-(tight_capacity + 10) // 8) * 8
    return StragglerConfig(
        grid=base._replace(capacity=tight_capacity),
        wide_capacity=wide_capacity,
        aux_capacity=aux_capacity,
        kn=kn,
    )


class StragglerState(NamedTuple):
    grid: CellDenseState  # slot grid at C_t (atom-id sentinel = config.sentinel)
    aux_positions: torch.Tensor  # (A, 3) float32
    aux_velocities: torch.Tensor  # (A, 3) float32
    aux_atom_id: torch.Tensor  # (A,) int32, sentinel for empty
    aux_cell: torch.Tensor  # (A,) int32 parked cell, M³ for empty
    aux_rank: torch.Tensor  # (A,) int32 pad-slot rank within the parked cell


_AUX_DTYPES = {
    "aux_positions": np.float32,
    "aux_velocities": np.float32,
    "aux_atom_id": np.int32,
    "aux_cell": np.int32,
    "aux_rank": np.int32,
}


def straggler_state_from_numpy(fields: dict, device) -> StragglerState:
    """Port state from the fields of a JAX `StragglerState` taken to the
    host (`jax.device_get(state)._asdict()`), bit for bit."""
    grid = fields["grid"]
    grid = grid._asdict() if hasattr(grid, "_asdict") else grid
    return StragglerState(
        grid=state_from_numpy(grid, device),
        **{name: _tensor(fields[name], dt, device) for name, dt in _AUX_DTYPES.items()},
    )


def straggler_state_to_numpy(state: StragglerState) -> dict:
    """Inverse of `straggler_state_from_numpy`: numpy arrays under the JAX
    `StragglerState` field names, the grid as a `CellDenseState` field dict."""
    out = {name: _numpy(getattr(state, name)) for name in _AUX_DTYPES}
    return {"grid": state_to_numpy(state.grid), **out}


def straggler_init(
    positions, velocities, masses, params: LJParams, config: StragglerConfig, device=None
) -> StragglerState:
    """Host entry: bin at the WIDE capacity on `device` (default: the CUDA
    card), then split grid and tail; the tail packs into the aux buffer in
    ascending (cell, rank) order.  The sticky flag rises when the wide bin
    overflows or the tail exceeds A."""
    st_w = cell_dense_init(positions, velocities, masses, params, config.wide, device=device)
    c_t, a_cap = config.grid.capacity, config.aux_capacity
    nc = config.grid.num_cells
    dev = st_w.positions.device
    cells, ranks = torch.nonzero(st_w.valid[:, c_t:], as_tuple=True)
    count = cells.numel()
    k = min(count, a_cap)
    cells, ranks = cells[:k], ranks[:k]

    def pack(a, fill):
        out = torch.full((a_cap,) + tuple(a.shape[2:]), fill, dtype=a.dtype, device=dev)
        out[:k] = a[cells, c_t + ranks]
        return out

    cut = lambda a: a[:, :c_t].contiguous()  # noqa: E731
    grid = CellDenseState(
        positions=cut(st_w.positions),
        velocities=cut(st_w.velocities),
        inv_masses=cut(st_w.inv_masses),
        half_sigma=cut(st_w.half_sigma),
        twice_sqrt_eps=cut(st_w.twice_sqrt_eps),
        atom_id=cut(st_w.atom_id),
        valid=cut(st_w.valid),
        ref_positions=cut(st_w.ref_positions),
        step=st_w.step,
        overflow=st_w.overflow | (count > a_cap),
    )
    acell = torch.full((a_cap,), nc, dtype=torch.int32, device=dev)
    arank = torch.zeros((a_cap,), dtype=torch.int32, device=dev)
    acell[:k] = cells.to(torch.int32)
    arank[:k] = ranks.to(torch.int32)
    return StragglerState(
        grid=grid,
        aux_positions=pack(st_w.positions, 0.0),
        aux_velocities=pack(st_w.velocities, 0.0),
        aux_atom_id=pack(st_w.atom_id, config.sentinel),
        aux_cell=acell,
        aux_rank=arank,
    )


# ---------------------------------------------------------------------------
# Bindings: which aux atoms each pencil row and each aux atom sees
# ---------------------------------------------------------------------------


def _hood_matrix(m: int, device) -> torch.Tensor:
    """(M², M²) bool: H[r, r'] iff pencil row r' lies in r's wrapped 9-hood
    (rows r = z·M + y; M ≥ 3, so the nine rows are distinct)."""
    rows = torch.arange(m * m, device=device)
    rz, ry = rows // m, rows % m
    near = lambda d: (d == 0) | (d == 1) | (d == m - 1)  # noqa: E731
    return near((rz[None, :] - rz[:, None]) % m) & near((ry[None, :] - ry[:, None]) % m)


def _bindings(acell, avalid, config: StragglerConfig, hood):
    """The K3 list table and the Kn-overflow flag.

    table[r, k] is the k-th aux atom (ascending aux index) parked in pencil
    row r's 9-hood, −1 past the row's count; atoms beyond Kn are dropped and
    raise the flag — the reference's one-hot O with argmax over A."""
    m, kn = config.grid.cells_per_dim, config.kn
    a_cap = acell.shape[0]
    arow = torch.where(avalid, acell // m, 0).long()
    hit = hood[:, arow] & avalid[None, :]  # (M², A)
    hit_i = hit.to(torch.int32)
    rank = torch.cumsum(hit_i, dim=1) - hit_i
    kn_overflow = torch.max(torch.sum(hit_i, dim=1)) > kn
    dest = torch.where(hit & (rank < kn), rank, kn).long()  # column kn is a dump
    table = torch.full((m * m, kn + 1), -1, dtype=torch.int32, device=acell.device)
    ids = torch.arange(a_cap, dtype=torch.int32, device=acell.device).expand(m * m, a_cap)
    table.scatter_(1, dest, ids)
    return table[:, :kn].contiguous(), kn_overflow


def _nbr27_table(acell, avalid, m: int, nc: int):
    """(A, 27) wrapped neighbor-cell ids of each straggler's parked cell
    (invalid aux → the nc sentinel row, masked downstream)."""
    acell = acell.long()
    z = acell // (m * m)
    y = (acell // m) % m
    x = acell % m
    cols = [
        ((x + dx) % m) + m * (((y + dy) % m) + m * ((z + dz) % m))
        for dz in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
    ]
    tab = torch.stack(cols, dim=1)
    return torch.where(avalid[:, None], tab, nc)


def _gather_rows(acell, valid, avalid, m: int):
    """The 27-row gather's (A·27,) cell rows and (A, 27·C_t) float pair mask."""
    nc, c_t = valid.shape
    idx = torch.clamp(_nbr27_table(acell, avalid, m, nc).reshape(-1), max=nc - 1)
    a_cap = acell.shape[0]
    mask = valid.to(torch.float32)[idx].reshape(a_cap, 27 * c_t) * avalid.to(torch.float32)[:, None]
    return idx, mask


def _uniform(uniform_params, like: torch.Tensor):
    """The uniform (σ/2, 2√ε) as 0-d float32 tensors on `like`'s device."""
    return tuple(torch.full((), v, dtype=torch.float32, device=like.device) for v in uniform_params)


def _min_image(d, box_t):
    return d - torch.round(d / box_t) * box_t


def _gather_pair_forces(px, py, pz, ax, ay, az, idx, mask, model, box_t, uniform_params):
    """Per-pair forces on each aux atom from its parked cell's 27 neighbor
    rows: (A, 27·C_t) components, zero where `mask` is 0."""
    a27c = mask.shape
    mi = lambda d: _min_image(d, box_t)  # noqa: E731
    dvx = mi(ax[:, None] - px[idx].reshape(a27c))
    dvy = mi(ay[:, None] - py[idx].reshape(a27c))
    dvz = mi(az[:, None] - pz[idx].reshape(a27c))
    r2 = dvx * dvx + dvy * dvy + dvz * dvz + (1.0 - mask) * 1.0e8
    hs, tse = _uniform(uniform_params, px)
    _, mre = pair_interaction(r2, model, hs, tse, hs, tse)
    gfac = mask * mre / r2
    return gfac * dvx, gfac * dvy, gfac * dvz


def _aux_pair_forces(ax, ay, az, avalid, model, box_t, uniform_params):
    """Straggler↔straggler LJ forces: a small all-pairs pass (A ≲ 256)."""
    mi = lambda d: _min_image(d, box_t)  # noqa: E731
    dvx = mi(ax[:, None] - ax[None, :])
    dvy = mi(ay[:, None] - ay[None, :])
    dvz = mi(az[:, None] - az[None, :])
    r2 = dvx * dvx + dvy * dvy + dvz * dvz
    eye = torch.eye(ax.shape[0], dtype=torch.bool, device=ax.device)
    ok = avalid[:, None] & avalid[None, :] & ~eye
    r2s = torch.where(ok, r2, 1.0)
    hs, tse = _uniform(uniform_params, ax)
    _, mre = pair_interaction(r2s, model, hs, tse, hs, tse)
    g = torch.where(ok, mre / r2s, 0.0)
    return torch.sum(g * dvx, dim=1), torch.sum(g * dvy, dim=1), torch.sum(g * dvz, dim=1)


def _widen_fields(gfields, aux_fields, acell, arank, avalid, config: StragglerConfig):
    """Pad the C_t grid to C_w and insert the aux atoms into their parked
    cells' pad slots: one scatter into a flat buffer whose extra last slot
    takes the empty aux lanes (the rank was recorded at park time, so live
    destinations never collide)."""
    c_t, c_w = config.grid.capacity, config.wide_capacity
    nc = config.grid.num_cells
    dest = torch.where(avalid, acell * c_w + c_t + arank, nc * c_w).long()
    out = []
    for fg, fa in zip(gfields, aux_fields):
        fill = config.sentinel if fg.dtype == torch.int32 else 0.0
        flat = torch.full((nc * c_w + 1,), fill, dtype=fg.dtype, device=fg.device)
        wide = flat[: nc * c_w].view(nc, c_w)
        wide[:, :c_t] = fg
        flat[dest] = fa
        out.append(wide)
    return out


# ---------------------------------------------------------------------------
# The simulation
# ---------------------------------------------------------------------------


# The engine's backend names → the kernel wrappers' backend; the names after
# 'torch' take the streaming family.
_BACKENDS = {"auto": "auto", "cuda": "cuda", "torch": "torch", "cuda_streaming": "cuda",
             "pallas_streaming": "cuda", "streaming": "auto", "torch_streaming": "torch",
             "pallas_streaming_interpret": "torch"}


def make_straggler_sim(
    config: StragglerConfig,
    model: LennardJonesModel,
    dt: float,
    uniform_params,
    uniform_mass: float = 1.0,
    backend: str = "auto",
    strag_pass: str = "auto",
):
    """Build (rollout, energy) for uniform-LJ NVE on the straggler engine.

    rollout(state, num_steps, rebin_every) → StragglerState: leapfrog NVE
    on the grid and the aux buffer, rebinning through the wide-capacity
    routing every `rebin_every` steps.  energy(state) → (pe, vir, ke) as
    0-d tensors, through the wide state.  `rollout.wide_state(state)` is the
    C_w slot state; `rollout.forces(state)` the grid (3, M³, C_t) and aux
    (3, A) forces of a state with its own bindings, plus the Kn flag.

    backend: the resident family — 'auto' (CUDA kernels for CUDA tensors,
    plain versions for CPU tensors), 'cuda' or 'torch' — or the streaming
    family, whose grid pass is the streaming kernel's split entry
    (`streaming_kernel.cell_forces_streaming_split`, K5), as the
    reference's `pallas_streaming`: 'cuda_streaming' (or the reference's
    name 'pallas_streaming'), 'torch_streaming' (or
    'pallas_streaming_interpret': the plain version on the CPU), or
    'streaming' (K5 for CUDA tensors, the plain version for CPU tensors).
    'auto' keeps the resident family, as the reference's does.  strag_pass:
    'kernel' (K3; the default of the resident family) or 'xla' (the 27-row
    gather in torch ops, its reactions folded onto the grid by the
    fixed-order add of `core/scatter.py`; the streaming family's only pass,
    as in the reference, which raises ValueError for 'kernel' there).  Both
    passes are bitwise reproducible on the card."""
    from emdee_tpu_torch.core.scatter import add_plan, fixed_add
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces, cell_forces_split
    from emdee_tpu_torch.neighbors.straggler_kernel import straggler_forces
    from emdee_tpu_torch.neighbors.streaming_kernel import cell_forces_streaming_split

    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: use one of {', '.join(_BACKENDS)}")
    streaming = backend not in ("auto", "cuda", "torch")
    backend = _BACKENDS[backend]  # the kernel wrappers' backend
    if strag_pass == "auto":
        strag_pass = "xla" if streaming else "kernel"
    if strag_pass not in ("kernel", "xla"):
        raise ValueError(f"strag_pass must be 'kernel' or 'xla', got {strag_pass!r}")
    if streaming and strag_pass == "kernel":
        raise ValueError("strag_pass='kernel' requires the resident kernel: the streaming family takes 'xla'")
    if config.grid.spill:
        raise ValueError("straggler engine replaces spill mode — use spill=False")

    cfg_t, cfg_w = config.grid, config.wide
    m, c_t, c_w = cfg_t.cells_per_dim, cfg_t.capacity, config.wide_capacity
    nc = cfg_t.num_cells
    sent = config.sentinel
    a_cap = config.aux_capacity
    inv_m = np.float32(1.0 / uniform_mass)
    dt_f = _f32(dt)
    kick_dt = _f32(np.float32(dt) * inv_m)
    half_dt = _f32(np.float32(0.5) * np.float32(dt) * inv_m)
    hoods = {}

    def bindings(acell, avalid, valid):
        """Per-rebin bindings of the selected pass, and the Kn flag.  `valid`
        is the block's grid mask, fixed between rebins."""
        if strag_pass == "kernel":
            dev = acell.device
            if dev not in hoods:
                hoods[dev] = _hood_matrix(m, dev)
            return _bindings(acell, avalid, config, hoods[dev])
        idx, mask = _gather_rows(acell, valid, avalid, m)
        return (idx, mask, add_plan(idx, nc)), torch.zeros((), dtype=torch.bool, device=acell.device)

    def forces(p, valid, a, acell, bind):
        """Grid forces (3, M³, C_t) and aux forces (3, A)."""
        if strag_pass == "kernel":
            return straggler_forces(
                p[0], p[1], p[2], valid, a[0], a[1], a[2], acell, bind, config,
                uniform_params, backend=backend,
            )
        box_t = _box(cfg_t.box, p)
        split = cell_forces_streaming_split if streaming else cell_forces_split
        fx, fy, fz = split(p[0], p[1], p[2], valid, cfg_t, uniform_params=uniform_params, backend=backend)
        idx, mask, plan = bind
        gx, gy, gz = _gather_pair_forces(
            p[0], p[1], p[2], a[0], a[1], a[2], idx, mask, model, box_t, uniform_params
        )
        rows = torch.stack([-g.reshape(a_cap * 27, c_t) for g in (gx, gy, gz)], dim=1)
        fg = fixed_add(torch.stack([fx, fy, fz], dim=1), plan, rows).transpose(0, 1)
        ss = _aux_pair_forces(a[0], a[1], a[2], acell < nc, model, box_t, uniform_params)
        fa = torch.stack([
            torch.sum(gx, dim=1) + ss[0],
            torch.sum(gy, dim=1) + ss[1],
            torch.sum(gz, dim=1) + ss[2],
        ])
        return fg, fa

    def rebin(p, v, aid, a, av, aaid, acell, arank, ovf):
        avalid = acell < nc
        wf = _widen_fields(
            [p[0], p[1], p[2], v[0], v[1], v[2], aid],
            [a[0], a[1], a[2], av[0], av[1], av[2], aaid],
            acell, arank, avalid, config,
        )
        wf, valid_w, ovf = _rebin_shift_core(wf, wf[6] < sent, ovf, cfg_w, backend)
        head = valid_w[:, :c_t]
        p = torch.stack([torch.where(head, f[:, :c_t], 0.0) for f in wf[0:3]])
        v = torch.stack([torch.where(head, f[:, :c_t], 0.0) for f in wf[3:6]])
        aid = torch.where(head, wf[6][:, :c_t], sent)
        # Re-park the tail: the ≤ A occupied pad slots in ascending flat
        # order (a stable sort of fixed size — no host sync), (cell, rank)
        # recorded for the next insert, sticky flag on A overflow.
        p_w = c_w - c_t
        tv = valid_w[:, c_t:].reshape(-1)
        order = torch.argsort((~tv).to(torch.int32), stable=True)[:a_cap]
        taken = tv[order]
        tail = lambda f: f[:, c_t:].reshape(-1)[order]  # noqa: E731
        a = torch.stack([torch.where(taken, tail(f), 0.0) for f in wf[0:3]])
        av = torch.stack([torch.where(taken, tail(f), 0.0) for f in wf[3:6]])
        aaid = torch.where(taken, tail(wf[6]), sent)
        acell = torch.where(taken, order // p_w, nc).to(torch.int32)
        arank = torch.where(taken, order % p_w, 0).to(torch.int32)
        ovf = ovf | (torch.sum(tv.to(torch.int32)) > a_cap)
        return p, v, aid, a, av, aaid, acell, arank, ovf

    def rollout(state: StragglerState, num_steps: int, rebin_every: int = 6) -> StragglerState:
        """Blocked NVE: each block rebins, then runs `rebin_every` Kahan-
        compensated leapfrog steps on grid and aux, then checks staleness.
        Flags stay on the device; nothing here waits for it."""
        gr = state.grid
        p = gr.positions.permute(2, 0, 1).contiguous()  # (3, M³, C_t)
        v = gr.velocities.permute(2, 0, 1).contiguous()
        aid = torch.where(gr.valid, gr.atom_id, sent)
        a = state.aux_positions.t().contiguous()  # (3, A)
        av = state.aux_velocities.t().contiguous()
        aaid, acell, arank = state.aux_atom_id, state.aux_cell, state.aux_rank
        ovf = gr.overflow

        # Initial half-kick with the current binding.
        bind, knovf = bindings(acell, acell < nc, aid < sent)
        ovf = ovf | knovf
        fg, fa = forces(p, aid < sent, a, acell, bind)
        v = v + half_dt * fg
        av = av + half_dt * fa

        blocks, rem = divmod(num_steps, rebin_every)
        for length in [rebin_every] * blocks + ([rem] if rem else []):
            p, v, aid, a, av, aaid, acell, arank, ovf = rebin(
                p, v, aid, a, av, aaid, acell, arank, ovf
            )
            valid = aid < sent
            avalid = acell < nc
            bind, knovf = bindings(acell, avalid, valid)
            ovf = ovf | knovf
            p_ref, a_ref = p, a
            cp, cv = torch.zeros_like(p), torch.zeros_like(v)
            ca, cav = torch.zeros_like(a), torch.zeros_like(av)
            for _ in range(length):
                # Kahan-compensated drift and kick, as the dense engine's.
                p, cp = _comp_add(p, dt_f * v, cp)
                a, ca = _comp_add(a, dt_f * av, ca)
                fg, fa = forces(p, valid, a, acell, bind)
                v, cv = _comp_add(v, kick_dt * fg, cv)
                av, cav = _comp_add(av, kick_dt * fa, cav)
            dp, da = p - p_ref, a - a_ref
            ovf = ovf | _stale(dp[0], dp[1], dp[2], valid, cfg_t)
            ovf = ovf | _stale(da[0], da[1], da[2], avalid, cfg_t)

        # Closing half un-kick re-syncs velocities to integer steps.
        bind, knovf = bindings(acell, acell < nc, aid < sent)
        ovf = ovf | knovf
        fg, fa = forces(p, aid < sent, a, acell, bind)
        v = v - half_dt * fg
        av = av - half_dt * fa

        valid_f = aid < sent
        cval = lambda x: torch.where(valid_f, _f32(x), 0.0)  # noqa: E731
        pos = p.permute(1, 2, 0).contiguous()
        grid = CellDenseState(
            positions=pos,
            velocities=v.permute(1, 2, 0).contiguous(),
            inv_masses=cval(1.0 / uniform_mass),
            half_sigma=cval(uniform_params[0]),
            twice_sqrt_eps=cval(uniform_params[1]),
            atom_id=aid,
            valid=valid_f,
            ref_positions=pos,
            step=gr.step + num_steps,
            overflow=ovf,
        )
        return StragglerState(
            grid=grid,
            aux_positions=a.t().contiguous(),
            aux_velocities=av.t().contiguous(),
            aux_atom_id=aaid,
            aux_cell=acell,
            aux_rank=arank,
        )

    def wide_state(state: StragglerState) -> CellDenseState:
        """The C_w slot state (grid + inserted aux): the bridge to every
        wide-capacity facility (energy, gather, tests)."""
        gr = state.grid
        wf = _widen_fields(
            [gr.positions[..., i] for i in range(3)]
            + [gr.velocities[..., i] for i in range(3)]
            + [torch.where(gr.valid, gr.atom_id, sent)],
            [state.aux_positions[:, i] for i in range(3)]
            + [state.aux_velocities[:, i] for i in range(3)]
            + [state.aux_atom_id],
            state.aux_cell, state.aux_rank, state.aux_cell < nc, config,
        )
        valid_w = wf[6] < sent
        cval = lambda x: torch.where(valid_w, _f32(x), 0.0)  # noqa: E731
        pos = torch.stack(wf[0:3], dim=-1)
        return CellDenseState(
            positions=pos,
            velocities=torch.stack(wf[3:6], dim=-1),
            inv_masses=cval(1.0 / uniform_mass),
            half_sigma=cval(uniform_params[0]),
            twice_sqrt_eps=cval(uniform_params[1]),
            atom_id=wf[6],
            valid=valid_w,
            ref_positions=pos,
            step=gr.step,
            overflow=gr.overflow,
        )

    def state_forces(state: StragglerState):
        """(grid forces (3, M³, C_t), aux forces (3, A), Kn flag) of a state
        with its own bindings — the pass the rollout's kicks use."""
        gr = state.grid
        acell = state.aux_cell
        valid = gr.valid
        bind, knovf = bindings(acell, acell < nc, valid)
        p = gr.positions.permute(2, 0, 1).contiguous()
        a = state.aux_positions.t().contiguous()
        fg, fa = forces(p, valid, a, acell, bind)
        return fg, fa, knovf

    def energy(state: StragglerState):
        """(potential energy, virial, kinetic energy) as 0-d tensors: the
        per-atom force kernel with energies (K2b) on the wide state."""
        st = wide_state(state)
        _, e, w = cell_forces(st, model, cfg_w, compute_energy=True, backend=backend)
        pe = torch.sum(torch.where(st.valid, e, 0.0))
        vir = torch.sum(torch.where(st.valid, w, 0.0))
        ke = _f32(np.float32(0.5) * np.float32(uniform_mass)) * torch.sum(
            torch.where(st.valid[..., None], st.velocities**2, 0.0)
        )
        return pe, vir, ke

    rollout.wide_state = wide_state
    rollout.forces = state_forces
    return rollout, energy


def gather_straggler_atoms(state: StragglerState, config: StragglerConfig, num_atoms: int):
    """Slot + aux layout → (positions, velocities) numpy arrays in atom order."""
    pos = np.zeros((num_atoms, 3), np.float32)
    vel = np.zeros((num_atoms, 3), np.float32)
    ids = _numpy(state.grid.atom_id).reshape(-1)
    keep = _numpy(state.grid.valid).reshape(-1)
    pos[ids[keep]] = _numpy(state.grid.positions).reshape(-1, 3)[keep]
    vel[ids[keep]] = _numpy(state.grid.velocities).reshape(-1, 3)[keep]
    akeep = _numpy(state.aux_cell) < config.grid.num_cells
    aids = _numpy(state.aux_atom_id)[akeep]
    pos[aids] = _numpy(state.aux_positions)[akeep]
    vel[aids] = _numpy(state.aux_velocities)[akeep]
    return pos, vel
