"""Dense-cell force engine in slot layout — counterpart of
emdee_tpu/neighbors/cell_dense.py (main-path subset: NVE, LJ, shift rebin).

Atoms live in a dense slot grid (M³, C): cell side h = L/M ≥ cutoff + skin,
capacity C per cell.  Between rebins the state never reindexes atoms; every
`rebin_every` steps three ±1-cell routing passes move each atom to its new
cell (`_rebin_shift`), and a sticky `overflow` flag records capacity
overflow, illegal moves and skin/2 staleness.  Positions are wrapped into
[0, L) only at rebins; between rebins they may overhang the box by skin/2.

Backends (`resolve_backend`): "auto" launches the hand-written CUDA kernels
(`cell_kernel.py`, `rebin_kernel.py`) for CUDA tensors and runs their plain
PyTorch versions for CPU tensors; "torch" asks for the plain versions on any
device; "cuda" insists on the kernels.  The TPU engine's VMEM-size switch to
a streaming kernel has no counterpart: the CUDA kernel serves every N.

Scalar constants that the reference forms in float32 (dt·½, 1/m) are formed
in float32 here too, and every division by the box divides by a tensor on
the data's device: CUDA turns division by a host scalar into a reciprocal
multiply, which would move bin edges by an ulp.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from emdee_tpu_torch.core.pbc import wrap_scaled
from emdee_tpu_torch.core.types import LJParams
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel, pair_interaction


class CellDenseConfig(NamedTuple):
    """Static geometry of the dense-cell engine (same fields as the JAX
    package's, so a config carries across unchanged)."""

    cells_per_dim: int  # M
    capacity: int  # C, slots per cell (multiple of 8)
    box: float
    cutoff: float
    switch: float
    skin: float
    num_atoms: int
    spill: bool = False  # boundary-spill balancing: not ported (ROADMAP item 8)
    spill_target: int = 0

    @property
    def num_cells(self) -> int:
        return self.cells_per_dim**3

    @property
    def num_slots(self) -> int:
        return self.num_cells * self.capacity

    @property
    def cell_side(self) -> float:
        return self.box / self.cells_per_dim


class CellDenseState(NamedTuple):
    """Simulation state in slot layout: leading dims (M³, C)."""

    positions: torch.Tensor  # (M³, C, 3) float32
    velocities: torch.Tensor  # (M³, C, 3) float32
    inv_masses: torch.Tensor  # (M³, C) float32 — 0 for empty slots
    half_sigma: torch.Tensor  # (M³, C) float32
    twice_sqrt_eps: torch.Tensor  # (M³, C) float32
    atom_id: torch.Tensor  # (M³, C) int32, sentinel = num_slots for empty
    valid: torch.Tensor  # (M³, C) bool
    ref_positions: torch.Tensor  # (M³, C, 3) — positions at last rebin
    step: torch.Tensor  # () int32
    overflow: torch.Tensor  # () bool


_STATE_DTYPES = {
    "positions": np.float32,
    "velocities": np.float32,
    "inv_masses": np.float32,
    "half_sigma": np.float32,
    "twice_sqrt_eps": np.float32,
    "atom_id": np.int32,
    "valid": np.bool_,
    "ref_positions": np.float32,
    "step": np.int32,
    "overflow": np.bool_,
}


_TORCH_DTYPES = {np.float32: torch.float32, np.int32: torch.int32, np.bool_: torch.bool}


def _tensor(a, dtype, device) -> torch.Tensor:
    """Copy an array-like (numpy, list, tensor) into a tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=_TORCH_DTYPES[dtype])
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(device)


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def state_from_numpy(fields: dict, device) -> CellDenseState:
    """Port state from the fields of a JAX `CellDenseState` taken to the
    host (`jax.device_get(state)._asdict()`) — both sides then start from
    identical bits.  Charges and a dynamic box belong to later slices."""
    for name in ("charges", "box"):
        if fields.get(name) is not None:
            raise NotImplementedError(
                f"state field {name!r} is not ported yet (ROADMAP items 8 and 10)"
            )
    return CellDenseState(
        **{name: _tensor(fields[name], dt, device) for name, dt in _STATE_DTYPES.items()}
    )


def state_to_numpy(state: CellDenseState) -> dict:
    """Inverse of `state_from_numpy`: a dict of numpy arrays whose keys are
    the JAX `CellDenseState` fields (charges and box stay at their None
    defaults)."""
    return {name: _numpy(getattr(state, name)) for name in _STATE_DTYPES}


def lj_params_from_numpy(params, device) -> LJParams:
    """Port `LJParams` from any (half_sigma, twice_sqrt_eps) pair of arrays,
    e.g. a JAX `LJParams` taken to the host."""
    return LJParams(
        half_sigma=_tensor(params[0], np.float32, device),
        twice_sqrt_eps=_tensor(params[1], np.float32, device),
    )


def resolve_backend(backend: str, tensor: torch.Tensor) -> str:
    """'auto' → 'cuda' for CUDA tensors, 'torch' (the plain versions) for
    CPU tensors.  Replaces the TPU engine's `resolve_dense_backend`."""
    if backend == "torch":
        return "torch"
    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown backend {backend!r}: use 'auto', 'cuda' or 'torch'")
    if tensor.is_cuda:
        return "cuda"
    if backend == "cuda":
        raise ValueError("backend='cuda' needs tensors on a CUDA device")
    return "torch"


def _box(box: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(box, dtype=torch.float32, device=like.device)


def _f32(x) -> float:
    """A Python float holding exactly the float32 value of `x`."""
    return float(np.float32(x))


def suggest_cell_dense_config(
    num_atoms: int,
    box: float,
    cutoff: float,
    switch: float,
    skin: float = 0.4,
    spill: bool = False,
) -> CellDenseConfig:
    """Derive cells/dim and slot capacity from geometry: M = ⌊L/(rc+skin)⌋,
    C = mean occupancy + 2.5σ + 1, rounded up to a multiple of 8."""
    if spill:
        raise NotImplementedError("boundary-spill configs are not ported yet (ROADMAP item 8)")
    m = int(np.floor(box / (cutoff + skin)))
    if m < 3:
        raise ValueError(
            f"box {box} holds only {m} cells of side ≥ {cutoff + skin}; "
            "use the all-pairs method for boxes this small"
        )
    mean_occ = num_atoms / m**3
    cap = int(np.ceil(mean_occ + 2.5 * np.sqrt(mean_occ) + 1.0))
    cap = -(-cap // 8) * 8
    return CellDenseConfig(
        cells_per_dim=m, capacity=cap, box=box, cutoff=cutoff, switch=switch,
        skin=skin, num_atoms=num_atoms,
    )


def suggest_rebin_interval(
    skin: float, dt: float, temperature: float, mass: float = 1.0, vmax_sigmas: float = 6.0
) -> int:
    """Steps between rebins such that a `vmax_sigmas`-sigma atom stays within
    skin/2 of its bin-time position: K = (skin/2) / (vmax·dt)."""
    vmax = vmax_sigmas * np.sqrt(temperature / mass)
    return max(1, int(np.floor(0.5 * skin / (vmax * dt))))


def detect_uniform_params(params: LJParams):
    """If every atom shares one (σ/2, 2√ε), return that pair as floats for
    the kernels' uniform fast path, else None."""
    hs = _numpy(params.half_sigma)
    tse = _numpy(params.twice_sqrt_eps)
    if hs.size and np.all(hs == hs.flat[0]) and np.all(tse == tse.flat[0]):
        return (float(hs.flat[0]), float(tse.flat[0]))
    return None


# ---------------------------------------------------------------------------
# Binning: dense (N,)-arrays ↔ slot grid
# ---------------------------------------------------------------------------


def _bin_to_slots(positions, per_atom, config: CellDenseConfig):
    """Scatter per-atom arrays into the (M³, C) slot layout: one stable
    argsort, then one index-put whose dropped rows (beyond capacity) land in
    an extra dump slot.  Returns (slot arrays, overflow flag)."""
    m, c = config.cells_per_dim, config.capacity
    n = positions.shape[0]
    nc = m**3
    dev = positions.device
    s = wrap_scaled(positions / _box(config.box, positions))
    v = torch.clamp(torch.floor(m * s).to(torch.int64), 0, m - 1)
    cell = v[:, 0] + m * (v[:, 1] + m * v[:, 2])

    order = torch.argsort(cell, stable=True)
    cell_sorted = cell[order]
    counts = torch.bincount(cell, minlength=nc)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[cell_sorted]
    dest = torch.where(rank < c, cell_sorted * c + rank, nc * c)

    def scatter(arr, fill):
        flat = torch.full((nc * c + 1,) + arr.shape[1:], fill, dtype=arr.dtype, device=dev)
        flat[dest] = arr[order]
        return flat[: nc * c].reshape((nc, c) + arr.shape[1:])

    out = {name: scatter(arr, fill) for name, (arr, fill) in per_atom.items()}
    return out, counts.max() > c


def cell_dense_init(
    positions, velocities, masses, params: LJParams, config: CellDenseConfig, device=None
) -> CellDenseState:
    """Pack (N, …) arrays into slot layout on `device` (default: the CPU).

    Positions are binned from their raw values and stored wrapped into
    [0, L), as every rebin stores them.  Overflow is left to the caller via
    the flag (re-init with a larger capacity)."""
    if config.spill:
        raise NotImplementedError("boundary-spill configs are not ported yet (ROADMAP item 8)")
    device = torch.device("cpu") if device is None else torch.device(device)
    pos = _tensor(positions, np.float32, device)
    n = pos.shape[0]
    box = _box(config.box, pos)
    stored_pos = pos - torch.floor(pos / box) * box
    per_atom = {
        "positions": (stored_pos, 0.0),
        "velocities": (_tensor(velocities, np.float32, device), 0.0),
        "inv_masses": (1.0 / _tensor(masses, np.float32, device), 0.0),
        "half_sigma": (_tensor(params.half_sigma, np.float32, device), 0.0),
        "twice_sqrt_eps": (_tensor(params.twice_sqrt_eps, np.float32, device), 0.0),
        "atom_id": (torch.arange(n, dtype=torch.int32, device=device), config.num_slots),
        "valid": (torch.ones(n, dtype=torch.bool, device=device), False),
    }
    out, overflow = _bin_to_slots(pos, per_atom, config)
    valid = out["valid"]
    return CellDenseState(
        positions=out["positions"],
        velocities=out["velocities"],
        inv_masses=torch.where(valid, out["inv_masses"], 0.0),
        half_sigma=out["half_sigma"],
        twice_sqrt_eps=out["twice_sqrt_eps"],
        atom_id=out["atom_id"],
        valid=valid,
        ref_positions=out["positions"],
        step=torch.zeros((), dtype=torch.int32, device=device),
        overflow=overflow,
    )


# ---------------------------------------------------------------------------
# The plain force pass (the plain version of csrc/cell_forces.cu)
# ---------------------------------------------------------------------------


def _half_shell_offsets() -> np.ndarray:
    """13 half-shell offsets (vx, vy, vz) of the 27-stencil."""
    offs = [
        (vx, vy, vz)
        for vz in (-1, 0, 1)
        for vy in (-1, 0, 1)
        for vx in (-1, 0, 1)
        if (vz, vy, vx) > (0, 0, 0)
    ]
    return np.asarray(sorted(offs), np.int32)


_OFFSETS = _half_shell_offsets()
_GROUP = 4  # offsets per pair tile: (M³, C, 4·C)


def _roll_cells(grid: torch.Tensor, offset, m: int) -> torch.Tensor:
    """Roll the (M³, C, …) slot grid so that cell c's row holds cell
    (c+offset)'s content, periodically; offset is (ox, oy, oz) and cell
    id = x + M·(y + M·z)."""
    shaped = grid.reshape((m, m, m) + tuple(grid.shape[1:]))
    rolled = torch.roll(
        shaped, shifts=(-int(offset[2]), -int(offset[1]), -int(offset[0])), dims=(0, 1, 2)
    )
    return rolled.reshape(grid.shape)


def _dense_forces(pos, hs, tse, valid, model, config: CellDenseConfig, box, compute_energy):
    """Forces (+ per-slot half-split energies and virials) by dense rolls:
    one C×C self tile (both directions) plus 13 half-shell offsets in
    4-offset tiles with Newton reactions rolled back onto their owners.

    Displacements take the minimum image of the raw difference,
    d − L·round(d/L), so positions may overhang the box.  That is exact for
    pairs within half a box, where the reference's L·(s − round(s)) on
    box-scaled coordinates rounds at the scale of L: at the 97,556-atom box
    (L ≈ 48σ) its force error exceeds 2e-5 of the largest force."""
    m, c = config.cells_per_dim, config.capacity
    box_t = _box(box, pos)

    def disp(a, b):
        d = a - b
        return d - torch.round(d / box_t) * box_t

    def r2_of(dv):
        return dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1] + dv[..., 2] * dv[..., 2]

    def pair_terms(r2s, ok, hs_i, tse_i, hs_j, tse_j):
        e, mre = pair_interaction(r2s, model, hs_i, tse_i, hs_j, tse_j)
        return torch.where(ok, e, 0.0), torch.where(ok, mre, 0.0)

    # ---- self-cell tile: (M³, C, C), both directions, mask i == j ----
    dv = disp(pos[:, :, None, :], pos[:, None, :, :])
    r2 = r2_of(dv)
    eye = torch.eye(c, dtype=torch.bool, device=pos.device)
    ok = valid[:, :, None] & valid[:, None, :] & ~eye[None]
    r2s = torch.where(ok, r2, 1.0)
    e, mre = pair_terms(r2s, ok, hs[:, :, None], tse[:, :, None], hs[:, None, :], tse[:, None, :])
    forces = torch.sum((mre / r2s)[..., None] * dv, dim=2)
    if compute_energy:
        energies = 0.5 * torch.sum(e, dim=2)
        virials = 0.5 * torch.sum(mre, dim=2)

    # ---- half-shell groups: (M³, C, 4·C) tiles with reaction rolls ----
    for g in range(0, len(_OFFSETS), _GROUP):
        offs = _OFFSETS[g : g + _GROUP]
        nbr = lambda a: torch.cat([_roll_cells(a, o, m) for o in offs], dim=1)  # noqa: E731
        nbr_pos, nbr_hs, nbr_tse, nbr_valid = nbr(pos), nbr(hs), nbr(tse), nbr(valid)
        dv = disp(pos[:, :, None, :], nbr_pos[:, None, :, :])
        r2 = r2_of(dv)
        ok = valid[:, :, None] & nbr_valid[:, None, :]
        r2s = torch.where(ok, r2, 1.0)
        e, mre = pair_terms(r2s, ok, hs[:, :, None], tse[:, :, None], nbr_hs[:, None, :], nbr_tse[:, None, :])
        gdv = torch.where(ok, mre / r2s, 0.0)[..., None] * dv
        forces = forces + torch.sum(gdv, dim=2)
        reaction = -torch.sum(gdv, dim=1)  # (M³, 4·C, 3)
        for k, o in enumerate(offs):
            forces = forces + _roll_cells(reaction[:, k * c : (k + 1) * c], -o, m)
        if compute_energy:
            energies = energies + 0.5 * torch.sum(e, dim=2)
            virials = virials + 0.5 * torch.sum(mre, dim=2)
            e_r = 0.5 * torch.sum(e, dim=1)
            w_r = 0.5 * torch.sum(mre, dim=1)
            for k, o in enumerate(offs):
                energies = energies + _roll_cells(e_r[:, k * c : (k + 1) * c], -o, m)
                virials = virials + _roll_cells(w_r[:, k * c : (k + 1) * c], -o, m)

    if compute_energy:
        return forces, energies, virials
    return forces, None, None


def cell_dense_forces(
    state: CellDenseState, model: LennardJonesModel, config: CellDenseConfig, *,
    compute_energy: bool = False,
):
    """Forces (+ per-slot energies/virials) for every live slot, in plain
    PyTorch: the plain version of the force kernel (`cell_kernel.py`)."""
    return _dense_forces(
        state.positions, state.half_sigma, state.twice_sqrt_eps, state.valid,
        model, config, config.box, compute_energy,
    )


# ---------------------------------------------------------------------------
# The shift rebin
# ---------------------------------------------------------------------------


def _route_axis_pass(fields, valid, overflow, cf, b, m, c, nbr, box):
    """One ±1-cell routing pass along one grid axis (no-spill path) — the
    plain version of one launch of csrc/rebin_routing.cu.

    fields: list of (cells, C) tensors, fields[cf] this pass's coordinate;
    b: (cells,) cell coordinate along the axis; nbr(x, δ): the δ-neighbor
    cell's content of x for every cell row.  Dest cell q's 3C candidates are
    [q−1's +1 movers, q's stayers, q+1's −1 movers] in slot order; a kept
    candidate of exclusive rank r < C lands in slot r.  Returns (fields,
    valid, overflow); slots ≥ count hold zeros (callers apply the fill)."""
    coord = fields[cf]
    t = torch.clamp(torch.floor(m * wrap_scaled(coord / box)).to(torch.int64), 0, m - 1)
    d = torch.where(valid, torch.remainder(t - b[:, None], m), 0)
    legal = (d == 0) | (d == 1) | (d == m - 1)
    overflow = overflow | torch.any(valid & ~legal)
    g_minus = valid & (d == m - 1)  # target = b − 1
    g_stay = valid & (d == 0)
    g_plus = valid & (d == 1)  # target = b + 1

    mask = torch.cat([nbr(g_plus, -1), g_stay, nbr(g_minus, +1)], dim=1)
    mask_i = mask.to(torch.int64)
    rank = torch.cumsum(mask_i, dim=1) - mask_i  # exclusive prefix counts
    counts = torch.sum(mask_i, dim=1)
    overflow = overflow | (torch.max(counts) > c)
    dest = torch.where(mask & (rank < c), rank, c)  # column c is a dump slot

    out = []
    for f in fields:
        cand = torch.cat([nbr(f, -1), f, nbr(f, +1)], dim=1)
        o = torch.zeros((f.shape[0], c + 1), dtype=f.dtype, device=f.device)
        out.append(o.scatter_(1, dest, cand)[:, :c])
    slot = torch.arange(c, device=coord.device)
    return out, slot[None, :] < counts[:, None], overflow


def _rebin_shift_core(fields, valid, overflow, config: CellDenseConfig, backend: str, wrap: bool = True):
    """Field-list heart of the shift rebin: wrap positions into [0, L) (unless
    the caller did), park empty slots' positions at the NaN-pattern sentinel,
    and run the three routing passes (`rebin_kernel.rebin_routing`).

    fields: list of (M³, C) tensors — positions x, y, z first, int32 atom_id
    last.  Returns (fields, valid, overflow); empty slots hold the routing
    fill (sentinel positions, atom_id = num_slots, zeros) that callers mask."""
    from emdee_tpu_torch.neighbors.rebin_kernel import SENTINEL_BITS, rebin_routing

    box = _box(config.box, fields[0])
    sentinel = torch.tensor(SENTINEL_BITS, dtype=torch.int32, device=box.device).view(torch.float32)
    for i in range(3):
        f = fields[i]
        if wrap:
            f = f - torch.floor(f / box) * box
        fields[i] = torch.where(valid, f, sentinel)
    out, ovf = rebin_routing(
        tuple(fields), config.box, config.cells_per_dim, config.capacity,
        config.num_slots, backend=backend,
    )
    fields = list(out)
    return fields, fields[-1] < config.num_slots, overflow | ovf


def _rebin_shift(
    state: CellDenseState,
    config: CellDenseConfig,
    uniform_params=None,
    uniform_mass: Optional[float] = None,
    backend: str = "auto",
) -> CellDenseState:
    """Gather-free incremental rebin: three axis passes of ±1-cell routing.

    Between rebins every atom moves less than skin/2 < cell side, so its new
    cell lies in its old cell's 27-neighborhood; factorized per axis, each
    pass routes between cells b−1, b, b+1 only.  Uniform constants (LJ
    params, mass) are not routed: they are rebuilt from the new valid mask."""
    valid = state.valid
    box = _box(config.box, state.positions)
    pos = state.positions
    pos = torch.where(valid[..., None], pos - torch.floor(pos / box) * box, 0.0)

    fields = [pos[..., 0], pos[..., 1], pos[..., 2]]
    fields += [state.velocities[..., i] for i in range(3)]
    im_col = hs_col = None
    if uniform_mass is None:
        im_col = len(fields)
        fields.append(state.inv_masses)
    if uniform_params is None:
        hs_col = len(fields)
        fields += [state.half_sigma, state.twice_sqrt_eps]
    fields.append(state.atom_id)

    fields, valid, overflow = _rebin_shift_core(
        fields, valid, state.overflow, config, backend, wrap=False
    )

    new_pos = torch.where(valid[..., None], torch.stack(fields[0:3], dim=-1), 0.0)
    zero = lambda a: torch.where(valid, a, 0.0)  # noqa: E731
    const = lambda v: torch.where(valid, _f32(v), 0.0)  # noqa: E731
    return CellDenseState(
        positions=new_pos,
        velocities=torch.where(valid[..., None], torch.stack(fields[3:6], dim=-1), 0.0),
        inv_masses=zero(fields[im_col]) if im_col is not None else const(1.0 / uniform_mass),
        half_sigma=zero(fields[hs_col]) if hs_col is not None else const(uniform_params[0]),
        twice_sqrt_eps=(
            zero(fields[hs_col + 1]) if hs_col is not None else const(uniform_params[1])
        ),
        atom_id=torch.where(valid, fields[-1], config.num_slots),
        valid=valid,
        ref_positions=new_pos,
        step=state.step,
        overflow=overflow,
    )


# ---------------------------------------------------------------------------
# Integration in slot space
# ---------------------------------------------------------------------------


def _stale(dx, dy, dz, valid, config: CellDenseConfig) -> torch.Tensor:
    """True if any live slot moved more than skin/2 (minimum image) since
    its rebin — the block's bins were then too old."""
    box = _box(config.box, dx)
    dx = dx - torch.round(dx / box) * box
    dy = dy - torch.round(dy / box) * box
    dz = dz - torch.round(dz / box) * box
    d2 = torch.where(valid, dx * dx + dy * dy + dz * dz, 0.0)
    return torch.max(d2) > (0.5 * config.skin) ** 2


def _needs_rebin(state: CellDenseState, config: CellDenseConfig) -> torch.Tensor:
    dv = state.positions - state.ref_positions
    return _stale(dv[..., 0], dv[..., 1], dv[..., 2], state.valid, config)


def _comp_add(p, dp, comp):
    """Kahan-compensated p + dp with running compensation `comp`."""
    y = dp - comp
    t = p + y
    return t, (t - p) - y


def make_cell_dense_sim(
    config: CellDenseConfig,
    model: LennardJonesModel,
    dt: float,
    backend: str = "auto",
    uniform_params=None,
    uniform_mass: Optional[float] = None,
    coulomb=None,
    extra_forces=None,
    aux_fn=None,
    thermostat=None,
    barostat=None,
):
    """Build (rollout, energy) closures for slot-space NVE.

    backend: 'auto' (CUDA kernels for CUDA tensors, plain PyTorch for CPU
    tensors), 'cuda' or 'torch' (the plain versions on any device).

    uniform_params: optional (half_sigma, twice_sqrt_eps) floats when all
    atoms share one LJ type (`detect_uniform_params`).  With it and
    `uniform_mass`, the rollout carries per-component (M³, C) arrays and
    calls the split force entry (the TPU engine's component carry);
    otherwise it runs the stacked leapfrog on (M³, C, 3) tensors.

    The options of the TPU engine that this slice does not port raise
    NotImplementedError naming the ROADMAP item that ports them."""
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces, cell_forces_split

    unported = {
        "thermostat": (thermostat, 8),
        "barostat": (barostat, 8),
        "coulomb": (coulomb, 10),
        "extra_forces": (extra_forces, 10),
        "aux_fn": (aux_fn, 10),
    }
    for name, (value, item) in unported.items():
        if value is not None:
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP item {item})")
    if config.spill:
        raise NotImplementedError("boundary-spill configs are not ported yet (ROADMAP item 8)")
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}: use 'auto', 'cuda' or 'torch'")

    ns = config.num_slots
    dt_f = _f32(dt)
    half_dt = _f32(np.float32(0.5) * np.float32(dt))
    use_component_carry = uniform_params is not None and uniform_mass is not None

    def forces_of(st: CellDenseState):
        return cell_forces(
            st, model, config, uniform_params=uniform_params, backend=backend
        )[0]

    def energy(st: CellDenseState):
        """(potential energy, virial, kinetic energy) as 0-d tensors."""
        _, e, w = cell_forces(
            st, model, config, compute_energy=True, uniform_params=uniform_params,
            backend=backend,
        )
        pe = torch.sum(torch.where(st.valid, e, 0.0))
        vir = torch.sum(torch.where(st.valid, w, 0.0))
        ke = 0.5 * torch.sum(
            torch.where(
                st.valid[..., None],
                st.velocities**2 / torch.clamp(st.inv_masses[..., None], min=1e-30),
                0.0,
            )
        )
        return pe, vir, ke

    def rollout_component(state: CellDenseState, num_steps: int, rebin_every: int):
        # Leapfrog on per-component (M³, C) arrays: x, y, z, vx, vy, vz and
        # atom_id, plus the rebin-time reference coordinates and the flag.
        inv_m = np.float32(1.0 / uniform_mass)
        kick_dt = _f32(np.float32(dt) * inv_m)
        half_kick = _f32(np.float32(0.5) * np.float32(dt) * inv_m)
        px, py, pz = (state.positions[..., i].contiguous() for i in range(3))
        vx, vy, vz = (state.velocities[..., i].contiguous() for i in range(3))
        aid = torch.where(state.valid, state.atom_id, ns)
        ovf = state.overflow
        f0 = cell_forces_split(px, py, pz, state.valid, config, uniform_params=uniform_params, backend=backend)
        vx, vy, vz = vx + half_kick * f0[0], vy + half_kick * f0[1], vz + half_kick * f0[2]
        rx, ry, rz = px, py, pz
        blocks, rem = divmod(num_steps, rebin_every)
        for length in [rebin_every] * blocks + ([rem] if rem else []):
            fields, valid, ovf = _rebin_shift_core([px, py, pz, vx, vy, vz, aid], aid < ns, ovf, config, backend)
            zero = lambda a: torch.where(valid, a, 0.0)  # noqa: E731
            px, py, pz, vx, vy, vz = (zero(a) for a in fields[:6])
            aid = torch.where(valid, fields[6], ns)
            rx, ry, rz = px, py, pz
            zc = torch.zeros_like(px)
            cx = cy = cz = wx = wy = wz = zc
            for _ in range(length):
                px, cx = _comp_add(px, dt_f * vx, cx)
                py, cy = _comp_add(py, dt_f * vy, cy)
                pz, cz = _comp_add(pz, dt_f * vz, cz)
                fx, fy, fz = cell_forces_split(px, py, pz, valid, config, uniform_params=uniform_params, backend=backend)
                vx, wx = _comp_add(vx, kick_dt * fx, wx)
                vy, wy = _comp_add(vy, kick_dt * fy, wy)
                vz, wz = _comp_add(vz, kick_dt * fz, wz)
            ovf = ovf | _stale(px - rx, py - ry, pz - rz, valid, config)
        valid = aid < ns
        ff = cell_forces_split(px, py, pz, valid, config, uniform_params=uniform_params, backend=backend)
        vx, vy, vz = vx - half_kick * ff[0], vy - half_kick * ff[1], vz - half_kick * ff[2]
        const = lambda v: torch.where(valid, _f32(v), 0.0)  # noqa: E731
        return CellDenseState(
            positions=torch.stack([px, py, pz], dim=-1),
            velocities=torch.stack([vx, vy, vz], dim=-1),
            inv_masses=const(1.0 / uniform_mass),
            half_sigma=const(uniform_params[0]),
            twice_sqrt_eps=const(uniform_params[1]),
            atom_id=aid,
            valid=valid,
            ref_positions=torch.stack([rx, ry, rz], dim=-1),
            step=state.step + num_steps,
            overflow=ovf,
        )

    def rollout_stacked(state: CellDenseState, num_steps: int, rebin_every: int):
        # Leapfrog: velocities ride half a step ahead inside the rollout, so
        # no force field crosses a rebin; a closing half un-kick re-syncs.
        f0 = forces_of(state)
        st = state._replace(velocities=state.velocities + half_dt * f0 * state.inv_masses[..., None])
        blocks, rem = divmod(num_steps, rebin_every)
        for length in [rebin_every] * blocks + ([rem] if rem else []):
            st = _rebin_shift(st, config, uniform_params, uniform_mass, backend)
            inv_m = st.inv_masses[..., None]
            pos, vel = st.positions, st.velocities
            comp = torch.zeros_like(pos)
            vcomp = torch.zeros_like(vel)
            for _ in range(length):
                # Kahan-compensated drift and kick: dt·v is ~1e-4 of the
                # coordinate, so a plain += loses about an ulp per step.
                new_pos, comp = _comp_add(pos, dt_f * vel, comp)
                pos = torch.where(st.valid[..., None], new_pos, pos)
                f = forces_of(st._replace(positions=pos))
                vel, vcomp = _comp_add(vel, dt_f * f * inv_m, vcomp)
            st = st._replace(positions=pos, velocities=vel, step=st.step + length)
            st = st._replace(overflow=st.overflow | _needs_rebin(st, config))
        f_end = forces_of(st)
        return st._replace(velocities=st.velocities - half_dt * f_end * st.inv_masses[..., None])

    def rollout(state: CellDenseState, num_steps: int, rebin_every: int = 10, record: bool = False):
        """Blocked NVE rollout: rebin every `rebin_every` steps, then run that
        many leapfrog steps.  The staleness check and the overflow flag stay
        on the device; nothing here waits for the device."""
        if record:
            raise NotImplementedError("record=True is not ported yet (ROADMAP item 8)")
        if num_steps == 0:
            return state
        if use_component_carry:
            return rollout_component(state, num_steps, rebin_every)
        return rollout_stacked(state, num_steps, rebin_every)

    return rollout, energy


# ---------------------------------------------------------------------------
# Slot layout → atom order (host)
# ---------------------------------------------------------------------------


def gather_dense_atoms(state: CellDenseState, num_atoms: int):
    """Slot layout → (positions, velocities) numpy arrays in atom order."""
    ids = _numpy(state.atom_id).reshape(-1)
    keep = _numpy(state.valid).reshape(-1)
    pos = np.zeros((num_atoms, 3), np.float32)
    vel = np.zeros((num_atoms, 3), np.float32)
    pos[ids[keep]] = _numpy(state.positions).reshape(-1, 3)[keep]
    vel[ids[keep]] = _numpy(state.velocities).reshape(-1, 3)[keep]
    return pos, vel


def gather_dense_fields(state: CellDenseState, num_atoms: int) -> dict:
    """Slot layout → every per-atom field in atom order (host): the inverse
    of `cell_dense_init`."""
    ids = _numpy(state.atom_id).reshape(-1)
    keep = _numpy(state.valid).reshape(-1)
    sel = ids[keep]

    def take(a):
        flat = _numpy(a).reshape((len(keep),) + tuple(a.shape[2:]))
        out = np.zeros((num_atoms,) + flat.shape[1:], flat.dtype)
        out[sel] = flat[keep]
        return out

    inv_m = take(state.inv_masses)
    return {
        "positions": take(state.positions),
        "velocities": take(state.velocities),
        "masses": 1.0 / np.maximum(inv_m, 1e-30),
        "half_sigma": take(state.half_sigma),
        "twice_sqrt_eps": take(state.twice_sqrt_eps),
    }
