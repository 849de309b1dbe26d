"""Dense-cell force engine in slot layout — counterpart of
emdee_tpu/neighbors/cell_dense.py (LJ: NVE, CSVR and Langevin NVT,
Berendsen NPT on a dynamic box, the shift and sort rebins, the
boundary-spill capacity mode).

Atoms live in a dense slot grid (M³, C): cell side h = L/M ≥ cutoff + skin,
capacity C per cell.  Between rebins the state never reindexes atoms; every
`rebin_every` steps three ±1-cell routing passes move each atom to its new
cell (`_rebin_shift`; `_rebin` is the argsort rebin), and a sticky
`overflow` flag records capacity overflow, illegal moves and skin/2
staleness.  Positions are wrapped into [0, L) only at rebins; between
rebins they may overhang the box by skin/2.

Spill configs (`suggest_cell_dense_config(spill=True)`) set capacity near
the mean occupancy and shed each over-full cell's near-face atoms into its
+axis neighbour: the stored cell is the true cell or the next one along
each axis, never further (`_route_axis_pass`).  Their rebin runs the torch
routing passes with the window-compaction kernel (`compact_kernel.py`);
the whole-pass rebin kernel (`rebin_kernel.py`) serves every other config.

Backends of the engine (`resolve_dense_backend`): "auto" picks, for CUDA
tensors, the kernel family that the TPU engine picks for the same config —
the counterpart of its VMEM-resident kernel, "cuda" (`cell_kernel.py`), up
to its 13 MB VMEM estimate, that of its streaming kernel, "cuda_streaming"
(`streaming_kernel.py`), above it — and the plain PyTorch versions ("torch")
for CPU tensors.  "cuda" and "cuda_streaming" insist on their kernels and
raise for CPU tensors; "torch" runs the plain versions on any device.

The box is `config.box` unless the state carries its own (`state.box`, a
0-d float32 tensor: the NPT engine's dynamic box).  Kernels read either
from the device (`box_ptr`), so no step waits for a host read.  Scalar
constants that the reference forms in float32 (dt·½, 1/m) are formed in float32 here too,
and every division by the box divides by a tensor on the data's device:
CUDA turns division by a host scalar into a reciprocal multiply, which
would move bin edges by an ulp.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from emdee_tpu_torch.core.pbc import wrap_scaled
from emdee_tpu_torch.core.types import LJParams, resolve_device
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
    # Boundary-spill balancing (`_route_axis_pass`): capacity near the mean
    # occupancy, the occupancy tail shed into +axis neighbours.
    spill: bool = False
    # Squeeze mode: spill toward an occupancy ≤ spill_target < capacity
    # (0 → capacity), until `shrink_capacity` can cut the empty columns.
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
    charges: Optional[torch.Tensor] = None  # (M³, C) float32 — molecular systems only
    # Dynamic (NPT) box, a 0-d float32 tensor; None → the static config.box.
    # The cell count M stays static; only the cell side breathes.
    box: Optional[torch.Tensor] = None


class CSVRConfig(NamedTuple):
    """Bussi CSVR thermostat on the dense engine: one global velocity
    rescale per step (`dynamics/bussi.py`)."""

    temperature: float
    tau: float
    kB: float = 1.0


class LangevinConfig(NamedTuple):
    """BAOAB Langevin thermostat on the dense engine; the mid-step drift does
    not wrap (the engine's no-wrap-between-rebins contract)."""

    temperature: float
    friction: float
    kB: float = 1.0


class BerendsenBarostatConfig(NamedTuple):
    """Berendsen weak pressure coupling at rebin boundaries: μ = (1 −
    (dt_block/τ)·κ·(P₀ − P))^{1/3}, clipped to μ³ ∈ [0.9, 1.1], rescales
    positions and the dynamic state box once per block.  The cell count
    stays static; the sticky flag trips when the box shrinks past M·(rc +
    skin) — `reconfigure_dense_state` re-derives the geometry from there."""

    pressure: float
    tau: float
    kappa: float = 1.0


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
    identical bits, charges and a dynamic box included when present."""
    box, q = fields.get("box"), fields.get("charges")
    return CellDenseState(
        **{name: _tensor(fields[name], dt, device) for name, dt in _STATE_DTYPES.items()},
        charges=None if q is None else _tensor(q, np.float32, device),
        box=None if box is None else _tensor(box, np.float32, device).reshape(()),
    )


def state_to_numpy(state: CellDenseState) -> dict:
    """Inverse of `state_from_numpy`: a dict of numpy arrays whose keys are
    the JAX `CellDenseState` fields; `charges` and `box` only when the
    state has them."""
    out = {name: _numpy(getattr(state, name)) for name in _STATE_DTYPES}
    if state.charges is not None:
        out["charges"] = _numpy(state.charges)
    if state.box is not None:
        out["box"] = _numpy(state.box)
    return out


def lj_params_from_numpy(params, device) -> LJParams:
    """Port `LJParams` from any (half_sigma, twice_sqrt_eps) pair of arrays,
    e.g. a JAX `LJParams` taken to the host."""
    return LJParams(
        half_sigma=_tensor(params[0], np.float32, device),
        twice_sqrt_eps=_tensor(params[1], np.float32, device),
    )


def resolve_backend(backend: str, tensor: torch.Tensor) -> str:
    """A kernel wrapper's backend: 'auto' → 'cuda' (launch the kernel) for
    CUDA tensors, 'torch' (the plain version) for CPU tensors."""
    if backend == "torch":
        return "torch"
    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown backend {backend!r}: use 'auto', 'cuda' or 'torch'")
    if tensor.is_cuda:
        return "cuda"
    if backend == "cuda":
        raise ValueError("backend='cuda' needs tensors on a CUDA device")
    return "torch"


@functools.lru_cache(maxsize=None)
def _static_box(box: float, device: torch.device) -> torch.Tensor:
    # A fill on the device: building it from host data (torch.tensor) would
    # copy from the host and synchronise the stream.  Made once per value
    # and device, so a static box costs no launch per force call.
    return torch.full((), box, dtype=torch.float32, device=device)


def _box(box, like: torch.Tensor) -> torch.Tensor:
    """The box as a 0-d float32 tensor on `like`'s device: a dynamic box as
    it is, a number as a shared, cached tensor (never write into it)."""
    if isinstance(box, torch.Tensor):
        return box
    return _static_box(float(box), like.device)


def _box_of(state: CellDenseState, config: CellDenseConfig):
    """The state's box: its dynamic box (a 0-d tensor) or config.box."""
    return config.box if state.box is None else state.box


def _state_box(state: CellDenseState, config: CellDenseConfig) -> torch.Tensor:
    """The state's box as a 0-d float32 tensor on its device."""
    return _box(_box_of(state, config), state.positions)


def box_ptr(box, like: torch.Tensor) -> int:
    """The device pointer a kernel reads the box from, so that no launch
    waits for a host read of it: a dynamic box (a 0-d float32 tensor on
    `like`'s device) or a number, held on the device by `_box`."""
    box = _box(box, like)
    if box.dtype != torch.float32 or box.dim() != 0 or box.device != like.device:
        raise ValueError(f"box: expected a 0-d float32 tensor on {like.device}, got {box.dtype} "
                         f"{tuple(box.shape)} on {box.device}")
    return box.data_ptr()


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
    spill_margin: float = 0.15,
) -> CellDenseConfig:
    """Derive cells/dim and slot capacity from geometry: M = ⌊L/(rc+skin)⌋,
    C = mean occupancy + 2.5σ + 1, rounded up to a multiple of 8.

    spill=True reserves a spill margin ε = h − rc − skin > 0 in the cell
    side (M = ⌊L/(rc + skin + spill_margin)⌋) and sets capacity to the mean
    + 0.5σ + 0.5: the boundary spill sheds the occupancy tail instead."""
    m = int(np.floor(box / (cutoff + skin + (spill_margin if spill else 0.0))))
    if m < 3:
        raise ValueError(
            f"box {box} holds only {m} cells of side ≥ {cutoff + skin}; "
            "use the all-pairs method for boxes this small"
        )
    mean_occ = num_atoms / m**3
    if spill:
        cap = int(np.ceil(mean_occ + 0.5 * np.sqrt(mean_occ) + 0.5))
    else:
        cap = int(np.ceil(mean_occ + 2.5 * np.sqrt(mean_occ) + 1.0))
    cap = -(-cap // 8) * 8
    return CellDenseConfig(
        cells_per_dim=m, capacity=cap, box=box, cutoff=cutoff, switch=switch,
        skin=skin, num_atoms=num_atoms, spill=spill,
    )


def estimate_kernel_vmem_bytes(config: CellDenseConfig) -> int:
    """The TPU engine's VMEM estimate of its resident kernel (5 ghost fields,
    reaction accumulator, a pencil's centre block and pair-tile
    temporaries), the same integer, so that `resolve_dense_backend` picks
    the same kernel family for the same config."""
    m, c = config.cells_per_dim, config.capacity
    g = m + 2
    ghost = g * g * g * c * 4
    react = 3 * ghost
    centers = 5 * c * m * 4
    tiles = 8 * c * m * c * 4
    return 5 * ghost + react + centers + tiles


STREAMING_THRESHOLD_BYTES = 13_000_000
BACKENDS = ("auto", "cuda", "cuda_streaming", "torch")


def resolve_dense_backend(
    config: CellDenseConfig,
    backend: str = "auto",
    *,
    device,
    with_coulomb: bool = False,
    with_excl: bool = False,
) -> str:
    """The engine's kernel family for tensors on `device`: 'cuda' (the
    resident kernel's counterpart, K2), 'cuda_streaming' (the streaming
    kernel's, K5) or 'torch' (the plain versions).

    'auto' follows the TPU engine's rule: the streaming family once the
    resident kernel's VMEM estimate, ×7/5 with Coulomb and ×6/5 with
    exclusions, passes 13 MB; on the CPU it is 'torch'.  'cuda' and
    'cuda_streaming' raise for a device that is not CUDA.  Nothing here
    touches the card."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: use one of {', '.join(BACKENDS)}")
    on_card = torch.device(device).type == "cuda"
    if backend == "auto":
        if not on_card:
            return "torch"
        est = estimate_kernel_vmem_bytes(config)
        if with_coulomb:
            est = est * 7 // 5
        if with_excl:
            est = est * 6 // 5
        return "cuda_streaming" if est > STREAMING_THRESHOLD_BYTES else "cuda"
    if backend != "torch" and not on_card:
        raise ValueError(f"backend={backend!r} needs tensors on a CUDA device, got {device}")
    return backend


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


def _bin_to_slots(positions, per_atom, config: CellDenseConfig, cell_override=None):
    """Scatter per-atom arrays into the (M³, C) slot layout: one stable
    argsort, then one index-put whose dropped rows (beyond capacity) land in
    an extra dump slot.  `cell_override` (N,) gives the cells instead of
    binning the positions.  Returns (slot arrays, overflow flag)."""
    m, c = config.cells_per_dim, config.capacity
    n = positions.shape[0]
    nc = m**3
    dev = positions.device
    if cell_override is not None:
        cell = cell_override.to(device=dev, dtype=torch.int64)
    else:
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


def _spill_assign_np(positions, config: CellDenseConfig):
    """Init-time one-directional boundary spill (host, numpy), the same
    greedy routing as the reference's: each over-full cell sheds its
    near-face atoms (within ε = h − rc − skin of the +face, farthest first)
    into its +axis neighbour while that has room, axis by axis, until no
    cell is over capacity or nothing moves.  Only atoms still in their true
    cell may move, so an atom's stored cell is its true cell or the next one
    along each axis.

    positions: (N, 3) wrapped into [0, L).  Returns (cell ids (N,) int32,
    coordinates (N, 3) float32 with periodic-seam spills shifted by −L on
    the axis they crossed, the seam mask (N, 3) of those shifts, ok)."""
    m, cap = config.cells_per_dim, config.capacity
    box, h = float(config.box), float(config.cell_side)
    eps = h - float(config.cutoff) - float(config.skin)
    pos = np.asarray(positions, np.float64)
    s = pos / box - np.floor(pos / box)
    v = np.clip(np.floor(m * s).astype(np.int64), 0, m - 1)
    frac = m * s - v
    true_cell = (v[:, 0] + m * (v[:, 1] + m * v[:, 2])).astype(np.int64)
    cell = true_cell.copy()
    pos_out = np.asarray(positions, np.float32).copy()
    seam = np.zeros(pos_out.shape, bool)
    counts = np.bincount(cell, minlength=m**3)
    if eps <= 0.0:
        return cell.astype(np.int32), pos_out, seam, bool(counts.max() <= cap)
    strides = (1, m, m * m)
    for _ in range(16):
        progressed = False
        for ax in (0, 1, 2):
            over = np.flatnonzero(counts > cap)
            if not over.size:
                break
            stride = strides[ax]
            for cid in over:
                need = int(counts[cid] - cap)
                if need <= 0:
                    continue
                coord_ax = (cid // stride) % m
                ncid = cid + stride if coord_ax < m - 1 else cid - (m - 1) * stride
                room = int(cap - counts[ncid])
                if room <= 0:
                    continue
                members = np.flatnonzero((cell == cid) & (true_cell == cid))
                elig = members[frac[members, ax] > 1.0 - eps / h]
                elig = elig[np.argsort(-frac[elig, ax])][: min(need, room)]
                if not elig.size:
                    continue
                cell[elig] = ncid
                counts[cid] -= elig.size
                counts[ncid] += elig.size
                progressed = True
                if coord_ax == m - 1:  # periodic seam: a coordinate coherent with cell 0
                    pos_out[elig, ax] -= box
                    seam[elig, ax] = True
        if counts.max() <= cap or not progressed:
            break
    return cell.astype(np.int32), pos_out, seam, bool(counts.max() <= cap)


def shrink_capacity(state: CellDenseState, config: CellDenseConfig, new_capacity: int):
    """Slice the slot columns down to `new_capacity` after a spill squeeze
    emptied the upper ones (compaction packs valid slots first, so occupancy
    ≤ new_capacity ⟺ columns ≥ new_capacity are empty).  Returns (state,
    config) at the new capacity; raises if an upper column is occupied."""
    if new_capacity >= config.capacity:
        return state, config
    leftover = int(state.valid[:, new_capacity:].sum())
    if leftover:
        raise ValueError(
            f"{leftover} atoms still stored beyond capacity {new_capacity} — "
            "squeeze has not converged (run more rebins with spill_target set)"
        )
    cut = lambda a: a[:, :new_capacity].contiguous()  # noqa: E731
    return (
        state._replace(
            positions=cut(state.positions),
            velocities=cut(state.velocities),
            inv_masses=cut(state.inv_masses),
            half_sigma=cut(state.half_sigma),
            twice_sqrt_eps=cut(state.twice_sqrt_eps),
            atom_id=cut(state.atom_id),
            valid=cut(state.valid),
            ref_positions=cut(state.ref_positions),
            charges=None if state.charges is None else cut(state.charges),
        ),
        config._replace(capacity=new_capacity, spill_target=0),
    )


def cell_dense_init(
    positions, velocities, masses, params: LJParams, config: CellDenseConfig, charges=None, device=None
) -> CellDenseState:
    """Pack (N, …) arrays into slot layout on `device` (default: the CUDA
    card; `resolve_device`); `charges` (N,), when given, becomes the
    (M³, C) charge field of a molecular state.

    Positions are binned from their raw values and stored wrapped into
    [0, L), as every rebin stores them.  With a spill config the cells come
    from `_spill_assign_np`, and an atom spilled across the periodic seam is
    stored at its wrapped coordinate less L on that axis, coherent with its
    stored cell 0 — the overhang a rebin's seam spill leaves, which the
    kernels need because they take the periodic shift from the cell index
    (the reference stores the wrapped coordinate, a box away from its cell).
    Overflow is left to the caller via the flag (re-init with a larger
    capacity)."""
    device = resolve_device(device)
    cell_override = seam = None
    if config.spill:
        p64 = _numpy(positions).astype(np.float64)
        p64 = p64 - np.floor(p64 / config.box) * config.box
        cells, positions, seam, _ = _spill_assign_np(p64, config)
        cell_override = torch.from_numpy(cells.astype(np.int64)).to(device)
        seam = torch.from_numpy(seam).to(device)
    pos = _tensor(positions, np.float32, device)
    n = pos.shape[0]
    box = _box(config.box, pos)
    stored_pos = pos - torch.floor(pos / box) * box
    if seam is not None:
        stored_pos = torch.where(seam, stored_pos - box, stored_pos)
    per_atom = {
        "positions": (stored_pos, 0.0),
        "velocities": (_tensor(velocities, np.float32, device), 0.0),
        "inv_masses": (1.0 / _tensor(masses, np.float32, device), 0.0),
        "half_sigma": (_tensor(params.half_sigma, np.float32, device), 0.0),
        "twice_sqrt_eps": (_tensor(params.twice_sqrt_eps, np.float32, device), 0.0),
        "atom_id": (torch.arange(n, dtype=torch.int32, device=device), config.num_slots),
        "valid": (torch.ones(n, dtype=torch.bool, device=device), False),
    }
    if charges is not None:
        per_atom["charges"] = (_tensor(charges, np.float32, device), 0.0)
    out, overflow = _bin_to_slots(pos, per_atom, config, cell_override)
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
        charges=out.get("charges"),
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


class Molecular(NamedTuple):
    """The molecular operands of the plain force pass: charges (M³, C) with
    the DSF model, and the exclusion tags of the centre slots.

    aid: (M³, C) float32 atom ids, −2 on empty slots (never a tag);
    excl: None or (ids, mlj, mcs, bond) — ids (M³, C, E) float32 partner
    atom ids (−1 pad), mlj/mcs the 1 − scale weights, bond None or the
    (kb, kr0, kr02) weights (M³, C, E_b) of harmonic bonds on the first E_b
    tags (`cell_dense_molecular.build_exclusion_tables(bonds=…)`)."""

    q: Optional[torch.Tensor]
    coulomb: object
    aid: Optional[torch.Tensor]
    excl: Optional[tuple]


def _molecular(state, coulomb, excl) -> Optional[Molecular]:
    """The `Molecular` operands of a state, or None for plain LJ.  Missing
    Coulomb scales default to the LJ scales (the correction-pass
    convention, as the reference's `cell_dense_forces`)."""
    if coulomb is None and excl is None:
        return None
    if coulomb is not None and state.charges is None:
        raise ValueError("coulomb model given but state has no charges")
    aid = None
    if excl is not None:
        ids, mlj, mcs = excl[:3]
        bond = excl[3] if len(excl) > 3 else None
        if coulomb is not None and mcs is None:
            mcs = mlj
        excl = (ids, mlj, mcs, bond)
        aid = torch.where(state.valid, state.atom_id, -2).to(torch.float32)
    return Molecular(state.charges if coulomb is not None else None, coulomb, aid, excl)


def _molecular_terms(r2s, e, mre, model, mol: Molecular, cen: dict, nbr: dict):
    """Add the molecular terms to one tile's LJ (e, −r·dE/dr): the tag
    scaling of LJ and DSF, DSF Coulomb, and the harmonic bonds on the
    first E_b tag matches, −r·dE/dr = kr0·r − kb·r² and E = ½(kb·r² +
    kr02) − kr0·r, masked to r² < rc² so that periodic images of a partner
    drop out.  cen: the centre slots' q (…, C, 1) and tags (…, C, 1, E);
    nbr: the neighbours' q and aid (…, 1, K)."""
    from emdee_tpu_torch.potentials.coulomb import coulomb_interaction

    csc = match = None
    if mol.excl is not None:
        ids, mlj, mcs, _ = cen["excl"]
        match = ids == nbr["aid"][..., None]
        ljsc = 1.0 - torch.sum(torch.where(match, mlj, 0.0), dim=-1)
        e = e * ljsc
        mre = mre * ljsc
        if mol.coulomb is not None:
            csc = 1.0 - torch.sum(torch.where(match, mcs, 0.0), dim=-1)
    if mol.coulomb is not None:
        e_c, mre_c = coulomb_interaction(r2s, mol.coulomb, cen["q"], nbr["q"])
        if csc is not None:
            e_c = e_c * csc
            mre_c = mre_c * csc
        e = e + e_c
        mre = mre + mre_c
    bond = None if mol.excl is None else cen["excl"][3]
    if bond is not None:
        mb = match[..., : bond[0].shape[-1]]
        kb, kr0, kr02 = (torch.sum(torch.where(mb, w, 0.0), dim=-1) for w in bond)
        r = torch.sqrt(r2s)
        inside = r2s < model.rc2
        mre = mre + torch.where(inside, kr0 * r - kb * r2s, 0.0)
        e = e + torch.where(inside, 0.5 * (kb * r2s + kr02) - kr0 * r, 0.0)
    return e, mre


def _dense_forces(pos, hs, tse, valid, model, config: CellDenseConfig, box, compute_energy,
                  mol: Optional[Molecular] = None):
    """Forces (+ per-slot half-split energies and virials) by dense rolls:
    one C×C self tile (both directions) plus 13 half-shell offsets in
    4-offset tiles with Newton reactions rolled back onto their owners.
    `mol` adds DSF Coulomb, the exclusion tags and the tag-borne bonds
    (`_molecular_terms`); the tags are the centre's, so a pair's reaction
    carries the term its centre computed.

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

    cen = {}
    if mol is not None:
        cen["q"] = None if mol.q is None else mol.q[:, :, None]
        if mol.excl is not None:
            ids, mlj, mcs, bond = mol.excl
            tag = lambda t: None if t is None else t[:, :, None, :]  # noqa: E731
            cen["excl"] = (tag(ids), tag(mlj), tag(mcs), None if bond is None else tuple(map(tag, bond)))

    def nbr_side(q, aid):
        return {"q": None if q is None else q[:, None, :], "aid": None if aid is None else aid[:, None, :]}

    def pair_terms(r2s, ok, hs_i, tse_i, hs_j, tse_j, nbr=None):
        e, mre = pair_interaction(r2s, model, hs_i, tse_i, hs_j, tse_j)
        if mol is not None:
            e, mre = _molecular_terms(r2s, e, mre, model, mol, cen, nbr)
        return torch.where(ok, e, 0.0), torch.where(ok, mre, 0.0)

    # ---- self-cell tile: (M³, C, C), both directions, mask i == j ----
    dv = disp(pos[:, :, None, :], pos[:, None, :, :])
    r2 = r2_of(dv)
    eye = torch.eye(c, dtype=torch.bool, device=pos.device)
    ok = valid[:, :, None] & valid[:, None, :] & ~eye[None]
    r2s = torch.where(ok, r2, 1.0)
    e, mre = pair_terms(r2s, ok, hs[:, :, None], tse[:, :, None], hs[:, None, :], tse[:, None, :],
                        mol and nbr_side(mol.q, mol.aid))
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
        side = None
        if mol is not None:
            side = nbr_side(None if mol.q is None else nbr(mol.q), None if mol.aid is None else nbr(mol.aid))
        e, mre = pair_terms(r2s, ok, hs[:, :, None], tse[:, :, None], nbr_hs[:, None, :], nbr_tse[:, None, :],
                            side)
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
    state: CellDenseState, model: LennardJonesModel, config: CellDenseConfig, coulomb=None, excl=None, *,
    compute_energy: bool = False,
):
    """Forces (+ per-slot energies/virials) for every live slot, in plain
    PyTorch: the plain version of the force kernel (`cell_kernel.py`), at
    the state's box.

    coulomb: a `DSFCoulomb` model (the state must carry charges) — DSF
    Coulomb on every pair.  excl: slot-space exclusion tags (ids, mlj, mcs[,
    (kb, kr0, kr02)]) as `cell_dense_molecular.make_exclusion_aux_fn` gives
    them: each pair compares its neighbour's atom id with the centre's E
    tags and scales LJ by 1 − Σ match·mlj and Coulomb by 1 − Σ match·mcs
    (mcs None → mlj); the bond weights add harmonic bonds on the first E_b
    tags (the plain version of the kernel's bond branch; the reference's
    XLA path has none)."""
    return _dense_forces(
        state.positions, state.half_sigma, state.twice_sqrt_eps, state.valid,
        model, config, _box_of(state, config), compute_energy, _molecular(state, coulomb, excl),
    )


# ---------------------------------------------------------------------------
# The shift rebin
# ---------------------------------------------------------------------------


# (grid axis, +1 cell offset in `_roll_cells`' (ox, oy, oz), coordinate field)
# of the three routing passes: z, then y, then x.
_PASSES = ((0, (0, 0, 1), 2), (1, (0, 1, 0), 1), (2, (1, 0, 0), 0))


def _axis_coords(m: int, device):
    """Each cell's coordinate along grid axis 0 (z), 1 (y) and 2 (x)."""
    cell = torch.arange(m**3, device=device)
    return {0: cell // (m * m), 1: (cell // m) % m, 2: cell % m}


def _route_windows(fields, valid, overflow, cf, b, m, c, nbr, box, spill=None):
    """The masks and windows of one ±1-cell routing pass along one grid axis
    (`_route_axis_pass` without its compaction).

    fields: list of (cells, C) tensors, fields[cf] this pass's coordinate;
    b: (cells,) cell coordinate along the axis; nbr(x, δ): the δ-neighbor
    cell's content of x for every cell row.  Dest cell q's 3C candidates are
    [q−1's +1 movers, q's stayers, q+1's −1 movers] in slot order.  Returns
    (s, keep, win, counts, overflow): the left shifts lane − rank of the
    kept lanes (rows, 3C) int32, the kept mask, the (nf, rows, 3C) int32
    windows (a view of the cells' stacked fields), the kept count per row
    and the flag, raised on an illegal move or a count above C.

    spill: None, or (c_t, threshold) — boundary-spill balancing toward an
    occupancy of c_t: an over-full destination sheds stayers whose
    fractional position along the axis exceeds `threshold` (1 − ε/h,
    rounded once to float32, as the reference rounds its Python float at
    the comparison) into the next cell, and holds back −1 movers as close
    to the face they crossed, within the room of cell b+1 counted before
    spilling.  Spills are one-directional (+face only), so stored cells are
    the true cell or the next one: two atoms within the cutoff are never
    stored two cells apart when ε ≤ h − rc − skin.  A spill or hold across
    the periodic seam stores the coordinate less L, coherent with the stored
    cell's frame, as inter-rebin drift overhangs the box."""
    fields = list(fields)
    coord = fields[cf]
    ms = m * wrap_scaled(coord / box)
    t = torch.clamp(torch.floor(ms).to(torch.int64), 0, m - 1)
    d = torch.where(valid, torch.remainder(t - b[:, None], m), 0)
    legal = (d == 0) | (d == 1) | (d == m - 1)
    overflow = overflow | torch.any(valid & ~legal)
    g_minus = valid & (d == m - 1)  # target = b − 1
    g_stay = valid & (d == 0)
    g_plus = valid & (d == 1)  # target = b + 1

    if spill is not None:
        c_t, threshold = spill
        sums = lambda a: torch.sum(a, dim=1)  # noqa: E731
        csum = lambda e: torch.cumsum(e, dim=1) - e.to(torch.int64)  # noqa: E731  exclusive, in-cell
        count0 = nbr(sums(g_plus), -1) + sums(g_stay) + nbr(sums(g_minus), +1)
        excess = torch.clamp(count0 - c_t, min=0)
        # Room in cell b+1 from pre-spill counts: shedding only frees space.
        budget_plus = nbr(torch.clamp(c_t - count0, min=0), +1)
        near_face = (ms - t.to(coord.dtype)) > threshold
        elig_plus = g_stay & near_face
        n_plus = torch.minimum(torch.minimum(excess, budget_plus), sums(elig_plus))
        spill_p = elig_plus & (csum(elig_plus) < n_plus[:, None])
        g_stay = g_stay & ~spill_p
        g_plus = g_plus | spill_p
        # Hold-backs: from dest cell q's view a hold in q+1 removes one
        # arrival exactly like a spill from q, so both share one budget.
        elig_hold = g_minus & near_face
        n_hold = torch.minimum(
            torch.minimum(excess - n_plus, budget_plus - n_plus), nbr(sums(elig_hold), +1)
        )
        hold_p = elig_hold & (csum(elig_hold) < nbr(n_hold, -1)[:, None])  # my holds, decided by b−1
        g_minus = g_minus & ~hold_p
        g_stay = g_stay | hold_p
        seam = (spill_p & (b == m - 1)[:, None]) | (hold_p & (b == 0)[:, None])
        fields[cf] = torch.where(seam, coord - box, coord)

    keep = torch.cat([nbr(g_plus, -1), g_stay, nbr(g_minus, +1)], dim=1)
    keep_i = keep.to(torch.int64)
    rank = torch.cumsum(keep_i, dim=1) - keep_i  # exclusive prefix counts
    counts = torch.sum(keep_i, dim=1)
    overflow = overflow | (torch.max(counts) > c)
    iota = torch.arange(3 * c, device=coord.device)
    s = torch.where(keep, iota - rank, 0).to(torch.int32)
    x = torch.stack([f.view(torch.int32) for f in fields], dim=1)  # (cells, nf, C)
    win = torch.cat([nbr(x, -1), x, nbr(x, +1)], dim=2).transpose(0, 1)  # (nf, cells, 3C)
    return s, keep, win, counts, overflow


def _route_axis_pass(fields, valid, overflow, cf, b, m, c, nbr, box, spill=None,
                     last_fill=0, backend="torch"):
    """One ±1-cell routing pass along one grid axis — the plain version of
    one launch of csrc/rebin_routing.cu, and with `spill` the pass of the
    spill route (arguments as `_route_windows`).  A kept candidate of
    exclusive rank r < C lands in slot r, through
    `compact_kernel.compact_stacked` (`backend`: the window-compaction
    kernel on the card, its plain version otherwise); slots ≥ count hold 0,
    in the last field `last_fill`.  Returns (fields, valid, overflow)."""
    from emdee_tpu_torch.neighbors.compact_kernel import compact_stacked

    s, keep, win, counts, overflow = _route_windows(fields, valid, overflow, cf, b, m, c, nbr, box, spill)
    out = compact_stacked(s, keep, win, c, last_fill=last_fill, backend=backend)
    fields = [o.view(f.dtype) for o, f in zip(out, fields)]
    slot = torch.arange(c, device=s.device)
    return fields, slot[None, :] < counts[:, None], overflow


def _spill_params(config: CellDenseConfig):
    """The `spill` argument of a spill config's routing passes: (c_t, the
    float32 threshold 1 − ε/h on an atom's fractional cell position)."""
    h = float(config.cell_side)
    eps = h - float(config.cutoff) - float(config.skin)
    return config.spill_target or config.capacity, _f32(1.0 - eps / h)


def _spill_route(fields, valid, overflow, config: CellDenseConfig, box, backend: str):
    """The spill configs' rebin: three `_route_axis_pass`es with boundary
    spill, each compacting its windows through the window-compaction kernel
    (K7) on the card.  Empty output slots hold 0, atom_id num_slots."""
    m = config.cells_per_dim
    spill = _spill_params(config)
    coords = _axis_coords(m, box.device)
    for axis, off, cf in _PASSES:
        nbr = lambda x, d, off=off: _roll_cells(x, tuple(d * o for o in off), m)  # noqa: E731
        fields, valid, overflow = _route_axis_pass(
            fields, valid, overflow, cf, coords[axis], m, config.capacity, nbr, box,
            spill=spill, last_fill=config.num_slots, backend=backend,
        )
    return fields, valid, overflow


def _rebin_shift_core(fields, valid, overflow, config: CellDenseConfig, backend: str,
                      wrap: bool = True, box=None):
    """Field-list heart of the shift rebin: wrap positions into [0, L) (unless
    the caller did), then the three routing passes — the whole-pass rebin
    kernel (`rebin_kernel.rebin_routing`, empty slots' positions parked at
    the NaN-pattern sentinel) without spill, the spill route
    (`_spill_route`, with the window-compaction kernel) with spill.

    fields: list of (M³, C) tensors — positions x, y, z first, int32 atom_id
    last; box: the state's box (default config.box).  Returns (fields,
    valid, overflow); empty slots hold the routing fill (atom_id =
    num_slots) that callers mask."""
    from emdee_tpu_torch.neighbors.rebin_kernel import SENTINEL_BITS, rebin_routing

    box_t = _box(config.box if box is None else box, fields[0])
    # The reference's condition: spill mode with a positive margin ε = h − rc − skin.
    spills = config.spill and float(config.cell_side) - float(config.cutoff) - float(config.skin) > 0.0
    fields = list(fields)
    if spills:
        park = torch.zeros((), dtype=torch.float32, device=box_t.device)
    else:
        park = torch.full((), SENTINEL_BITS, dtype=torch.int32, device=box_t.device).view(torch.float32)
    for i in range(3):
        f = fields[i]
        if wrap:
            f = f - torch.floor(f / box_t) * box_t
        fields[i] = torch.where(valid, f, park)
    if spills:
        return _spill_route(fields, valid, overflow, config, box_t, backend)
    out, ovf = rebin_routing(
        tuple(fields), box_t, config.cells_per_dim,
        config.capacity, config.num_slots, backend=backend,
    )
    fields = list(out)
    return fields, fields[-1] < config.num_slots, overflow | ovf


def _rebin_shift(
    state: CellDenseState,
    config: CellDenseConfig,
    forces: Optional[torch.Tensor] = None,
    uniform_params=None,
    uniform_mass: Optional[float] = None,
    backend: str = "auto",
):
    """Gather-free incremental rebin: three axis passes of ±1-cell routing.

    Between rebins every atom moves less than skin/2 < cell side, so its new
    cell lies in its old cell's 27-neighborhood; factorized per axis, each
    pass routes between cells b−1, b, b+1 only.  Uniform constants (LJ
    params, mass) are not routed: they are rebuilt from the new valid mask;
    charges, when the state has them, ride as one more field.
    With `forces` (M³, C, 3), they ride along and (state, forces) is
    returned, so a synced rollout needs no force pass after the rebin."""
    valid = state.valid
    box = _state_box(state, config)
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
    f_col = len(fields)
    if forces is not None:
        fields += [forces[..., i] for i in range(3)]
    q_col = None
    if state.charges is not None:
        q_col = len(fields)
        fields.append(state.charges)
    fields.append(state.atom_id)

    fields, valid, overflow = _rebin_shift_core(
        fields, valid, state.overflow, config, backend, wrap=False, box=state.box,
    )

    new_pos = torch.where(valid[..., None], torch.stack(fields[0:3], dim=-1), 0.0)
    zero = lambda a: torch.where(valid, a, 0.0)  # noqa: E731
    const = lambda v: torch.where(valid, _f32(v), 0.0)  # noqa: E731
    new_state = state._replace(
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
        overflow=overflow,
        charges=None if q_col is None else zero(fields[q_col]),
    )
    if forces is None:
        return new_state
    return new_state, torch.where(valid[..., None], torch.stack(fields[f_col : f_col + 3], dim=-1), 0.0)


def _rebin(state: CellDenseState, config: CellDenseConfig, forces: Optional[torch.Tensor] = None):
    """The sort rebin: re-sort every live slot into fresh cells by one
    stable argsort (any displacement, not just ±1 cell).

    Every new slot gathers its source, src(cell, rank) = order[start(cell)
    + rank], with per-cell starts from `searchsorted` on the sorted keys (no
    host read), and all per-slot fields — atom ids viewed as float32, and
    the forces when given — ride one packed gather.  Positions are wrapped
    into [0, L) here.  With `forces`, returns (state, permuted forces)."""
    m, c = config.cells_per_dim, config.capacity
    nc = m**3
    ns = config.num_slots
    dev = state.positions.device
    flat_pos = state.positions.reshape(ns, 3)
    valid = state.valid.reshape(ns)
    sbox = _state_box(state, config)
    s = wrap_scaled(flat_pos / sbox)
    v = torch.clamp(torch.floor(m * s).to(torch.int64), 0, m - 1)
    cell = v[:, 0] + m * (v[:, 1] + m * v[:, 2])
    cell = torch.where(valid, cell, nc)

    order = torch.argsort(cell, stable=True)
    cell_sorted = cell[order]
    starts = torch.searchsorted(cell_sorted, torch.arange(nc + 1, device=dev))
    counts = starts[1:] - starts[:-1]
    overflow = torch.max(counts) > c

    new_rank = torch.arange(c, device=dev).repeat(nc)
    starts_rep = starts[:nc, None].expand(nc, c).reshape(-1)
    new_valid = new_rank < counts[:, None].expand(nc, c).reshape(-1)
    src = order[torch.clamp(starts_rep + new_rank, max=ns - 1)]

    fields = [
        flat_pos,
        state.velocities.reshape(ns, 3),
        state.inv_masses.reshape(ns, 1),
        state.half_sigma.reshape(ns, 1),
        state.twice_sqrt_eps.reshape(ns, 1),
        state.atom_id.reshape(ns, 1).view(torch.float32),
    ]
    if forces is not None:
        fields.append(forces.reshape(ns, 3))
    if state.charges is not None:
        fields.append(state.charges.reshape(ns, 1))
    moved = torch.where(new_valid[:, None], torch.cat(fields, dim=1)[src], 0.0)
    pos = moved[:, 0:3]
    pos = torch.where(new_valid[:, None], pos - torch.floor(pos / sbox) * sbox, 0.0)
    ids = torch.where(new_valid, moved[:, 9].contiguous().view(torch.int32), ns)

    new_pos = pos.reshape(nc, c, 3)
    new_state = state._replace(
        positions=new_pos,
        velocities=moved[:, 3:6].reshape(nc, c, 3),
        inv_masses=moved[:, 6].reshape(nc, c),
        half_sigma=moved[:, 7].reshape(nc, c),
        twice_sqrt_eps=moved[:, 8].reshape(nc, c),
        atom_id=ids.reshape(nc, c),
        valid=new_valid.reshape(nc, c),
        ref_positions=new_pos,
        overflow=state.overflow | overflow,
        charges=None if state.charges is None else moved[:, -1].reshape(nc, c),
    )
    if forces is None:
        return new_state
    return new_state, moved[:, 10:13].reshape(nc, c, 3)


# ---------------------------------------------------------------------------
# Integration in slot space
# ---------------------------------------------------------------------------


def _stale(dx, dy, dz, valid, config: CellDenseConfig, box=None) -> torch.Tensor:
    """True if any live slot moved more than skin/2 (minimum image) since
    its rebin — the block's bins were then too old.  box: the state's box
    (default config.box)."""
    box = _box(config.box if box is None else box, dx)
    dx = dx - torch.round(dx / box) * box
    dy = dy - torch.round(dy / box) * box
    dz = dz - torch.round(dz / box) * box
    d2 = torch.where(valid, dx * dx + dy * dy + dz * dz, 0.0)
    return torch.max(d2) > (0.5 * config.skin) ** 2


def _needs_rebin(state: CellDenseState, config: CellDenseConfig) -> torch.Tensor:
    dv = state.positions - state.ref_positions
    return _stale(dv[..., 0], dv[..., 1], dv[..., 2], state.valid, config, state.box)


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
    rebin: str = "shift",
    thermostat=None,
    barostat=None,
    coulomb=None,
    extra_forces=None,
    aux_fn=None,
    extra_energy=None,
    extra_aux_fn=None,
):
    """Build (rollout, energy) closures for slot-space NVE, NVT and NPT.

    backend: one of `BACKENDS`, resolved against the state's device at each
    call by `resolve_dense_backend` — 'auto' (the TPU engine's rule: the
    resident family 'cuda' or the streaming family 'cuda_streaming' for CUDA
    tensors, the plain versions for CPU tensors), 'cuda', 'cuda_streaming'
    or 'torch' (the plain versions on any device).

    uniform_params: optional (half_sigma, twice_sqrt_eps) floats when all
    atoms share one LJ type (`detect_uniform_params`).  With it and
    `uniform_mass`, NVE with the shift rebin carries per-component (M³, C)
    arrays and calls the split force entry (the TPU engine's component
    carry); otherwise NVE runs the stacked leapfrog on (M³, C, 3) tensors.

    rebin: 'shift' (`_rebin_shift`: ±1-cell routing, with boundary spill
    for spill configs) or 'sort' (`_rebin`, any displacement).

    thermostat: None (NVE), `CSVRConfig` or `LangevinConfig`; barostat:
    None or `BerendsenBarostatConfig` (the state box becomes dynamic; not
    with spill configs).  These and `record=True` run the synced
    kick-drift-kick path, whose forces ride through each rebin.  A
    thermostatted rollout needs `rng`, a `torch.Generator` on the state's
    device.

    The molecular hooks (`cell_dense_molecular.make_molecular_dense_sim`
    sets them): coulomb, a `DSFCoulomb` model — DSF Coulomb on every pair
    over state.charges; aux_fn(state) → slot-space exclusion tags (ids,
    mlj, mcs[, (kb, kr0, kr02)]) for the force pass; extra_aux_fn(state) →
    per-rebin bindings handed to extra_forces(state, eaux) → (M³, C, 3) and
    extra_energy(state, eaux) → (pe, vir).  Both aux functions run once
    after every rebin, whatever the rollout path, and the energy closure
    drops the bond tags (aux[:3]): extra_energy adds the full bonded
    energy.  The streaming family has no molecular terms yet (K5c)."""
    from emdee_tpu_torch.dynamics.bussi import _csvr_alpha2, csvr_draws
    from emdee_tpu_torch.neighbors import cell_kernel, streaming_kernel

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: use one of {', '.join(BACKENDS)}")
    if rebin not in ("shift", "sort"):
        raise ValueError(f"unknown rebin {rebin!r}: use 'shift' or 'sort'")
    if thermostat is not None and not isinstance(thermostat, (CSVRConfig, LangevinConfig)):
        raise ValueError(f"unknown thermostat {thermostat!r}")
    if barostat is not None and not isinstance(barostat, BerendsenBarostatConfig):
        raise ValueError(f"unknown barostat {barostat!r}")
    if barostat is not None and config.spill:
        raise ValueError("barostat + boundary-spill capacity mode is unsupported")

    ns = config.num_slots
    dt_f = _f32(dt)
    half_dt = _f32(np.float32(0.5) * np.float32(dt))
    ndof = 3.0 * config.num_atoms - 3.0  # the integrator conserves the (zeroed) COM momentum
    molecular = coulomb is not None or aux_fn is not None
    use_component_carry = (
        uniform_params is not None and uniform_mass is not None and thermostat is None
        and barostat is None and rebin == "shift" and not molecular
        and extra_forces is None and extra_aux_fn is None
    )

    def kernels(t: torch.Tensor):
        """(stacked force entry, split force entry, wrapper backend) of the
        family that `backend` resolves to for tensors like `t`."""
        family = resolve_dense_backend(
            config, backend, device=t.device, with_coulomb=coulomb is not None, with_excl=aux_fn is not None,
        )
        if family == "cuda_streaming":
            if molecular:
                raise NotImplementedError(
                    "the streaming kernel's molecular terms (K5c) are not ported yet (ROADMAP queue 2); "
                    "pass backend='cuda' for the resident kernel")
            return streaming_kernel.cell_forces_streaming, streaming_kernel.cell_forces_streaming_split, "cuda"
        return cell_kernel.cell_forces, cell_kernel.cell_forces_split, family

    def pair_forces(st: CellDenseState, aux=None, compute_energy=False):
        stacked, _, kb = kernels(st.positions)
        mol = {"coulomb": coulomb, "excl": aux} if molecular else {}
        return stacked(st, model, config, compute_energy=compute_energy, uniform_params=uniform_params,
                       backend=kb, **mol)

    def auxes(st: CellDenseState):
        """The per-rebin (tags, bindings) of a state's slot binding."""
        return (aux_fn(st) if aux_fn is not None else None,
                extra_aux_fn(st) if extra_aux_fn is not None else None)

    def forces_of(st: CellDenseState, aux=None, eaux=None):
        f = pair_forces(st, aux)[0]
        return f if extra_forces is None else f + extra_forces(st, eaux)

    def rebin_fn(st: CellDenseState, forces=None):
        if rebin == "sort":
            return _rebin(st, config, forces)
        return _rebin_shift(st, config, forces, uniform_params, uniform_mass, kernels(st.positions)[2])

    def energy(st: CellDenseState):
        """(potential energy, virial, kinetic energy) as 0-d tensors."""
        aux, eaux = auxes(st)
        _, e, w = pair_forces(st, None if aux is None else aux[:3], compute_energy=True)
        pe = torch.sum(torch.where(st.valid, e, 0.0))
        vir = torch.sum(torch.where(st.valid, w, 0.0))
        if extra_energy is not None:
            pe_x, vir_x = extra_energy(st, eaux)
            pe = pe + pe_x
            vir = vir + vir_x
        ke = 0.5 * torch.sum(
            torch.where(
                st.valid[..., None],
                st.velocities**2 / torch.clamp(st.inv_masses[..., None], min=1e-30),
                0.0,
            )
        )
        return pe, vir, ke

    def blocks_of(num_steps: int, rebin_every: int):
        blocks, rem = divmod(num_steps, rebin_every)
        return [rebin_every] * blocks + ([rem] if rem else []), blocks

    def rollout_component(state: CellDenseState, num_steps: int, rebin_every: int):
        # Leapfrog on per-component (M³, C) arrays: x, y, z, vx, vy, vz and
        # atom_id, plus the rebin-time reference coordinates and the flag.
        _, split, kb = kernels(state.positions)
        box = _box_of(state, config)

        def forces_split(px, py, pz, valid):
            return split(px, py, pz, valid, config, uniform_params=uniform_params, box=box, backend=kb)

        inv_m = np.float32(1.0 / uniform_mass)
        kick_dt = _f32(np.float32(dt) * inv_m)
        half_kick = _f32(np.float32(0.5) * np.float32(dt) * inv_m)
        px, py, pz = (state.positions[..., i].contiguous() for i in range(3))
        vx, vy, vz = (state.velocities[..., i].contiguous() for i in range(3))
        aid = torch.where(state.valid, state.atom_id, ns)
        ovf = state.overflow
        f0 = forces_split(px, py, pz, state.valid)
        vx, vy, vz = vx + half_kick * f0[0], vy + half_kick * f0[1], vz + half_kick * f0[2]
        rx, ry, rz = px, py, pz
        for length in blocks_of(num_steps, rebin_every)[0]:
            fields, valid, ovf = _rebin_shift_core(
                [px, py, pz, vx, vy, vz, aid], aid < ns, ovf, config, kb, box=state.box
            )
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
                fx, fy, fz = forces_split(px, py, pz, valid)
                vx, wx = _comp_add(vx, kick_dt * fx, wx)
                vy, wy = _comp_add(vy, kick_dt * fy, wy)
                vz, wz = _comp_add(vz, kick_dt * fz, wz)
            ovf = ovf | _stale(px - rx, py - ry, pz - rz, valid, config, state.box)
        valid = aid < ns
        ff = forces_split(px, py, pz, valid)
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
            box=state.box,
        )

    def rollout_stacked(state: CellDenseState, num_steps: int, rebin_every: int):
        # Leapfrog: velocities ride half a step ahead inside the rollout, so
        # no force field crosses a rebin; a closing half un-kick re-syncs.
        f0 = forces_of(state, *auxes(state))
        st = state._replace(velocities=state.velocities + half_dt * f0 * state.inv_masses[..., None])
        for length in blocks_of(num_steps, rebin_every)[0]:
            st = rebin_fn(st)
            aux, eaux = auxes(st)
            inv_m = st.inv_masses[..., None]
            pos, vel = st.positions, st.velocities
            comp = torch.zeros_like(pos)
            vcomp = torch.zeros_like(vel)
            for _ in range(length):
                # Kahan-compensated drift and kick: dt·v is ~1e-4 of the
                # coordinate, so a plain += loses about an ulp per step.
                new_pos, comp = _comp_add(pos, dt_f * vel, comp)
                pos = torch.where(st.valid[..., None], new_pos, pos)
                f = forces_of(st._replace(positions=pos), aux, eaux)
                vel, vcomp = _comp_add(vel, dt_f * f * inv_m, vcomp)
            st = st._replace(positions=pos, velocities=vel, step=st.step + length)
            st = st._replace(overflow=st.overflow | _needs_rebin(st, config))
        f_end = forces_of(st, aux, eaux)  # the last block's binding: no rebin since
        return st._replace(velocities=st.velocities - half_dt * f_end * st.inv_masses[..., None])

    def kdk_step(st: CellDenseState, f, rng, aux, eaux):
        """One synced step: velocity-Verlet kick-drift-kick with the CSVR
        rescale after it, or BAOAB Langevin (kick, half drift, exact OU
        solve, half drift, kick).  Empty slots: inv_m = 0, so no noise and
        no motion; the drift never wraps."""
        inv_m = st.inv_masses[..., None]
        if isinstance(thermostat, LangevinConfig):
            kT = thermostat.kB * thermostat.temperature
            c1 = float(np.exp(-thermostat.friction * dt))
            c2 = float(np.sqrt((1.0 - c1 * c1) * kT))
            v = st.velocities + half_dt * f * inv_m
            x = st.positions + half_dt * v
            noise = torch.randn(v.shape, generator=rng, dtype=v.dtype, device=v.device)
            v = c1 * v + c2 * torch.sqrt(inv_m) * noise
            x = torch.where(st.valid[..., None], x + half_dt * v, st.positions)
            st = st._replace(positions=x, velocities=v)
            f = forces_of(st, aux, eaux)
            return st._replace(velocities=v + half_dt * f * inv_m, step=st.step + 1), f
        v_half = st.velocities + half_dt * f * inv_m
        x = torch.where(st.valid[..., None], st.positions + dt_f * v_half, st.positions)
        st = st._replace(positions=x, velocities=v_half)
        f = forces_of(st, aux, eaux)
        v = v_half + half_dt * f * inv_m
        if isinstance(thermostat, CSVRConfig):
            kin = 0.5 * torch.sum(
                torch.where(st.valid[..., None], v**2 / torch.clamp(inv_m, min=1e-30), 0.0)
            )
            r1, sum_r2 = csvr_draws(rng, ndof, v)
            alpha2 = _csvr_alpha2(
                r1, sum_r2, torch.clamp(kin, min=1e-30), ndof,
                thermostat.kB * thermostat.temperature, dt_f, thermostat.tau,
            )
            v = torch.sqrt(torch.clamp(alpha2, min=0.0)) * v
        return st._replace(velocities=v, step=st.step + 1), f

    def rescale_box(st: CellDenseState, length: int) -> CellDenseState:
        """Berendsen μ-rescale of positions and the state box at a block
        boundary, from the instantaneous pressure (2K + W)/(3V); the forces
        carry over unrescaled (the weak-coupling approximation)."""
        _, vir, ke = energy(st)
        p_inst = (2.0 * ke + vir) / (3.0 * st.box**3)
        mu3 = 1.0 - (length * dt / barostat.tau) * barostat.kappa * (barostat.pressure - p_inst)
        mu = torch.clamp(mu3, 0.9, 1.1) ** (1.0 / 3.0)
        new_box = st.box * mu
        return st._replace(
            positions=st.positions * mu,
            ref_positions=st.ref_positions * mu,
            box=new_box,
            overflow=st.overflow | (new_box < config.cells_per_dim * (config.cutoff + config.skin)),
        )

    def rollout_synced(state: CellDenseState, num_steps: int, rebin_every: int, record: bool, rng):
        if barostat is not None and state.box is None:
            state = state._replace(box=_box(config.box, state.positions).clone())
        st, f = state, forces_of(state, *auxes(state))
        lengths, blocks = blocks_of(num_steps, rebin_every)
        records = []
        for i, length in enumerate(lengths):
            if barostat is not None:
                st = rescale_box(st, length)
            st, f = rebin_fn(st, f)  # the permutation carries the forces along
            aux, eaux = auxes(st)
            for _ in range(length):
                st, f = kdk_step(st, f, rng, aux, eaux)
            st = st._replace(overflow=st.overflow | _needs_rebin(st, config))
            if record and i < blocks:
                records.append((st.step, *energy(st)))
        if not record:
            return st
        return st, (tuple(torch.stack(r) for r in zip(*records)) if records else None)

    def rollout(state: CellDenseState, num_steps: int, rebin_every: int = 10, record: bool = False,
                rng: Optional[torch.Generator] = None):
        """Blocked rollout: rebin every `rebin_every` steps, then run that
        many steps.  The staleness check and the overflow flag stay on the
        device; nothing here waits for the device.

        With record=True, returns (state, records): records holds the
        per-block (step, potential, virial, kinetic) as four (blocks,)
        tensors on the device, for the full-length blocks (None if there
        are none).  rng: a `torch.Generator` on the state's device; a
        thermostatted rollout raises without one, NVE ignores it."""
        if thermostat is not None and rng is None:
            raise ValueError("a thermostatted rollout needs an rng: a torch.Generator on the state's device")
        if thermostat is not None or barostat is not None or record:
            return rollout_synced(state, num_steps, rebin_every, record, rng)
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
    of `cell_dense_init` (charges None for a state without them)."""
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
        "charges": None if state.charges is None else take(state.charges),
    }


def reconfigure_dense_state(
    state: CellDenseState,
    config: CellDenseConfig,
    *,
    cells_multiple_of: int = 1,
    min_cells_per_dim: int = 3,
):
    """Host-side NPT geometry re-derive: (state, old config) → (state',
    config').  Gather every per-atom field from slot layout, re-run
    `suggest_cell_dense_config` at the state's current box, and re-init on
    the state's device — `step` carries over, `overflow` resets, velocities
    and parameters survive exactly.

    cells_multiple_of: round the new cells_per_dim down to this multiple.
    Raises if the box cannot hold `min_cells_per_dim` cells; widens the
    capacity by 8 once if the re-init overflows."""
    n = int(config.num_atoms)
    box_now = float(np.float32(config.box)) if state.box is None else float(state.box)
    fields = gather_dense_fields(state, n)
    new_config = suggest_cell_dense_config(
        n, box_now, config.cutoff, config.switch, config.skin, spill=config.spill
    )
    m = new_config.cells_per_dim
    if cells_multiple_of > 1:
        m = (m // cells_multiple_of) * cells_multiple_of
    if m < max(min_cells_per_dim, cells_multiple_of):
        raise ValueError(
            f"box {box_now:.3f} holds only {m} cells of side ≥ "
            f"{config.cutoff + config.skin} (multiple-of-{cells_multiple_of})"
        )
    new_config = new_config._replace(cells_per_dim=m)
    params = LJParams(half_sigma=fields["half_sigma"], twice_sqrt_eps=fields["twice_sqrt_eps"])
    device = state.positions.device

    def init(cfg):
        return cell_dense_init(
            fields["positions"], fields["velocities"], fields["masses"], params, cfg,
            charges=fields["charges"], device=device,
        )

    new_state = init(new_config)
    if bool(new_state.overflow):
        new_config = new_config._replace(capacity=new_config.capacity + 8)
        new_state = init(new_config)
    return new_state._replace(step=state.step.clone()), new_config
