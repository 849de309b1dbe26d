"""Streaming half-shell force pass (K5, and K5c with the molecular terms):
the CUDA kernel and its plain version — counterpart of
`pallas_cell_forces_streaming` and `pallas_cell_forces_streaming_split`
(emdee_tpu/neighbors/pallas_cell_kernel.py).

The TPU engine switches to its streaming kernel when the resident kernel's
VMEM estimate passes 13 MB (`cell_dense.resolve_dense_backend`), which puts
the 1,000,188-atom melt and the 98,304-atom water box here.
`cell_forces_streaming` takes the stacked state (per-atom or uniform
parameters, optional per-slot ½E and ½W) and, with `coulomb=`/`excl=`, the
molecular terms (K5c: DSF Coulomb over the state's charges, exclusion tags,
tag-borne bonds); `cell_forces_streaming_split` takes (M³, C) component
arrays with uniform parameters, forces only.  For CUDA tensors (backend 'auto' or 'cuda') each
call makes two launches of `csrc/cell_forces_streaming.cu`: the half-shell
pair pass, which writes centre sums and four reaction row groups, and the
fold that adds the groups in a fixed order.  For CPU tensors, or backend
'torch', they run the plain version: the half shell of
`cell_dense._dense_forces`, the same as the resident kernel's (with the
molecular terms, `cell_dense_forces(coulomb=, excl=)`, K2c's).
"""

from __future__ import annotations

import torch

from emdee_tpu_torch.csrc import build
from emdee_tpu_torch.neighbors.cell_dense import (
    CellDenseConfig,
    CellDenseState,
    _box_of,
    box_ptr,
    cell_dense_forces,
    resolve_backend,
)
from emdee_tpu_torch.neighbors.cell_kernel import (
    _pair_consts,
    mol_operands,
    split_operands,
    split_plain,
    stacked_operands,
)
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel

# Kernel launches since import (or since a caller reset it to 0): two per
# force evaluation, the pair pass and the fold.
LAUNCHES = 0

MAX_CAPACITY = 96  # three centre slots per lane
_SMEM_BYTES = 232_448  # shared memory a block can use on Hopper
_WARPS = 8
_ROW_GROUPS = 4  # reaction row groups that leave the pair pass


def smem_bytes(config: CellDenseConfig, energy: bool, mol: bool = False, ne: int = 0, neb: int = 0) -> int:
    """A block's shared memory, as the C entry counts it: a pencil's centre
    sums and reaction row, (2, n_r, M·C) float32; each warp's two compacted
    cell tiles (64 entries up to C = 64, else 96; x, y, z, σ/2, 2√ε, with
    the molecular terms q and the atom id, and the slot); with exclusion
    tags, each warp's staged centre tags, 3 values a tag and a bond tag."""
    m, c = config.cells_per_dim, config.capacity
    entries = 64 if c <= 64 else 96
    fields = 7 if mol else 5
    return 4 * (2 * (5 if energy else 3) * m * c + _WARPS * (2 * (fields + 1) * entries + 3 * (ne + neb) * entries))


def _check_geometry(config: CellDenseConfig, energy: bool, mol: bool = False, ne: int = 0, neb: int = 0) -> None:
    """Refuse what the kernel's C entry would refuse, before any launch: M
    ≥ 3, C ≤ MAX_CAPACITY, and the block's shared memory (`smem_bytes`)
    within what Hopper gives a block."""
    m, c = config.cells_per_dim, config.capacity
    smem = smem_bytes(config, energy, mol, ne, neb)
    if m < 3 or c > MAX_CAPACITY or smem > _SMEM_BYTES:
        raise ValueError(
            f"the streaming kernel takes M ≥ 3, C ≤ {MAX_CAPACITY} and a block's shared memory within "
            f"{_SMEM_BYTES} B; got M={m}, C={c} ({smem} B)"
        )


def _launch(px, py, pz, pstride, hs, tse, valid, fx, fy, fz, fstride, e, w,
            config: CellDenseConfig, box, uniform_params, energy: bool) -> None:
    """The pair pass and the fold; `box` is a number or a 0-d float32
    tensor on the device, read there either way (`cell_dense.box_ptr`)."""
    global LAUNCHES
    _check_geometry(config, energy)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    groups = _groups(config, energy, px.device)
    stream = torch.cuda.current_stream(px.device).cuda_stream
    lib = build.load()
    err = lib.emdee_streaming_forces(
        ptr(px), ptr(py), ptr(pz), pstride, ptr(hs), ptr(tse), ptr(valid),
        ptr(fx), ptr(fy), ptr(fz), fstride, ptr(e), ptr(w), ptr(groups),
        config.cells_per_dim, config.capacity, box_ptr(box, px),
        *_pair_consts(config, uniform_params),
        int(uniform_params is not None), int(energy), stream,
    )
    build.check(err, "cell_forces_streaming kernel")
    LAUNCHES += 1
    _fold(lib, fx, fy, fz, fstride, e, w, groups, config, energy, stream)


def _groups(config: CellDenseConfig, energy: bool, device) -> torch.Tensor:
    """The pair pass's reaction row groups, (4, n_r, M³·C) float32."""
    return torch.empty((_ROW_GROUPS, 5 if energy else 3, config.num_slots), dtype=torch.float32, device=device)


def _fold(lib, fx, fy, fz, fstride, e, w, groups, config: CellDenseConfig, energy: bool, stream) -> None:
    """The fold launch: the four row groups added to the outputs in order."""
    global LAUNCHES
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.emdee_streaming_fold(
        ptr(fx), ptr(fy), ptr(fz), fstride, ptr(e), ptr(w), ptr(groups),
        config.num_slots, int(energy), stream,
    )
    build.check(err, "cell_forces_streaming fold")
    LAUNCHES += 1


def cell_forces_streaming(
    state: CellDenseState,
    model: LennardJonesModel,
    config: CellDenseConfig,
    *,
    compute_energy: bool = False,
    uniform_params=None,
    backend: str = "auto",
    coulomb=None,
    excl=None,
):
    """Forces (M³, C, 3) and, with `compute_energy`, per-slot half-split
    energies and virials (M³, C) — else None, None.

    uniform_params: optional (half_sigma, twice_sqrt_eps) floats shared by
    every atom; the kernel then reads no per-atom parameter fields.  The box
    is the state's (`state.box`, read on the device, else config.box).

    coulomb (a `DSFCoulomb` model, the state carrying charges) and excl
    (slot-space tags (ids, mlj, mcs[, (kb, kr0, kr02)]), contiguous, E ≤
    `cell_kernel.MAX_TAGS`) select the molecular kernel (K5c), which reads
    the per-atom parameters; its plain version is K2c's,
    `cell_dense_forces(state, model, config, coulomb, excl)`."""
    if resolve_backend(backend, state.positions) == "torch":
        return cell_dense_forces(state, model, config, coulomb, excl, compute_energy=compute_energy)
    if coulomb is not None or excl is not None:
        return _launch_mol(state, config, coulomb, excl, compute_energy)
    operands, outputs = stacked_operands(state, config, uniform_params, compute_energy)
    _launch(*operands, config, _box_of(state, config), uniform_params, compute_energy)
    return outputs


def _launch_mol(state: CellDenseState, config: CellDenseConfig, coulomb, excl, compute_energy: bool):
    """The molecular pair pass (K5c) and the fold on a CUDA state."""
    global LAUNCHES
    operands, (forces, e, w) = stacked_operands(state, config, None, compute_energy)
    pos, hs, tse, valid = operands[0], operands[4], operands[5], operands[6]
    q, aid, ids, mlj, mcs, kb, kr0, kr02, ne, neb, *consts = mol_operands(state, config, coulomb, excl)
    _check_geometry(config, compute_energy, True, ne, neb)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    groups = _groups(config, compute_energy, pos.device)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    lib = build.load()
    err = lib.emdee_streaming_forces_mol(
        pos.data_ptr(), ptr(hs), ptr(tse), valid.data_ptr(), ptr(q), ptr(aid), ptr(ids), ptr(mlj),
        ptr(mcs), ptr(kb), ptr(kr0), ptr(kr02), ne, neb, *map(ptr, consts), forces.data_ptr(), ptr(e),
        ptr(w), groups.data_ptr(), config.cells_per_dim, config.capacity, box_ptr(_box_of(state, config), pos),
        *_pair_consts(config, None)[:8], int(coulomb is not None), int(excl is not None), int(kb is not None),
        int(compute_energy), stream,
    )
    build.check(err, "cell_forces_streaming kernel (molecular)")
    LAUNCHES += 1
    fv = forces.view(-1)
    _fold(lib, fv, fv[1:], fv[2:], 3, e, w, groups, config, compute_energy, stream)
    return forces, e, w


def cell_forces_streaming_split(
    px, py, pz, valid,
    config: CellDenseConfig,
    *,
    uniform_params,
    box=None,
    backend: str = "auto",
):
    """Forces (fx, fy, fz), each (M³, C), from component positions with
    uniform LJ parameters — the component-carry rollout's force call.  box:
    a number, a 0-d float32 tensor on the device, or None for config.box."""
    box = config.box if box is None else box
    if resolve_backend(backend, px) == "torch":
        return split_plain(px, py, pz, valid, config, uniform_params, box)
    operands, outputs = split_operands(px, py, pz, valid, config)
    _launch(*operands, config, box, uniform_params, False)
    return outputs
