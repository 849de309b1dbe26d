"""Streaming half-shell LJ force pass (K5): the CUDA kernel and its plain
version — counterpart of `pallas_cell_forces_streaming` and
`pallas_cell_forces_streaming_split` (emdee_tpu/neighbors/pallas_cell_kernel.py).

The TPU engine switches to its streaming kernel when the resident kernel's
VMEM estimate passes 13 MB (`cell_dense.resolve_dense_backend`), which puts
the 1,000,188-atom melt here.  `cell_forces_streaming` takes the stacked
state (per-atom or uniform parameters, optional per-slot ½E and ½W);
`cell_forces_streaming_split` takes (M³, C) component arrays with uniform
parameters, forces only.  For CUDA tensors (backend 'auto' or 'cuda') each
call makes two launches of `csrc/cell_forces_streaming.cu`: the half-shell
pair pass, which writes centre sums and four reaction row groups, and the
fold that adds the groups in a fixed order.  For CPU tensors, or backend
'torch', they run the plain version: the half shell of
`cell_dense._dense_forces`, the same as the resident kernel's.
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
from emdee_tpu_torch.neighbors.cell_kernel import _pair_consts, split_operands, split_plain, stacked_operands
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel

# Kernel launches since import (or since a caller reset it to 0): two per
# force evaluation, the pair pass and the fold.
LAUNCHES = 0

MAX_CAPACITY = 64  # two centre slots per lane
_SMEM_BYTES = 232_448  # shared memory a block can use on Hopper
_WARP_TILES = 8 * 2 * 6 * 64 * 4  # each of the 8 warps' two compacted cell tiles
_ROW_GROUPS = 4  # reaction row groups that leave the pair pass


def _check_geometry(config: CellDenseConfig, energy: bool) -> None:
    """Refuse what the kernel's C entry would refuse, before any launch: a
    pencil's centre sums and reaction row, (2, n_r, M·C) float32, and the
    warps' tiles must fit a block's shared memory."""
    m, c = config.cells_per_dim, config.capacity
    smem = 4 * 2 * (5 if energy else 3) * m * c + _WARP_TILES
    if m < 3 or c > MAX_CAPACITY or smem > _SMEM_BYTES:
        raise ValueError(
            f"the streaming kernel takes M ≥ 3, C ≤ {MAX_CAPACITY} and a pencil's sums within "
            f"{_SMEM_BYTES} B of shared memory; got M={m}, C={c} ({smem} B)"
        )


def _launch(px, py, pz, pstride, hs, tse, valid, fx, fy, fz, fstride, e, w,
            config: CellDenseConfig, box, uniform_params, energy: bool) -> None:
    """The pair pass and the fold; `box` is a number or a 0-d float32
    tensor on the device, read there either way (`cell_dense.box_ptr`)."""
    global LAUNCHES
    _check_geometry(config, energy)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    n_r = 5 if energy else 3
    groups = torch.empty((_ROW_GROUPS, n_r, config.num_slots), dtype=torch.float32, device=px.device)
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
):
    """Forces (M³, C, 3) and, with `compute_energy`, per-slot half-split
    energies and virials (M³, C) — else None, None.

    uniform_params: optional (half_sigma, twice_sqrt_eps) floats shared by
    every atom; the kernel then reads no per-atom parameter fields.  The box
    is the state's (`state.box`, read on the device, else config.box)."""
    if resolve_backend(backend, state.positions) == "torch":
        return cell_dense_forces(state, model, config, compute_energy=compute_energy)
    operands, outputs = stacked_operands(state, config, uniform_params, compute_energy)
    _launch(*operands, config, _box_of(state, config), uniform_params, compute_energy)
    return outputs


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
