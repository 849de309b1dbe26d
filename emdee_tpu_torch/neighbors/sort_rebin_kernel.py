"""The sort rebin on the card: the CUDA kernel that `cell_dense._rebin`
launches for CUDA tensors.

`sort_rebin` makes one cooperative launch of `csrc/sort_rebin.cu`: every
live slot's cell key, its place in its new cell's bucket, each bucket put
in the order of its source slots (the stable argsort's order), and every
field gathered into a contiguous output of its own, positions wrapped into
[0, L).  The caller's fields are read where they lie (strided views
included), the box and the sticky flag on the device.  Its plain version is
`cell_dense._rebin` itself on CPU tensors or with backend 'torch'; the two
give the same bits in every slot whenever no cell holds more than C atoms,
and the same flag always.
"""

from __future__ import annotations

import ctypes

import torch

from emdee_tpu_torch.csrc import build
from emdee_tpu_torch.neighbors.cell_dense import CellDenseConfig, CellDenseState, _box_of, box_ptr

# Kernel launches (one per rebin) since import (or a reset to 0).
LAUNCHES = 0

# The kernel's limit on the capacity C (F1's).
MAX_CAPACITY = 1024


def _checked(t: torch.Tensor, name: str, dtype, shape, dev) -> torch.Tensor:
    """`t` if it is a `dtype` tensor of `shape` on `dev` whose rows lie C
    slot strides apart; raise otherwise."""
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
        raise ValueError(f"{name}: expected {dtype} {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(0) != shape[1] * t.stride(1):
        raise ValueError(f"{name}: strides {t.stride()}, the kernel needs rows C slot strides apart")
    return t


def sort_rebin(state: CellDenseState, config: CellDenseConfig, forces: torch.Tensor | None = None):
    """`cell_dense._rebin` in one launch: returns the rebinned state, and
    with `forces` (M³, C, 3) (state, permuted forces).  Every field of the
    new state is a contiguous tensor; `ref_positions` is the new positions."""
    global LAUNCHES
    m, c = config.cells_per_dim, config.capacity
    nc = m**3
    if not 1 <= c <= MAX_CAPACITY:
        raise ValueError(f"capacity {c}: the sort rebin kernel takes 1 to {MAX_CAPACITY} slots a cell")
    if nc * (c + 1) + 1 >= 2**31:
        raise ValueError(f"{nc} cells of {c} slots: the sort rebin kernel indexes slots with 32-bit integers")
    dev = state.positions.device
    vec, row = (nc, c, 3), (nc, c)
    f32 = torch.float32
    sources = [
        _checked(state.positions, "positions", f32, vec, dev),
        _checked(state.velocities, "velocities", f32, vec, dev),
        _checked(state.inv_masses, "inv_masses", f32, row, dev),
        _checked(state.half_sigma, "half_sigma", f32, row, dev),
        _checked(state.twice_sqrt_eps, "twice_sqrt_eps", f32, row, dev),
        _checked(state.atom_id, "atom_id", torch.int32, row, dev),
        None if forces is None else _checked(forces, "forces", f32, vec, dev),
        None if state.charges is None else _checked(state.charges, "charges", f32, row, dev),
    ]
    valid = _checked(state.valid, "valid", torch.bool, row, dev)
    flag = state.overflow
    if flag.dtype != torch.bool or flag.dim() != 0 or flag.device != dev:
        raise ValueError(f"overflow: expected a 0-d bool on {dev}, got {flag.dtype} {tuple(flag.shape)} "
                         f"on {flag.device}")
    if dev.type != "cuda":
        raise ValueError("the sort rebin kernel needs tensors on a CUDA device (cell_dense._rebin runs the plain "
                         "version for CPU tensors)")

    outs = [None if t is None else torch.empty(t.shape, dtype=t.dtype, device=dev) for t in sources]
    valid_out = torch.empty(row, dtype=torch.bool, device=dev)
    flag_out = torch.empty((), dtype=torch.bool, device=dev)
    scratch = torch.empty(nc * (c + 1) + 1, dtype=torch.int32, device=dev)
    n = len(sources)
    ptrs = (ctypes.c_void_p * n)(*(None if t is None else t.data_ptr() for t in sources))
    slot = (ctypes.c_long * n)(*(0 if t is None else t.stride(1) for t in sources))
    word = (ctypes.c_long * n)(*(t.stride(2) if t is not None and t.dim() == 3 else 0 for t in sources))
    dests = (ctypes.c_void_p * n)(*(None if t is None else t.data_ptr() for t in outs))
    err = build.load().emdee_sort_rebin(
        ptrs, slot, word, valid.data_ptr(), valid.stride(1), dests, valid_out.data_ptr(), scratch.data_ptr(),
        flag.data_ptr(), flag_out.data_ptr(), m, c, box_ptr(_box_of(state, config), state.positions),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "sort_rebin kernel")
    LAUNCHES += 1
    pos, vel, im, hs, tse, aid, f, q = outs
    new_state = state._replace(
        positions=pos, velocities=vel, inv_masses=im, half_sigma=hs, twice_sqrt_eps=tse, atom_id=aid,
        valid=valid_out, ref_positions=pos, overflow=flag_out, charges=q,
    )
    return new_state if forces is None else (new_state, f)
