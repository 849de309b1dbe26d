"""The shift rebin's ±1-cell routing passes: the CUDA kernel and its plain
version — counterpart of emdee_tpu/neighbors/pallas_rebin.py.

`rebin_routing` (counterpart of `rebin_routing_pallas`) runs the three
passes (z, then y, then x) over the transported fields.  For CUDA tensors,
with backend 'auto' or 'cuda', it makes one cooperative launch of
`csrc/rebin_routing.cu`, which reads the fields where they lie (strided
views included), parks and wraps the positions on the way when given the
valid mask, and writes one (nf, M³, C) output; the overflow flag stays on
the device.  For CPU tensors, or backend 'torch', it parks and wraps with
torch ops, runs `cell_dense._route_axis_pass` three times and then the
kernel's fill.  Both give the same bits in every slot.
"""

from __future__ import annotations

import ctypes

import torch

from emdee_tpu_torch.csrc import build
from emdee_tpu_torch.neighbors.cell_dense import (
    _PASSES,
    _axis_coords,
    _box,
    _roll_cells,
    _route_axis_pass,
    box_ptr,
    resolve_backend,
)

# Canonical quiet-NaN bit pattern: parks empty slots' position components.
# A real coordinate is never NaN, so the sentinel is unambiguous validity.
SENTINEL_BITS = 0x7FC00000

# Kernel launches (one per rebin) since import (or a reset to 0).
LAUNCHES = 0

# The kernel's limit on the number of routed fields.
MAX_FIELDS = 16


def _parked(fields, valid, box_t, wrap: bool):
    """Positions (fields 0-2) wrapped into [0, L) if `wrap`, and parked at
    the sentinel in empty slots: `_rebin_shift_core`'s park, which the
    kernel does in its first pass."""
    sent = torch.full((), SENTINEL_BITS, dtype=torch.int32, device=box_t.device).view(torch.float32)
    fields = list(fields)
    for i in range(3):
        f = fields[i]
        if wrap:
            f = f - torch.floor(f / box_t) * box_t
        fields[i] = torch.where(valid, f, sent)
    return fields


def _rebin_routing_plain(fields, box, m: int, c: int, num_slots: int, valid=None, wrap: bool = False):
    fields = list(fields)
    dev = fields[0].device
    box_t = _box(box, fields[0])
    if valid is not None:
        fields = _parked(fields, valid, box_t, wrap)
    valid = fields[2].view(torch.int32) != SENTINEL_BITS
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    coord = _axis_coords(m, dev)
    for axis, off, cf in _PASSES:
        nbr = lambda x, d, off=off: _roll_cells(x, tuple(d * o for o in off), m)  # noqa: E731
        fields, valid, overflow = _route_axis_pass(
            fields, valid, overflow, cf, coord[axis], m, c, nbr, box_t
        )
    sentinel = torch.full((), SENTINEL_BITS, dtype=torch.int32, device=dev).view(torch.float32)
    nf = len(fields)
    fill = [sentinel] * 3 + [0] * (nf - 4) + [num_slots]
    return tuple(torch.where(valid, f, v) for f, v in zip(fields, fill)), overflow


def rebin_routing(fields, box, m: int, c: int, num_slots: int, backend: str = "auto", valid=None,
                  wrap: bool = False):
    """All three ±1-cell routing passes.

    fields: tuple of (M³, C) tensors — float32 positions x, y, z first,
    further float32 fields, and the int32 atom_id last; on the card each
    field's rows C slot strides apart (contiguous, or a component view of
    an (M³, C, k) tensor).  valid: the contiguous (M³, C) bool mask of
    live slots, or None when the positions carry the `SENTINEL_BITS`
    pattern in empty slots already; with it, empty slots' positions are
    parked at the sentinel and, with `wrap`, positions are wrapped into
    [0, L) first.  box: a number or a
    0-d float32 tensor on the fields' device (the kernel reads it there).
    Returns (fields, overflow) where overflow is a 0-d bool tensor on the
    fields' device; empty output slots hold the fill (sentinel positions,
    atom_id = num_slots, zeros)."""
    if wrap and valid is None:
        raise ValueError("wrap needs the valid mask")
    if resolve_backend(backend, fields[0]) == "torch":
        return _rebin_routing_plain(fields, box, m, c, num_slots, valid, wrap)
    global LAUNCHES
    nf = len(fields)
    dev = fields[0].device
    shape = (m**3, c)
    if not 4 <= nf <= MAX_FIELDS:
        raise ValueError(f"rebin_routing: {nf} fields, the kernel takes 4 to {MAX_FIELDS}")
    for i, f in enumerate(fields):
        want = torch.int32 if i == nf - 1 else torch.float32
        if f.dtype != want or tuple(f.shape) != shape or f.device != dev:
            raise ValueError(
                f"field {i}: expected {want} {shape} on {dev}, got {f.dtype} "
                f"{tuple(f.shape)} on {f.device}"
            )
        if f.stride(0) != c * f.stride(1):
            raise ValueError(f"field {i}: strides {f.stride()}, the kernel needs rows C slot strides apart")
    if valid is not None and (valid.dtype != torch.bool or tuple(valid.shape) != shape
                              or valid.device != dev or not valid.is_contiguous()):
        raise ValueError(f"valid: expected a contiguous bool {shape} on {dev}, got {valid.dtype} "
                         f"{tuple(valid.shape)} on {valid.device}")
    out = torch.empty((nf,) + shape, dtype=torch.int32, device=dev)
    mid = torch.empty_like(out)
    flag = torch.empty((), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * nf)(*(f.data_ptr() for f in fields))
    strides = (ctypes.c_long * nf)(*(f.stride(1) for f in fields))
    err = build.load().emdee_rebin_routing(
        ptrs, strides, nf, None if valid is None else valid.data_ptr(), int(wrap),
        out.data_ptr(), mid.data_ptr(), flag.data_ptr(), m, c, num_slots, box_ptr(box, fields[0]),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "rebin_routing kernel")
    LAUNCHES += 1
    return tuple(out[i].view(torch.float32) for i in range(nf - 1)) + (out[nf - 1],), flag != 0
