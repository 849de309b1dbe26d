"""The shift rebin's ±1-cell routing passes: the CUDA kernel and its plain
version — counterpart of emdee_tpu/neighbors/pallas_rebin.py.

`rebin_routing` (counterpart of `rebin_routing_pallas`) runs the three
passes (z, then y, then x) over the transported fields.  For CUDA tensors,
with backend 'auto' or 'cuda', it stacks the fields as int32 once and
launches `csrc/rebin_routing.cu` once per pass, ping-ponging two buffers;
the overflow flag stays on the device.  For CPU tensors, or backend
'torch', it runs `cell_dense._route_axis_pass` three times and then the
kernel's fill.  Both give the same bits in every slot.
"""

from __future__ import annotations

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

# Kernel launches (one per routing pass) since import (or a reset to 0).
LAUNCHES = 0


def _rebin_routing_plain(fields, box, m: int, c: int, num_slots: int):
    fields = list(fields)
    dev = fields[0].device
    box_t = _box(box, fields[0])
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


def rebin_routing(fields, box, m: int, c: int, num_slots: int, backend: str = "auto"):
    """All three ±1-cell routing passes.

    fields: tuple of (M³, C) tensors — float32 positions x, y, z first, with
    the `SENTINEL_BITS` pattern in empty slots, further float32 fields, and
    the int32 atom_id last.  box: a number or a 0-d float32 tensor on the
    fields' device (the kernel reads it there).  Returns (fields, overflow) where overflow is a
    0-d bool tensor on the fields' device; empty output slots hold the fill
    (sentinel positions, atom_id = num_slots, zeros)."""
    if resolve_backend(backend, fields[0]) == "torch":
        return _rebin_routing_plain(fields, box, m, c, num_slots)
    global LAUNCHES
    nf = len(fields)
    dev = fields[0].device
    shape = (m**3, c)
    for i, f in enumerate(fields):
        want = torch.int32 if i == nf - 1 else torch.float32
        if f.dtype != want or tuple(f.shape) != shape or f.device != dev:
            raise ValueError(
                f"field {i}: expected {want} {shape} on {dev}, got {f.dtype} "
                f"{tuple(f.shape)} on {f.device}"
            )
    x = torch.stack([f.view(torch.int32) for f in fields])  # (nf, M³, C), contiguous
    y = torch.empty_like(x)
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    box_p = box_ptr(box, fields[0])
    for axis, _, cf in _PASSES:
        err = lib.emdee_rebin_pass(
            x.data_ptr(), y.data_ptr(), flag.data_ptr(), nf, m, c, axis, cf,
            num_slots, box_p, stream,
        )
        build.check(err, "rebin_routing kernel")
        LAUNCHES += 1
        x, y = y, x
    out = tuple(x[i].view(torch.float32) for i in range(nf - 1)) + (x[nf - 1],)
    return out, flag != 0
