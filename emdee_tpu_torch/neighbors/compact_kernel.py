"""The spill route of the shift rebin (K7): the CUDA kernel and its plain
version — counterpart of emdee_tpu/neighbors/pallas_compact.py, the
compaction step of the reference's spill routing pass.

Each destination cell of a routing pass sees 3C candidates — the +1 movers
of cell b−1, its own stayers, the −1 movers of cell b+1 — and keeps those
its masks select, with boundary spill and hold-backs toward the spill
target; a kept candidate lands in the slot of its exclusive rank among the
kept ones.

`spill_routing` runs the three passes (z, then y, then x) of a spill
config's rebin.  For CUDA tensors, with backend 'auto' or 'cuda', it makes
one cooperative launch of `csrc/spill_routing.cu`, which reads the caller's
fields where they lie, parks and wraps them, decides the masks, spills,
hold-backs and ranks and compacts, every pass; for CPU tensors, or backend
'torch', it runs `spill_route_plain`: the park with torch ops, then
`cell_dense._route_axis_pass` with spill three times, each compacting its
windows through `compact_plain`, one `scatter_` into a dump column.  Both
give the same bits in every output slot: kept slots hold the kept
candidates, slots at or beyond the row's kept count hold 0, num_slots in
the last field (atom_id).

`compact_stacked` is the former K7, the compaction alone of one pass's
windows (`csrc/compact_window.cu`), which `spill_route_plain(compact=
'cuda')` calls behind the torch masks: the in-tree witness of the spill
pass on the card; no engine path calls it.  Float32 fields ride as int32
views and keep their bits.
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
from emdee_tpu_torch.neighbors.rebin_kernel import MAX_FIELDS

# Launches since import (or since a caller reset it to 0) of the spill
# routing kernel (one per rebin) and of the witness compaction (one per
# routing pass of `spill_route_plain(compact='cuda')`).
LAUNCHES = 0
COMPACT_LAUNCHES = 0


def compact_plain(s, keep, win, c: int, last_fill: int = 0):
    """The plain version: (nf, rows, 3C) int32 windows → (nf, rows, C), by
    one scatter of every window lane into slot lane − s, or into a dump
    column C when the lane is not kept or its rank is ≥ C."""
    nf, rows, k = win.shape
    iota = torch.arange(k, device=win.device)
    dest = iota - s.to(torch.int64)
    dest = torch.where(keep & (dest < c), dest, c)
    out = torch.zeros((nf, rows, c + 1), dtype=torch.int32, device=win.device)
    out.scatter_(2, dest.expand(nf, rows, k), win)
    out = out[..., :c].contiguous()
    if last_fill:
        slot = torch.arange(c, device=win.device)
        count = torch.sum(keep, dim=1)
        out[-1] = torch.where(slot[None, :] < count[:, None], out[-1], last_fill)
    return out


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def compact_stacked(s, keep, win, c: int, last_fill: int = 0, backend: str = "auto"):
    """Compact (rows, 3C) candidate windows of nf fields into (rows, C).

    s: (rows, 3C) int32 left-shift distances, lane − rank (0 on junk
    lanes); keep: (rows, 3C) bool, the kept lanes (s alone cannot tell a
    junk lane from a kept lane already at its rank); win: (nf, rows, 3C)
    int32 (float32 fields viewed as int32), any layout whose lanes are
    contiguous.  Returns (nf, rows, C) int32: a kept lane k goes to slot k −
    s[k] when that is < C; slots at or beyond the row's kept count hold 0,
    in the last field `last_fill`."""
    if resolve_backend(backend, win) == "torch":
        return compact_plain(s, keep, win, c, last_fill)
    global COMPACT_LAUNCHES
    nf, rows, k = win.shape
    dev = win.device
    if k != 3 * c or nf < 1:
        raise ValueError(f"windows must be (nf ≥ 1, rows, 3C = {3 * c}), got {tuple(win.shape)}")
    _check(win, "win", torch.int32, (nf, rows, k), dev)
    if win.stride(2) != 1:
        raise ValueError("win: the lanes of a window row must be contiguous")
    for name, t, dtype in (("s", s, torch.int32), ("keep", keep, torch.bool)):
        _check(t, name, dtype, (rows, k), dev)
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((nf, rows, c), dtype=torch.int32, device=dev)
    err = build.load().emdee_compact_window(
        s.data_ptr(), keep.data_ptr(), win.data_ptr(), out.data_ptr(), rows, nf, c,
        win.stride(0), win.stride(1), out.stride(0), out.stride(1), int(last_fill),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "compact_window kernel")
    COMPACT_LAUNCHES += 1
    return out


def spill_route_plain(fields, box, m: int, c: int, num_slots: int, spill, valid, wrap: bool = True,
                      compact: str = "torch"):
    """The plain version of `spill_routing`: positions wrapped into [0, L)
    if `wrap` and parked at 0 in empty slots, then the three
    `cell_dense._route_axis_pass`es with spill, each compacting through
    `compact_stacked` (`compact`: 'torch' the plain version, 'cuda' the
    former compaction kernel — the witness on the card).  Returns (fields,
    valid, overflow)."""
    box_t = _box(box, fields[0])
    fields = list(fields)
    park = torch.zeros((), dtype=torch.float32, device=box_t.device)
    for i in range(3):
        f = fields[i]
        if wrap:
            f = f - torch.floor(f / box_t) * box_t
        fields[i] = torch.where(valid, f, park)
    overflow = torch.zeros((), dtype=torch.bool, device=box_t.device)
    coords = _axis_coords(m, box_t.device)
    for axis, off, cf in _PASSES:
        nbr = lambda x, d, off=off: _roll_cells(x, tuple(d * o for o in off), m)  # noqa: E731
        fields, valid, overflow = _route_axis_pass(
            fields, valid, overflow, cf, coords[axis], m, c, nbr, box_t,
            spill=spill, last_fill=num_slots, backend=compact,
        )
    return fields, valid, overflow


def spill_routing(fields, box, m: int, c: int, num_slots: int, spill, valid, wrap: bool = True,
                  backend: str = "auto"):
    """The spill configs' rebin: all three ±1-cell routing passes with
    boundary spill.

    fields: (M³, C) tensors — float32 positions x, y, z first, further
    float32 fields, the int32 atom_id last; on the card each field's rows C
    slot strides apart (contiguous, or a component view of an (M³, C, k)
    tensor).  valid: the contiguous (M³, C) bool mask of live slots; with
    `wrap`, positions are wrapped into [0, L) first.  spill: (c_t, the
    float32 threshold), as `cell_dense._spill_params` gives them.  box: a
    number or a 0-d float32 tensor on the fields' device.  Returns
    (fields, valid, overflow): valid and overflow (0-d bool) on the
    fields' device; empty slots hold 0, atom_id num_slots."""
    if resolve_backend(backend, fields[0]) == "torch":
        return spill_route_plain(fields, box, m, c, num_slots, spill, valid, wrap)
    global LAUNCHES
    nf = len(fields)
    dev = fields[0].device
    shape = (m**3, c)
    if not 4 <= nf <= MAX_FIELDS:
        raise ValueError(f"spill_routing: {nf} fields, the kernel takes 4 to {MAX_FIELDS}")
    for i, f in enumerate(fields):
        want = torch.int32 if i == nf - 1 else torch.float32
        if f.dtype != want or tuple(f.shape) != shape or f.device != dev:
            raise ValueError(
                f"field {i}: expected {want} {shape} on {dev}, got {f.dtype} {tuple(f.shape)} on {f.device}"
            )
        if f.stride(0) != c * f.stride(1):
            raise ValueError(f"field {i}: strides {f.stride()}, the kernel needs rows C slot strides apart")
    _check(valid, "valid", torch.bool, shape, dev)
    if not valid.is_contiguous():
        raise ValueError("valid must be contiguous")
    target, threshold = spill
    out = torch.empty((nf,) + shape, dtype=torch.int32, device=dev)
    mid = torch.empty_like(out)
    counts = torch.empty((2, m**3), dtype=torch.int32, device=dev)
    scratch = torch.empty((m**3, 5), dtype=torch.int32, device=dev)
    flag = torch.empty((), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * nf)(*(f.data_ptr() for f in fields))
    strides = (ctypes.c_long * nf)(*(f.stride(1) for f in fields))
    err = build.load().emdee_spill_routing(
        ptrs, strides, nf, valid.data_ptr(), int(wrap), out.data_ptr(), mid.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), flag.data_ptr(), m, c, num_slots,
        int(target), float(threshold), box_ptr(box, fields[0]), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "spill_routing kernel")
    LAUNCHES += 1
    routed = [out[i].view(torch.float32) for i in range(nf - 1)] + [out[nf - 1]]
    return routed, out[nf - 1] < num_slots, flag != 0
