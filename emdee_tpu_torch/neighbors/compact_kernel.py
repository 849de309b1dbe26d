"""Window compaction of the shift rebin's spill route (K7): the CUDA kernel
and its plain version — counterpart of emdee_tpu/neighbors/pallas_compact.py.

Each destination cell of a routing pass sees 3C candidates — the +1 movers
of cell b−1, its own stayers, the −1 movers of cell b+1 — and keeps those
its masks select; a kept candidate lands in the slot of its exclusive rank
among the kept ones.  `cell_dense._route_axis_pass` builds the masks (with
boundary spill and hold-backs for spill configs) and the shifts s = lane −
rank, and hands every field's (rows, 3C) window to `compact_stacked`.

For CUDA tensors (backend 'auto' or 'cuda') `compact_stacked` launches
`csrc/compact_window.cu` once for all fields of a pass; for CPU tensors, or
backend 'torch', it runs `compact_plain`, one `scatter_` into a dump column.
Both give the same bits in every output slot: kept slots hold the kept
candidates, slots at or beyond the row's kept count hold 0 (the last field
`last_fill`).  Float32 fields ride as int32 views and keep their bits.
"""

from __future__ import annotations

import torch

from emdee_tpu_torch.csrc import build
from emdee_tpu_torch.neighbors.cell_dense import resolve_backend

# Kernel launches since import (or since a caller reset it to 0): one per
# compaction, i.e. per routing pass of the spill route.
LAUNCHES = 0


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
    global LAUNCHES
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
    LAUNCHES += 1
    return out
