"""One ±1-cell routing pass over pre-built candidate windows: the CUDA
kernel (K6) and its plain version — counterpart of
emdee_tpu/neighbors/pallas_rebin.py `rebin_window_pass_pallas`, the
grid-sharded engine's rebin pass (`distributed/grid_sharded.py`).

`rebin_window_pass` takes the own cells' fields and their neighbours' one
cell down and up the pass axis, as the caller exchanged them across shard
boundaries, and each row's global cell coordinate along that axis.  For
CUDA tensors, with backend 'auto' or 'cuda', it launches
`csrc/rebin_window.cu` once; for CPU tensors, or backend 'torch', it runs
`rebin_window_plain`: `cell_dense._route_axis_pass` with a window-backed
neighbour, then the kernel's fill.  Both give the same bits in every slot;
on a one-shard grid whose windows are the periodic neighbours they equal
one pass of `rebin_kernel.rebin_routing` (K4).
"""

from __future__ import annotations

import torch

from emdee_tpu_torch.csrc import build
from emdee_tpu_torch.neighbors.cell_dense import _box, _route_axis_pass, box_ptr, resolve_backend
from emdee_tpu_torch.neighbors.rebin_kernel import SENTINEL_BITS

# Kernel launches (one per pass) since import (or a reset to 0).
LAUNCHES = 0


def rebin_window_plain(x, wl, wr, b, box, cf: int, m_global: int, c: int, num_slots: int):
    """The plain version: the own rows and both windows become one set of
    3R rows, with coordinates b, b−1 and b+1, and the neighbour of an own
    row is its window row.  `_route_axis_pass` then computes the window
    rows' masks exactly as the neighbour cells' own, and its output for the
    own rows is kept.  Its flag also sees illegal moves in the window rows:
    those are own cells of this or another shard, so the flag OR'd over the
    shards is the kernel's."""
    nf, planes, rows, _ = x.shape
    r = planes * rows
    ext = torch.cat([x, wl, wr], dim=1).reshape(nf, 3 * r, c)
    bf = b.reshape(r).to(torch.int64)
    b_ext = torch.cat([bf, torch.remainder(bf - 1, m_global), torch.remainder(bf + 1, m_global)])

    def nbr(a, d):
        src = a[r : 2 * r] if d < 0 else a[2 * r :]
        return torch.cat([src, torch.zeros_like(a[r:])])

    fields = [ext[i].view(torch.float32) if i == cf else ext[i] for i in range(nf)]
    valid = ext[cf] != SENTINEL_BITS
    overflow = torch.zeros((), dtype=torch.bool, device=x.device)
    fields, valid, overflow = _route_axis_pass(
        fields, valid, overflow, cf, b_ext, m_global, c, nbr, _box(box, x),
        last_fill=num_slots, backend="torch",
    )
    fill = [SENTINEL_BITS] * 3 + [0] * (nf - 4) + [num_slots]
    out = torch.stack([torch.where(valid[:r], f.view(torch.int32)[:r], v) for f, v in zip(fields, fill)])
    return out.reshape(nf, planes, rows, c), overflow


def rebin_window_pass(x, wl, wr, b, box, cf: int, m_global: int, c: int, num_slots: int,
                      backend: str = "auto"):
    """One routing pass.  x, wl, wr: (nf, planes, rows, C) int32 — the own
    cells, and the cells one down and one up the pass axis — float32 fields
    viewed as int32, positions 0-2 with the `SENTINEL_BITS` pattern in
    empty slots, atom_id last; b: (planes, rows, 1) int32, each row's global
    cell coordinate along the pass axis; box: a number or a 0-d float32
    tensor on the device; cf: the coordinate field binned (x = 0, y = 1,
    z = 2); m_global: the global cell count on the axis.  Returns (out
    (nf, planes, rows, C) int32, overflow as a 0-d bool tensor on the
    device); empty slots hold the fill (sentinel positions, atom_id =
    num_slots, zeros)."""
    if resolve_backend(backend, x) == "torch":
        return rebin_window_plain(x, wl, wr, b, box, cf, m_global, c, num_slots)
    global LAUNCHES
    nf, planes, rows, _ = x.shape
    for name, t in (("x", x), ("wl", wl), ("wr", wr)):
        if t.dtype != torch.int32 or tuple(t.shape) != (nf, planes, rows, c) or t.device != x.device:
            raise ValueError(f"{name}: expected int32 {(nf, planes, rows, c)} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b.dtype != torch.int32 or b.numel() != planes * rows or b.device != x.device or not b.is_contiguous():
        raise ValueError(f"b: expected contiguous int32 ({planes}, {rows}, 1) on {x.device}, "
                         f"got {b.dtype} {tuple(b.shape)} on {b.device}")
    out = torch.empty_like(x)
    flag = torch.zeros((), dtype=torch.int32, device=x.device)
    err = build.load().emdee_rebin_window(
        x.data_ptr(), wl.data_ptr(), wr.data_ptr(), b.data_ptr(), out.data_ptr(), flag.data_ptr(),
        nf, planes * rows, c, cf, m_global, num_slots, box_ptr(box, x),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "rebin_window kernel")
    LAUNCHES += 1
    return out, flag != 0


def periodic_windows(x, m: int, axis: int):
    """The window pass's inputs on one shard holding the whole periodic
    grid: x (nf, M³, C) int32 → (x, wl, wr, b) with planes = M, rows = M²,
    the windows the cells one down and one up grid axis `axis` (0 = z,
    1 = y, 2 = x) and b their coordinate along it."""
    from emdee_tpu_torch.neighbors.cell_dense import _PASSES, _axis_coords, _roll_cells

    off = _PASSES[axis][1]
    cells_first = x.transpose(0, 1)
    shape = (x.shape[0], m, m * m, x.shape[2])

    def nbr(d):
        return _roll_cells(cells_first, tuple(d * o for o in off), m).transpose(0, 1).reshape(shape).contiguous()

    b = _axis_coords(m, x.device)[axis].to(torch.int32).reshape(m, m * m, 1)
    return x.reshape(shape), nbr(-1), nbr(+1), b
