"""One ±1-cell routing pass of the grid-sharded engine's rebin: the CUDA
kernels (K6, and K7-G for spill configs) and their plain versions — counterpart of
emdee_tpu/neighbors/pallas_rebin.py `rebin_window_pass_pallas`
(`distributed/grid_sharded.py` calls it three times a rebin).

`rebin_halo_pass` routes the local shards' own rows, with only the halo
planes along the pass axis exchanged: the layer that `mesh.shift` brings
from the shard below and the one from the shard above (`halo_planes`), and
each row's global cell coordinate along that axis.  The first pass of a
rebin (`raw`) reads the transported fields where they lie, parks empty
slots (atom_id = num_slots) and wraps positions.  For CUDA tensors, with
backend 'auto' or 'cuda', it launches `csrc/rebin_window.cu`'s halo kernel
once; for CPU tensors, or backend 'torch', it runs `rebin_halo_plain`: the
park with torch ops, the whole windows built from the halo planes, then
`rebin_window_plain` — `cell_dense._route_axis_pass` with a window-backed
neighbour and the kernel's fill.  Both give the same bits in every slot;
on a one-shard grid they equal one pass of `rebin_kernel.rebin_routing`
(K4).

A spill config's rebin is K7-G (`csrc/spill_window.cu`), counterpart of
the reference's per-shard XLA pass `_route_axis_pass` with `spill_eps`,
whose compaction is emdee_tpu/neighbors/pallas_compact.py
`compact_window_pallas`.  A spill row's keep mask reads the class counts of
the rows two cells down and up the axis.  `spill_grid_rebin` runs the whole
rebin: where every shard of the mesh lies in this process (a `LocalMesh`,
a one-rank `DistMesh`) and the tensors are on the card, one cooperative
launch of all three passes that reads a row's neighbours in the
neighbouring shard in place (plain version `spill_grid_rebin_plain`, for
the tests); on a mesh of several ranks, and on the CPU, three
`spill_halo_pass`es, each one launch (or, on the CPU, `spill_halo_plain`)
over halo planes two layers deep (`halo_planes(..., depth=2)`).

`rebin_window_pass` is the former K6 over three pre-built windows of the
whole grid (own, one cell down, one cell up), kept as the in-tree witness
of the halo kernel; no engine path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from emdee_tpu_torch.csrc import build
from emdee_tpu_torch.neighbors.cell_dense import _box, _route_axis_pass, _route_windows, box_ptr, resolve_backend
from emdee_tpu_torch.neighbors.compact_kernel import compact_plain, spill_route_plain
from emdee_tpu_torch.neighbors.rebin_kernel import MAX_FIELDS, SENTINEL_BITS

# Kernel launches since import (or a reset to 0): the halo kernel's (K6,
# one a pass), K7-G's per-pass form (one a pass) and one-launch form (one a
# rebin), and the witness's.
LAUNCHES = 0
SPILL_LAUNCHES = 0
GRID_SPILL_LAUNCHES = 0
WINDOW_LAUNCHES = 0

# The coordinate field each grid axis bins on (z = 2, y = 1, x = 0).
COORD_OF_AXIS = (2, 1, 0)


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
    global WINDOW_LAUNCHES
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
    WINDOW_LAUNCHES += 1
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


def halo_planes(x, mesh, axis: int, depth: int = 1):
    """The halo planes of a pass along grid axis `axis` (0 = z, 1 = y,
    2 = x): (lo, hi), each (nf, sz, sy, sx, hz, hy, hx, C) int32 with the
    axis' extent `depth` — the top `depth` layers of the shard below and
    the bottom `depth` layers of the shard above, in the grid's order
    (lo: far, then near; hi: near, then far), brought by `mesh.shift` — or
    (None, None) where the axis holds one shard, whose own far layers are
    its neighbours (the grid is periodic).  depth: 1 (K6) or 2 (a spill
    pass, K7-G; a split axis holds at least 2 layers).  x: nf fields of
    (sz, sy, sx, mz, my, mx, C) slots, as a sequence (their planes are
    stacked, float32 fields as their int32 bits) or as one (nf, …) int32
    tensor."""
    if mesh.shape[axis] == 1:
        return None, None
    if isinstance(x, torch.Tensor):
        dim, n = 4 + axis, x.shape[4 + axis]
        lo, hi = x.narrow(dim, n - depth, depth), x.narrow(dim, 0, depth)
    else:
        dim, n = 3 + axis, x[0].shape[3 + axis]
        lo = torch.stack([f.view(torch.int32).narrow(dim, n - depth, depth) for f in x])
        hi = torch.stack([f.view(torch.int32).narrow(dim, 0, depth) for f in x])
    return mesh.shift(lo, axis, -1), mesh.shift(hi, axis, +1)


def global_coords(mesh, local, axis: int) -> torch.Tensor:
    """(shards·mz, my·mx, 1) int32 on the mesh's device: each local row's
    global cell coordinate along grid axis `axis`, rows in (sz, sy, sx, mz,
    my, mx) order; local = (mz, my, mx), the cells of a shard."""
    lead = mesh.local_shape
    loc = local[axis]
    idx = mesh.axis_index(axis)[:, None] * loc + torch.arange(loc, device=mesh.device)
    shape = [1] * 6
    shape[axis], shape[3 + axis] = lead[axis], loc
    full = idx.reshape(shape).expand(tuple(lead) + tuple(local))
    return full.reshape(-1, local[1] * local[2], 1).to(torch.int32).contiguous()


def _parked(fields, box_t, num_slots: int):
    """The first pass's park: positions (fields 0-2) wrapped into [0, L)
    where atom_id (the last field) < num_slots, the sentinel elsewhere; all
    as int32 bits."""
    fields = [f.view(torch.int32) for f in fields]
    valid = fields[-1] < num_slots
    sent = torch.full((), SENTINEL_BITS, dtype=torch.int32, device=box_t.device).view(torch.float32)
    for i in range(3):
        f = fields[i].view(torch.float32)
        fields[i] = torch.where(valid, f - torch.floor(f / box_t) * box_t, sent).view(torch.int32)
    return fields


def whole_windows(xs, lo, hi, axis: int):
    """The former pass's inputs: the own rows of (nf, sz, sy, sx, mz, my,
    mx, C) int32 xs and the whole windows one cell down and up grid axis
    `axis`, built from xs and the halo planes (None: xs's own far layers),
    each (nf, sz·sy·sx·mz, my·mx, C)."""
    dim, n = 4 + axis, xs.shape[4 + axis]
    if lo is None:
        lo, hi = xs.narrow(dim, n - 1, 1), xs.narrow(dim, 0, 1)
    wl = torch.cat([lo, xs.narrow(dim, 0, n - 1)], dim=dim)
    wr = torch.cat([xs.narrow(dim, 1, n - 1), hi], dim=dim)
    nf, sz, sy, sx, mz, my, mx, c = xs.shape
    flat = (nf, sz * sy * sx * mz, my * mx, c)
    return xs.reshape(flat), wl.reshape(flat), wr.reshape(flat)


def rebin_halo_plain(x, lo, hi, b, box, axis: int, m_global: int, c: int, num_slots: int, raw: bool = False,
                     windows: str = "torch"):
    """The plain version of `rebin_halo_pass` (its arguments; without `raw`
    x is the previous pass's (nf, …) output): the park (with `raw`), the
    whole windows (`whole_windows`), then `rebin_window_pass` over them
    (`windows`: 'torch' its plain version, 'cuda' the former kernel — the
    witness on the card).  Returns (out, overflow as a 0-d bool)."""
    box_t = _box(box, x[0])
    xs = torch.stack(_parked(x, box_t, num_slots)) if raw else x
    if raw and lo is not None:
        lo, hi = torch.stack(_parked(lo, box_t, num_slots)), torch.stack(_parked(hi, box_t, num_slots))
    out, ovf = rebin_window_pass(*whole_windows(xs, lo, hi, axis), b, box_t, COORD_OF_AXIS[axis], m_global, c,
                                 num_slots, backend=windows)
    return out.reshape(xs.shape), ovf


def _slot_stride(t: torch.Tensor):
    """The element stride between consecutive slots of `t` when its slots
    lie evenly spaced in flat order, else None."""
    strides = t.stride()
    step, size = strides[-1], 1
    for n, s in zip(reversed(t.shape), reversed(strides)):
        if n != 1 and s != step * size:
            return None
        size *= n
    return step


def _checked_fields(entry: str, x, c: int, raw: bool):
    """The fields of a routing launch (a pass's `x`) checked: (fields, their
    common 7-d shape, each field's element stride between slots)."""
    fields = list(x)
    dev = fields[0].device
    nf = len(fields)
    shape = fields[0].shape
    if not 4 <= nf <= MAX_FIELDS or len(shape) != 7 or shape[-1] != c:
        raise ValueError(f"{entry}: {nf} fields of {tuple(shape)}, the kernel takes 4 to {MAX_FIELDS} fields of "
                         f"(sz, sy, sx, mz, my, mx, {c})")
    if not raw and not (isinstance(x, torch.Tensor) and x.is_contiguous()):
        raise ValueError(f"{entry}: a pass after the first takes the previous pass's contiguous output")
    strides = []
    for i, f in enumerate(fields):
        want = torch.int32 if i == nf - 1 or not raw else torch.float32
        if f.dtype != want or f.shape != shape or f.device != dev:
            raise ValueError(f"field {i}: expected {want} {tuple(shape)} on {dev}, got {f.dtype} {tuple(f.shape)} "
                             f"on {f.device}")
        step = 1 if f.is_contiguous() else _slot_stride(f)
        if step is None:
            raise ValueError(f"field {i}: strides {f.stride()}, the kernel needs its slots evenly spaced")
        strides.append(step)
    return fields, tuple(shape), strides


def _halo_launch(entry: str, x, lo, hi, b, box, axis: int, m_global: int, c: int, num_slots: int, raw: bool,
                 flag, depth: int, extra=()):
    """Check the arguments of a halo pass (`rebin_halo_pass`'s, with halo
    planes `depth` layers deep) and launch the kernel entry `entry`, its
    `extra` arguments before the box.  Returns (out, flag)."""
    fields, shape, strides = _checked_fields(entry, x, c, raw)
    dev = fields[0].device
    nf = len(fields)
    plane = list(shape)
    plane[3 + axis] = depth
    for name, h in (("lo", lo), ("hi", hi)):
        if (lo is None) != (h is None):
            raise ValueError(f"{entry}: give both halo planes or neither")
        if h is not None and (h.dtype != torch.int32 or tuple(h.shape) != (nf, *plane) or h.device != dev):
            raise ValueError(f"{name}: expected int32 {(nf, *plane)} on {dev}, got {h.dtype} {tuple(h.shape)} "
                             f"on {h.device}")
    if lo is None and shape[3 + axis] != m_global:
        raise ValueError(f"{entry}: without halo planes the shard holds the whole axis, {shape[3 + axis]} ≠ "
                         f"{m_global} cells")
    rows = shape[0] * shape[1] * shape[2] * shape[3] * shape[4] * shape[5]
    if b.dtype != torch.int32 or b.numel() != rows or b.device != dev or not b.is_contiguous():
        raise ValueError(f"b: expected {rows} contiguous int32 on {dev}, got {b.dtype} {tuple(b.shape)} on {b.device}")
    out = torch.empty((nf,) + shape, dtype=torch.int32, device=dev)
    if flag is None:
        flag = torch.zeros((), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * nf)(*(f.data_ptr() for f in fields))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    long8 = lambda t: (ctypes.c_long * 8)(*((0,) * 8 if t is None else t.stride()))  # noqa: E731
    err = getattr(build.load(), entry)(
        ptrs, (ctypes.c_long * nf)(*strides), nf, ptr(lo), long8(lo), ptr(hi), long8(hi),
        b.data_ptr(), out.data_ptr(), flag.data_ptr(), (ctypes.c_int * 6)(*shape[:6]), c, axis,
        COORD_OF_AXIS[axis], m_global, num_slots, int(raw), *extra, box_ptr(box, fields[0]),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, entry)
    return out, flag


def _merge_flag(out, ovf, flag):
    """A plain pass's result with its 0-d bool flag OR'd into `flag`."""
    if flag is None:
        return out, ovf.to(torch.int32)
    return out, flag.bitwise_or_(ovf.to(torch.int32))


def rebin_halo_pass(x, lo, hi, b, box, axis: int, m_global: int, c: int, num_slots: int, raw: bool = False,
                    flag=None, backend: str = "auto"):
    """One routing pass along grid axis `axis` (0 = z, 1 = y, 2 = x) of the
    local shards' own rows.

    x: the nf transported fields, each (sz, sy, sx, mz, my, mx, C) — a
    sequence of tensors (with `raw`: float32 positions x, y, z first,
    further float32 fields, the int32 atom_id last, read where they lie, the
    slots of each evenly spaced; empty slots are those with atom_id ≥
    num_slots, and positions are wrapped into [0, L)), or the previous
    pass's (nf, …) int32 output, positions with the `SENTINEL_BITS` pattern
    in empty slots; lo, hi: the halo planes (`halo_planes`), int32, any
    strides, or both None where the axis holds one shard; b: (sz·sy·sx·mz, my·mx, 1) int32, each row's global cell
    coordinate along the axis; box: a number or a 0-d float32 tensor on the
    device; m_global: the global cell count on the axis.  flag: None or a
    0-d int32 tensor on the device that a raised flag is OR'd into (several
    passes can share one).  Returns (out (nf, sz, sy, sx, mz, my, mx, C)
    int32 with the fill in empty slots — sentinel positions, atom_id =
    num_slots, zeros — and the flag as a 0-d int32 tensor, nonzero if
    raised)."""
    global LAUNCHES
    if resolve_backend(backend, list(x)[0]) == "torch":
        return _merge_flag(*rebin_halo_plain(x, lo, hi, b, box, axis, m_global, c, num_slots, raw), flag)
    out = _halo_launch("emdee_rebin_halo", x, lo, hi, b, box, axis, m_global, c, num_slots, raw, flag, 1)
    LAUNCHES += 1
    return out


def spill_halo_plain(x, lo, hi, b, box, axis: int, m_global: int, c: int, num_slots: int, spill, raw: bool = False):
    """The plain version of `spill_halo_pass` (its arguments): the park
    (with `raw`, as `_parked`), then the own rows and the windows one and
    two rows down and up the axis — from the two-layer halo planes, or the
    shard's own far layers where the axis holds one shard — as one set of
    5R rows with their global coordinates, each window row's neighbours its
    next window rows; `cell_dense._route_windows` with spill decides every
    mask there (the five rows a keep mask reads are all present for the
    own rows and the windows one row away), and the own rows are compacted
    with K6's fill.  Only the own rows raise the flag, as in the kernel.
    Returns (out, overflow as a 0-d bool)."""
    box_t = _box(box, x[0])
    xs = torch.stack(_parked(x, box_t, num_slots)) if raw else x
    dim, n = 4 + axis, xs.shape[4 + axis]
    if lo is None:
        lo, hi = xs.narrow(dim, n - 2, 2), xs.narrow(dim, 0, 2)
    elif raw:
        lo, hi = torch.stack(_parked(lo, box_t, num_slots)), torch.stack(_parked(hi, box_t, num_slots))
    ext = torch.cat([lo, xs, hi], dim=dim)
    nf, c_ = xs.shape[0], xs.shape[-1]
    r = xs[0].numel() // c_
    # Row sets: own, one down, one up, two down, two up.
    win = lambda d: ext.narrow(dim, 2 + d, n).reshape(nf, r, c_)  # noqa: E731
    rows = torch.cat([win(0), win(-1), win(1), win(-2), win(2)], dim=1)
    bf = b.reshape(r).to(torch.int64)
    b_ext = torch.remainder(torch.cat([bf, bf - 1, bf + 1, bf - 2, bf + 2]), m_global)

    def nbr(a, d):
        part = [a[k * r : (k + 1) * r] for k in range(5)]
        zero = torch.zeros_like(part[0])
        if d < 0:
            return torch.cat([part[1], part[3], part[0], zero, part[2]])
        return torch.cat([part[2], part[0], part[4], part[1], zero])

    cf = COORD_OF_AXIS[axis]
    fields = [rows[i].view(torch.float32) if i == cf else rows[i] for i in range(nf)]
    valid = rows[cf] != SENTINEL_BITS
    overflow = torch.zeros((), dtype=torch.bool, device=xs.device)
    s, keep, wins, counts, overflow = _route_windows(fields, valid, overflow, cf, b_ext, m_global, c, nbr, box_t,
                                                     spill=spill, own_rows=r)
    out = compact_plain(s[:r], keep[:r], wins[:, :r], c)
    live = torch.arange(c, device=xs.device)[None, :] < counts[:r, None]
    fill = [SENTINEL_BITS] * 3 + [0] * (nf - 4) + [num_slots]
    out = torch.stack([torch.where(live, o, v) for o, v in zip(out, fill)])
    return out.reshape(xs.shape), overflow


def spill_halo_pass(x, lo, hi, b, box, axis: int, m_global: int, c: int, num_slots: int, spill, raw: bool = False,
                    flag=None, backend: str = "auto"):
    """One routing pass of a spill config's grid rebin along grid axis
    `axis`: `rebin_halo_pass`'s arguments and result, with lo, hi the
    two-layer halo planes (`halo_planes(..., depth=2)`) and spill = (c_t,
    the float32 threshold 1 − ε/h) as `cell_dense._spill_params` gives
    them.  For CUDA tensors, with backend 'auto' or 'cuda', one launch of
    `csrc/spill_window.cu` (K7-G); for CPU tensors, or backend 'torch',
    `spill_halo_plain`.  Both give the same bits in every slot and the same
    flag; on a one-shard grid the three passes' live slots equal
    `compact_kernel.spill_routing`'s (K7)."""
    global SPILL_LAUNCHES
    if resolve_backend(backend, list(x)[0]) == "torch":
        return _merge_flag(*spill_halo_plain(x, lo, hi, b, box, axis, m_global, c, num_slots, spill, raw), flag)
    target, threshold = spill
    out = _halo_launch("emdee_spill_halo", x, lo, hi, b, box, axis, m_global, c, num_slots, raw, flag, 2,
                       (int(target), float(threshold)))
    SPILL_LAUNCHES += 1
    return out


def grid_cells(lead, local, device=None) -> torch.Tensor:
    """The shard layout's row permutation: (rows,) int64, the global cell
    (x + M·(y + M·z)) of each row of the (sz, sy, sx, mz, my, mx) layout
    whose lead = (sz, sy, sx) shards hold local = (mz, my, mx) cells each."""
    m = lead[0] * local[0]
    g = [torch.arange(s, device=device)[:, None] * n + torch.arange(n, device=device) for s, n in zip(lead, local)]
    gz = g[0].reshape(lead[0], 1, 1, local[0], 1, 1)
    gy = g[1].reshape(1, lead[1], 1, 1, local[1], 1)
    gx = g[2].reshape(1, 1, lead[2], 1, 1, local[2])
    return ((gz * m + gy) * m + gx).reshape(-1)


def spill_grid_rebin_plain(fields, box, m_global: int, c: int, num_slots: int, spill):
    """The plain version of `spill_grid_rebin`'s one-launch form, stated on
    the whole grid: the shards' rows gathered into the (M³, C) grid by the
    layout's row permutation (`grid_cells`), the three spill passes there
    (`compact_kernel.spill_route_plain`: the park and wrap, then z, y, x),
    K6's fill in the empty slots, and the rows scattered back.  fields: as
    `spill_grid_rebin`'s, every shard of the mesh.  Returns (out (nf, sz,
    sy, sx, mz, my, mx, C) int32, overflow as a 0-d bool)."""
    fields = list(fields)
    nf, shape = len(fields), tuple(fields[0].shape)
    cells = grid_cells(shape[:3], shape[3:6], fields[0].device)
    order = torch.argsort(cells)  # the layout's row of each global cell
    whole = [f.reshape(-1, c)[order] for f in fields]
    routed, valid, overflow = spill_route_plain(whole, box, m_global, c, num_slots, spill, whole[-1] < num_slots)
    fill = [SENTINEL_BITS] * 3 + [0] * (nf - 4) + [num_slots]
    out = torch.stack([torch.where(valid, f.view(torch.int32), v) for f, v in zip(routed, fill)])
    return out[:, cells].reshape((nf,) + shape), overflow


def spill_grid_rebin(fields, mesh, coords, box, m_global: int, c: int, num_slots: int, spill,
                     backend: str = "auto"):
    """A spill config's grid rebin: the three routing passes (z, y, x) with
    boundary spill and hold-backs over the local shards' own rows.

    fields: the nf transported fields, each (sz, sy, sx, mz, my, mx, C) —
    float32 positions x, y, z first, further float32 fields, the int32
    atom_id last (num_slots in empty slots), read where they lie, the slots
    of each evenly spaced; positions are wrapped into [0, L) in the first
    pass.  mesh: the `GridMesh` whose local shards they are; coords: the
    three axes' `global_coords(mesh, local, axis)`, which the per-pass
    route reads (the one-launch form finds a row's coordinate from its
    index); box, m_global, c, num_slots, spill: as `spill_halo_pass`.

    For CUDA tensors, with backend 'auto' or 'cuda', on a mesh whose shards
    all lie in this process (`mesh.local_shape == mesh.shape`): one
    cooperative launch of `csrc/spill_window.cu`'s one-launch form, which
    raises if the card refuses it.  On a mesh of several ranks: three
    `spill_halo_pass` launches with their halo exchanges.  For CPU tensors,
    or backend 'torch': three `spill_halo_plain` passes.  All give the same
    bits in every slot and the same flag, and `spill_grid_rebin_plain` too.
    Returns (out (nf, sz, sy, sx, mz, my, mx, C) int32 with K6's fill in
    empty slots, the flag as a 0-d int32 tensor)."""
    global GRID_SPILL_LAUNCHES
    route = resolve_backend(backend, fields[0])
    if route == "torch" or tuple(mesh.local_shape) != tuple(mesh.shape):
        x, flag = fields, None
        for axis in range(3):
            lo, hi = halo_planes(x, mesh, axis, depth=2)
            x, flag = spill_halo_pass(x, lo, hi, coords[axis], box, axis, m_global, c, num_slots, spill,
                                      raw=axis == 0, flag=flag, backend=route)
        return x, flag
    entry = "emdee_spill_grid_routing"
    fields, shape, strides = _checked_fields(entry, fields, c, True)
    if shape[:3] != tuple(mesh.shape) or any(s * n != m_global for s, n in zip(shape[:3], shape[3:6])):
        raise ValueError(f"{entry}: fields of {shape}, expected every shard of the {tuple(mesh.shape)} mesh "
                         f"over {m_global} cells an axis")
    dev, nf = fields[0].device, len(fields)
    out = torch.empty((nf,) + shape, dtype=torch.int32, device=dev)
    mid = torch.empty_like(out)
    scratch = torch.empty((out[0].numel() // c, 5), dtype=torch.int32, device=dev)
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    target, threshold = spill
    err = build.load().emdee_spill_grid_routing(
        (ctypes.c_void_p * nf)(*(f.data_ptr() for f in fields)), (ctypes.c_long * nf)(*strides), nf,
        out.data_ptr(), mid.data_ptr(), scratch.data_ptr(), flag.data_ptr(), (ctypes.c_int * 6)(*shape[:6]), c,
        m_global, num_slots, int(target), float(threshold), box_ptr(box, fields[0]),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, entry)
    GRID_SPILL_LAUNCHES += 1
    return out, flag


def grid_rebin_witness(fields, mesh, local, box, m_global: int, c: int, num_slots: int):
    """The grid's rebin as it ran before the halo kernel, the witness of its
    three passes: the positions parked and wrapped and every field stacked
    by torch ops, then three passes of the former kernel over whole
    windows, each built by a `torch.cat` of the shifted own layers and the
    exchanged layer.  fields: as the first `rebin_halo_pass`; local: (mz,
    my, mx).  Returns the (nf, …) int32 output and the flag as a 0-d
    bool."""
    box_t = _box(box, fields[0])
    x = torch.stack(_parked(fields, box_t, num_slots))
    flag = torch.zeros((), dtype=torch.bool, device=x.device)
    for axis in range(3):
        lo, hi = halo_planes(x, mesh, axis)
        x, ovf = rebin_halo_plain(x, lo, hi, global_coords(mesh, local, axis), box_t, axis, m_global, c, num_slots,
                                  windows="cuda")
        flag = flag | ovf
    return x, flag
