// One ±1-cell routing pass of the grid-sharded engine's rebin, for Hopper
// (sm_90a): each shard's own rows, with only the halo planes exchanged.
//
// Replaces: emdee_tpu/neighbors/pallas_rebin.py `rebin_window_pass_pallas`
// (K6; kernel `_make_window_pass_kernel`), called once per axis pass by
// emdee_tpu/distributed/grid_sharded.py `_rebin_local`.  Plain PyTorch
// version: emdee_tpu_torch/neighbors/rebin_window_kernel.py
// `rebin_halo_plain` (the full windows built from the halo planes, then
// `rebin_window_plain`: cell_dense._route_axis_pass with a window-backed
// neighbour); wrapper: the same module's `rebin_halo_pass`.
//
// Inputs: the nf transported fields of the local shards, (sz, sy, sx, mz,
// my, mx, C) slots each, read where they lie through a pointer and a slot
// stride each (float32 fields as their int32 bits; positions first, atom_id
// last); the two halo planes along the pass axis — the layer that
// `mesh.shift` brings from the shard below (lo: its top layer) and from the
// shard above (hi: its bottom layer), (nf, sz, sy, sx, hz, hy, hx, C) with
// the pass axis' extent 1, any strides — or none where the axis holds one
// shard, whose own far layer is then the neighbour; b, each row's GLOBAL cell
// coordinate along the pass axis (rows in (sz, sy, sx, mz, my, mx) order);
// m, the global cell count on that axis.  In the first pass of a rebin
// (`raw`) validity is atom_id < num_slots, in the own rows and the halo
// planes alike, and positions are wrapped x − floor(x/L)·L as they are
// read; later passes read the previous pass's output, whose positions carry
// the NaN-pattern sentinel in empty slots.  The output is (nf, sz, sy, sx,
// mz, my, mx, C) int32 with the routing fill in empty slots.  One launch
// routes every local shard; the exchange between passes runs on the host.
//
// Design.  A warp a destination row, as K4 (`rebin_row.cuh` `route_row`):
// the row's 3C candidates in the reference's order in chunks of 32 slots of
// one segment, three chunks' coordinates loaded at once, one ballot a chunk
// for the exclusive ranks.  Segment 0 reads the row one cell down the pass
// axis, segment 2 the row one cell up: in the shard's own fields where that
// row is local, in the halo plane where the row is the first or last layer
// along the axis — no window of the whole grid is built.  The box is read
// from a 0-d float32 device tensor; the sticky flag is the only atomic.
//
// Bound on this card: pure data movement — each field read once and
// written once: ~12.6 MB a pass at the 97,556-atom melt (nf = 10, 157,216
// slots at M = 17, C = 32), ~3.8 µs at HBM rate.  The row's dependent loads
// set the time, as for K4.
//
// `rebin_window_kernel` keeps the former design — one block of 3C threads
// a row over three pre-built windows of the whole grid, own, one cell down
// and one cell up, each (nf, planes, rows, C) — as the witness that the
// halo mode is bit for bit the pass it replaced; no path of the engine calls
// it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rebin_row.cuh"

namespace {

// A halo plane: field f of slot j of the row at shard (pz, py, px) and
// local cell (lz, ly, lx), the pass axis' coordinate 0, at
// ptr[f·s[0] + pz·s[1] + py·s[2] + px·s[3] + lz·s[4] + ly·s[5] + lx·s[6] +
// j·s[7]].
struct Halo {
  const int* ptr;
  long s[8];
};

// A candidate row: an own row (`halo` null; `off` its first flat slot) or
// a row of a halo plane (`off` its offset there, field 0, slot 0).
struct RowRef {
  const Halo* halo;
  long off;
};

// Threads a block (8 rows at a time), and the blocks an SM that the launch
// bounds ask registers for: 40 warps, so that the 4,913 rows of the
// 97,556-atom melt are all in flight at once.
constexpr int kHaloThreads = 256;
constexpr int kHaloMinBlocks = 5;

// kRaw: the first pass, on the caller's fields through `in`; else the
// previous pass's (nf, rows, C) output at in.ptr[0].
template <bool kRaw>
__global__ void __launch_bounds__(kHaloThreads, kHaloMinBlocks)
rebin_halo_kernel(const __grid_constant__ emdee::Fields in, const __grid_constant__ Halo lo,
                  const __grid_constant__ Halo hi, const int* __restrict__ b, int* out, int* __restrict__ flag,
                  int nf, int sy, int sx, int mz, int my, int mx, int rows, int c, int axis, int cf, int m,
                  int num_slots, const float* __restrict__ box_ptr) {
  const int r = blockIdx.x * (kHaloThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warps only: the row is uniform in a warp
  const float box = *box_ptr;
  const long slots = static_cast<long>(rows) * c;
  int t = r;
  const int lx = t % mx;
  t /= mx;
  const int ly = t % my;
  t /= my;
  const int lz = t % mz;
  t /= mz;  // the shard
  const int px = t % sx;
  t /= sx;
  const int py = t % sy;
  const int pz = t / sy;
  const int l = axis == 0 ? lz : (axis == 1 ? ly : lx);
  const int n = axis == 0 ? mz : (axis == 1 ? my : mx);
  const int step = axis == 0 ? my * mx : (axis == 1 ? mx : 1);
  const int b_row = b[r];
  const auto plane_off = [&](const Halo& h) {
    return pz * h.s[1] + py * h.s[2] + px * h.s[3] + (axis == 0 ? 0 : lz * h.s[4]) +
           (axis == 1 ? 0 : ly * h.s[5]) + (axis == 2 ? 0 : lx * h.s[6]);
  };
  // The rows one cell down and up: own rows, or at the first and last
  // layer the halo planes' rows — the shard's own far layer where the axis
  // holds one shard (no plane given).
  const int down = l > 0 ? -step : (n - 1) * step, up = l < n - 1 ? step : -(n - 1) * step;
  const RowRef below = l > 0 || lo.ptr == nullptr ? RowRef{nullptr, static_cast<long>(r + down) * c}
                                                  : RowRef{&lo, plane_off(lo)};
  const RowRef above = l < n - 1 || hi.ptr == nullptr ? RowRef{nullptr, static_cast<long>(r + up) * c}
                                                      : RowRef{&hi, plane_off(hi)};
  const auto source = [&](int seg, int& bs) {
    bs = b_row + seg - 1;
    if (bs < 0) bs += m;
    else if (bs >= m) bs -= m;
    return seg == 0 ? below : (seg == 1 ? RowRef{nullptr, static_cast<long>(r) * c} : above);
  };
  const int* x = in.ptr[0];
  const auto word = [&](int f, const RowRef& row, int j) {
    if (row.halo != nullptr) return row.halo->ptr[f * row.halo->s[0] + row.off + j * row.halo->s[7]];
    if constexpr (kRaw) return in.ptr[f][(row.off + j) * in.stride[f]];
    return x[f * slots + row.off + j];
  };
  const auto coord = [&](const RowRef& row, int j) {
    if constexpr (!kRaw) return word(cf, row, j);
    return word(nf - 1, row, j) < num_slots ? emdee::wrapped(word(cf, row, j), box) : emdee::kSentinel;
  };
  const auto field = [&](int f, const RowRef& row, int j) {
    const int bits = word(f, row, j);
    return kRaw && f < 3 ? emdee::wrapped(bits, box) : bits;
  };
  if (emdee::route_row(source, coord, field, out + static_cast<long>(r) * c, slots, nf, m, c, num_slots, box) &&
      (threadIdx.x & 31) == 0)
    atomicOr(flag, 1);
}

__global__ void rebin_window_kernel(const int* __restrict__ x, const int* __restrict__ wl,
                                    const int* __restrict__ wr, const int* __restrict__ b,
                                    int* __restrict__ out, int* __restrict__ flag, int nf,
                                    long rows, int c, int cf, int m, int num_slots,
                                    const float* __restrict__ box_ptr) {
  const float box = *box_ptr;
  const long row = blockIdx.x;
  const long fstride = rows * c;
  const int k = threadIdx.x;

  bool keep = false, bad = false;
  const int* src = x;
  if (k < 3 * c) {
    const int seg = k / c, j = k - seg * c;
    const int* win = seg == 0 ? wl : (seg == 1 ? x : wr);
    src = win + row * c + j;
    const int bs = (b[row] + seg - 1 + m) % m;
    emdee::route_lane(src[cf * fstride], box, m, bs, seg, keep, bad);
  }
  emdee::place_row(keep, bad, src, fstride, out + row * c, fstride, nf, c, num_slots, flag);
}

}  // namespace

// ptrs, strides: nf field pointers and element strides between slots (host
// arrays; without `raw`, the fields of one contiguous (nf, rows, C) block);
// lo, hi: the halo planes (both null where the axis holds one shard), lo_s,
// hi_s their eight strides (host arrays); b: (rows,) int32; out: (nf, rows, C) int32; flag: a 0-d int32 the
// launch raises (never zeroes); shape: sz, sy, sx, mz, my, mx (host
// int[6]).
extern "C" int emdee_rebin_halo(const void* ptrs, const long* strides, int nf, const int* lo, const long* lo_s,
                                const int* hi, const long* hi_s, const int* b, int* out, int* flag,
                                const int* shape, int c, int axis, int cf, int m, int num_slots, int raw,
                                const float* box, void* stream) {
  const long rows = static_cast<long>(shape[0]) * shape[1] * shape[2] * shape[3] * shape[4] * shape[5];
  if (m < 3 || c < 1 || nf < 4 || nf > emdee::kMaxFields || axis < 0 || axis > 2 || cf < 0 || cf > 2 ||
      rows < 1 || rows > 0x7fffffffL - kHaloThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  emdee::Fields in{};
  for (int f = 0; f < nf; ++f) {
    in.ptr[f] = static_cast<const int* const*>(ptrs)[f];
    in.stride[f] = strides[f];
  }
  Halo h_lo{lo, {}}, h_hi{hi, {}};
  for (int i = 0; i < 8; ++i) {
    h_lo.s[i] = lo_s[i];
    h_hi.s[i] = hi_s[i];
  }
  const int rows_a_block = kHaloThreads / 32;
  const unsigned blocks = static_cast<unsigned>((rows + rows_a_block - 1) / rows_a_block);
  const auto kernel = raw ? rebin_halo_kernel<true> : rebin_halo_kernel<false>;
  kernel<<<blocks, kHaloThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, h_lo, h_hi, b, out, flag, nf, shape[1], shape[2], shape[3], shape[4], shape[5], static_cast<int>(rows), c,
      axis, cf, m, num_slots, box);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int emdee_rebin_window(const int* x, const int* wl, const int* wr, const int* b,
                                  int* out, int* flag, int nf, long rows, int c, int cf,
                                  int m, int num_slots, const float* box, void* stream) {
  const int threads = ((3 * c + 31) / 32) * 32;
  if (m < 3 || c < 1 || threads > 1024 || nf < 4 || cf < 0 || cf > 2 || rows < 1 ||
      rows > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  rebin_window_kernel<<<static_cast<unsigned>(rows), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, wl, wr, b, out, flag, nf, rows,
                                                             c, cf, m, num_slots, box);
  return static_cast<int>(cudaGetLastError());
}
