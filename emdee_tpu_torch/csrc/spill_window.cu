// One ±1-cell routing pass of a spill configuration's rebin on the
// grid-sharded engine, for Hopper (sm_90a): each shard's own rows with
// boundary spill and hold-backs, reading the rows two cells down and up the
// pass axis from halo planes two layers deep.  (K7-G.)
//
// Replaces: emdee_tpu/neighbors/pallas_compact.py `compact_window_pallas`
// (K7), the compaction step of the reference's XLA routing pass
// `_route_axis_pass` with `spill_eps` (emdee_tpu/neighbors/cell_dense.py,
// spill branch at :437-486), which the reference's grid engine runs on each
// shard for a spill configuration (emdee_tpu/distributed/grid_sharded.py
// `_rebin_local`, :1019-1023 and :1074-1078), together with the masks,
// spill and hold-back decisions and ranks around it.  Plain PyTorch
// version: emdee_tpu_torch/neighbors/rebin_window_kernel.py
// `spill_halo_plain` (the park, windows two rows deep each side, then
// `cell_dense._route_windows` with spill and the compaction of the own
// rows); wrapper: the same module's `spill_halo_pass`.
//
// Inputs: K6's (rebin_window.cu `emdee_rebin_halo`) — the nf transported
// fields of the local shards, (sz, sy, sx, mz, my, mx, C) slots each, read
// where they lie through a pointer and a slot stride each (positions
// first, atom_id last); the halo planes along the pass axis, here two
// layers deep, (nf, sz, sy, sx, hz, hy, hx, C) with the pass axis' extent
// 2 — lo: the top two layers of the shard below (far, then near), hi: the
// bottom two layers of the shard above (near, then far) — or none where
// the axis holds one shard, whose own far layers are then the neighbours;
// b, each row's GLOBAL cell coordinate along the pass axis; m, the global
// cell count on it; the spill target c_t and the float32 threshold 1 − ε/h.
// In the first pass (`raw`) validity is atom_id < num_slots and positions
// are wrapped x − floor(x/L)·L as they are read; later passes read the
// previous pass's output, whose positions carry the NaN-pattern sentinel in
// empty slots.  The output is (nf, sz, sy, sx, mz, my, mx, C) int32 with
// K6's fill in empty slots (the sentinel in positions, atom_id =
// num_slots, 0 elsewhere).
//
// Design.  A warp an own row q, as K6.  A spill pass's keep mask for q
// reads the class counts of rows q−2 … q+2 (spill_routing.cu's note), so
// the warp first counts those five rows itself (coordinate words only, one
// ballot a class a chunk of 32 slots), each in place or in a halo plane:
// K7's grid barrier and count scratch cannot cross the ranks of a mesh.
// Then it decides q−1's spills, q's spills and holds and q+1's holds,
// applies the seam shift (the coordinate less L for a spill out of the row
// at global b = M−1 and a hold in the row at b = 0) and compacts q's 3C
// candidates in the reference's order (`spill_row.cuh`, K7's own per-row
// code).  The sticky flag (an illegal move among q's slots, or a count
// above C) is the only atomic; the box is read from a 0-d float32 device
// tensor.  Three launches a rebin, one a pass, with the halo exchange on
// the host between them.
//
// Bound on this card: pure data movement — the nf fields read once and
// written once, plus the halo planes: ~9.2 MB a pass at the 97,556-atom
// spill melt (nf = 9, 131,072 slots at M = 16, C = 32), ~2.7 µs at HBM
// rate.  As for K6 the row's dependent loads set the time, here five rows
// counted before three are routed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rebin_row.cuh"
#include "spill_row.cuh"

namespace {

// A halo plane two layers deep: field f of slot j of the row at shard (pz,
// py, px), local cell (lz, ly, lx) with the pass axis' coordinate the
// layer (0 or 1), at ptr[f·s[0] + pz·s[1] + py·s[2] + px·s[3] + lz·s[4] +
// ly·s[5] + lx·s[6] + j·s[7]].
struct Halo {
  const int* ptr;
  long s[8];
};

// A row: an own row (`halo` null; `off` its first flat slot) or a row of a
// halo plane (`off` its offset there, field 0, slot 0).
struct RowRef {
  const Halo* halo;
  long off;
};

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;

// kRaw: the first pass, on the caller's fields through `in`; else the
// previous pass's (nf, rows, C) output at in.ptr[0].
template <bool kRaw>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spill_halo_kernel(const __grid_constant__ emdee::Fields in, const __grid_constant__ Halo lo,
                  const __grid_constant__ Halo hi, const int* __restrict__ b, int* out, int* __restrict__ flag,
                  int nf, int sy, int sx, int mz, int my, int mx, int rows, int c, int axis, int cf, int m,
                  int num_slots, int target, float threshold, const float* __restrict__ box_ptr) {
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
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
  const auto plane_off = [&](const Halo& h, int layer) {
    return pz * h.s[1] + py * h.s[2] + px * h.s[3] + (axis == 0 ? layer : lz) * h.s[4] +
           (axis == 1 ? layer : ly) * h.s[5] + (axis == 2 ? layer : lx) * h.s[6];
  };
  // The row d ∈ [−2, 2] cells along the axis: an own row, a halo plane's
  // row past the shard's first or last layer, or where the axis holds one
  // shard the own row across the periodic seam.
  const auto row_at = [&](int d) {
    const int ld = l + d;
    if (ld >= 0 && ld < n) return RowRef{nullptr, static_cast<long>(r + d * step) * c};
    if (lo.ptr == nullptr) {
      const int w = ld < 0 ? ld + n : ld - n;
      return RowRef{nullptr, static_cast<long>(r + (w - l) * step) * c};
    }
    return ld < 0 ? RowRef{&lo, plane_off(lo, 2 + ld)} : RowRef{&hi, plane_off(hi, ld - n)};
  };
  RowRef ref[5];
  int bsd[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    ref[i] = row_at(i - 2);
    int bs = b_row + i - 2;
    if (bs < 0) bs += m;
    else if (bs >= m) bs -= m;
    bsd[i] = bs;
  }
  const int* x = in.ptr[0];
  const auto raw_word = [&](int f, const RowRef& row, int j) {
    if (row.halo != nullptr) return row.halo->ptr[f * row.halo->s[0] + row.off + j * row.halo->s[7]];
    if constexpr (kRaw) return in.ptr[f][(row.off + j) * in.stride[f]];
    return x[f * slots + row.off + j];
  };
  const auto live = [&](const RowRef& row, int j) {
    if constexpr (kRaw) return raw_word(nf - 1, row, j) < num_slots;
    return raw_word(cf, row, j) != emdee::kSentinel;
  };
  const auto word = [&](int f, const RowRef& row, int j) {
    const int bits = raw_word(f, row, j);
    return kRaw && f < 3 ? emdee::wrapped(bits, box) : bits;
  };
  emdee::Counts k[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) k[i] = emdee::count_row(ref[i], live, word, c, bsd[i], cf, box, m, threshold);
  const auto source = [&](int seg, int& bs) {
    bs = bsd[seg + 1];
    return ref[seg + 1];
  };
  const auto fill = [&](int f) { return emdee::fill_value(f, nf, num_slots); };
  int count;
  if (emdee::spill_row(source, live, word, fill, k, out + static_cast<long>(r) * c, slots, nf, m, c, cf, box,
                       target, threshold, count) &&
      (threadIdx.x & 31) == 0)
    atomicOr(flag, 1);
}

}  // namespace

// ptrs, strides: nf field pointers and element strides between slots (host
// arrays; without `raw`, the fields of one contiguous (nf, rows, C) block);
// lo, hi: the two-layer halo planes (both null where the axis holds one
// shard), lo_s, hi_s their eight strides (host arrays); b: (rows,) int32;
// out: (nf, rows, C) int32; flag: a 0-d int32 the launch raises (never
// zeroes); shape: sz, sy, sx, mz, my, mx (host int[6]); target, threshold:
// the spill target c_t and the float32 threshold 1 − ε/h.
extern "C" int emdee_spill_halo(const void* ptrs, const long* strides, int nf, const int* lo, const long* lo_s,
                                const int* hi, const long* hi_s, const int* b, int* out, int* flag,
                                const int* shape, int c, int axis, int cf, int m, int num_slots, int raw, int target,
                                float threshold, const float* box, void* stream) {
  const long rows = static_cast<long>(shape[0]) * shape[1] * shape[2] * shape[3] * shape[4] * shape[5];
  const int n = shape[3 + axis];
  if (m < 3 || c < 1 || nf < 4 || nf > emdee::kMaxFields || axis < 0 || axis > 2 || cf < 0 || cf > 2 ||
      rows < 1 || rows > 0x7fffffffL - kThreads || (lo == nullptr) != (hi == nullptr) ||
      (lo != nullptr && n < 2) || (lo == nullptr && n != m))
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
  const int rows_a_block = kThreads / 32;
  const unsigned blocks = static_cast<unsigned>((rows + rows_a_block - 1) / rows_a_block);
  const auto kernel = raw ? spill_halo_kernel<true> : spill_halo_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, h_lo, h_hi, b, out, flag, nf, shape[1], shape[2], shape[3], shape[4], shape[5], static_cast<int>(rows), c,
      axis, cf, m, num_slots, target, threshold, box);
  return static_cast<int>(cudaGetLastError());
}
