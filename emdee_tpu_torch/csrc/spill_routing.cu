// The spill route's three ±1-cell routing passes in one launch, for Hopper
// (sm_90a): the rebin of every boundary-spill configuration.
//
// Replaces: emdee_tpu/neighbors/pallas_compact.py `compact_window_pallas` /
// `_make_compact_kernel` (K7), the compaction step of the reference's XLA
// routing pass `_route_axis_pass` (emdee_tpu/neighbors/cell_dense.py,
// spill at :434-496), together with the masks, spill and hold-back
// decisions and ranks that the pass computes around it, three times a
// rebin (z, then y, then x), and the park and wrap of `_rebin_shift_core`
// before them.  Plain PyTorch version: emdee_tpu_torch/neighbors/
// compact_kernel.py `spill_route_plain` (the park, then
// `cell_dense._route_axis_pass` with spill three times, compacting through
// `compact_plain`); wrapper: the same module's `spill_routing`.
//
// What a pass computes, for destination row (cell) q along the pass axis.
// Each live slot of a row r has a class — stays (its true cell t is r),
// moves +1 or −1, or illegal — with t = clip(floor(m·(s − floor(s))), 0,
// m−1), s = coord / box, and it is near the +face when m·(s − floor(s)) − t
// exceeds the float32 threshold 1 − ε/h.  Before spilling, q receives
// count0(q) = plus(q−1) + stay(q) + minus(q+1) atoms; its excess over the
// target c_t is shed by spilling up to n_plus(q) = min(excess(q),
// room(q+1), its near-face stayers) of its near-face stayers into q+1 (the
// first in slot order), and by holding back up to n_hold(q) = min(excess(q)
// − n_plus(q), room(q+1) − n_plus(q), q+1's near-face −1 movers) of q+1's
// near-face −1 movers in q+1 (again the first in slot order), with room(r)
// = max(c_t − count0(r), 0).  A spill out of the row at b = M−1 or a hold
// in the row at b = 0 stores its coordinate less the box.  So q's keep
// mask reads the class counts of rows q−2 … q+2.  Then q's 3C candidates
// [q−1's +1 movers and spills, q's stayers less its spills plus its holds,
// q+1's −1 movers less its holds] are compacted in that order into C slots:
// a kept candidate of exclusive rank r < C lands in slot r, ranks ≥ C are
// dropped and raise the sticky flag, as does an illegal move; slots at or
// beyond the count hold 0 in every field and num_slots in the last
// (atom_id).  The next pass reads the first min(count, C) slots of each row
// as live.
//
// Design.  One cooperative launch of a persistent grid, a warp a
// destination row (K4's layout, `rebin_row.cuh`; the per-row logic in
// `spill_row.cuh`, shared with the grid's spill pass K7-G).  Each pass first has
// every warp count its own row's classes (coordinate words only: one
// ballot a class a chunk of 32 slots) into scratch, five words a row; a
// grid barrier later each warp reads the counts of rows q−2 … q+2 there,
// then takes q's candidates in the reference's order in chunks of 32 slots
// of one segment: a ballot of the near-face stayers and −1 movers gives
// each its exclusive in-cell rank (spill and hold decisions), a ballot of
// the kept candidates their destination ranks, and a kept candidate copies
// its nf fields to its slot.  No lane divides by C, and a row needs no
// barrier.  (Each warp counting the five rows itself, with no scratch and
// no barrier of its own, measured as fast at the 97,556-atom melt and 6%
// slower at 1M.)  A grid barrier separates the passes (caller's fields →
// out → mid → out); each pass's row counts go to `counts` for the next
// pass's validity.  The first pass reads the caller's fields where they lie
// (a pointer and a slot stride each), takes validity from the caller's
// mask and wraps positions x − floor(x/L)·L on the way.  Every float
// operation is a round-to-nearest intrinsic, so no contraction moves a bit
// against the torch ops.  The sticky flag is the only atomic; the box is
// read from a 0-d float32 device tensor.
//
// Bound on this card: pure data movement — the nf fields read once and
// written once, and the valid mask: ~8 MB at the 97,556-atom spill melt
// (nf = 7, 131,072 slots at M = 16, C = 32), under 3 µs at HBM rate.  As
// for K4, the time is set by the dependent loads of a row (coordinates,
// then the kept candidates' fields) and the rows in flight.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rebin_row.cuh"
#include "spill_row.cuh"

namespace cg = cooperative_groups;

namespace {

using emdee::Counts;
using emdee::Fields;

// Where a pass reads: the caller's fields with its valid mask (the first
// pass, which wraps positions when `wrap`), or the previous pass's output
// (field f at prev[f·slots + slot]) with its row counts.  A row is its cell
// index.
struct Source {
  const Fields* f;       // first pass
  const uint8_t* valid;  // first pass
  const int* prev;       // later passes
  const int* count;      // later passes
  long slots;
  int wrap;
  int c;

  __device__ __forceinline__ bool live(int cell, int j) const {
    return valid != nullptr ? valid[static_cast<long>(cell) * c + j] != 0 : j < count[cell];
  }
  __device__ __forceinline__ int word(int field, int cell, int j, float box) const {
    const long slot = static_cast<long>(cell) * c + j;
    if (f == nullptr) return prev[field * slots + slot];
    const int bits = f->ptr[field][slot * f->stride[field]];
    return wrap && field < 3 ? emdee::wrapped(bits, box) : bits;
  }
};

// The class counts of row `cell` at coordinate bs, warp uniform.
__device__ __forceinline__ Counts cell_counts(const Source& in, int cell, int bs, int cf, float box, int m,
                                            float threshold) {
  const auto live = [&](int r, int j) { return in.live(r, j); };
  const auto word = [&](int f, int r, int j) { return in.word(f, r, j, box); };
  return emdee::count_row(cell, live, word, in.c, bs, cf, box, m, threshold);
}

// Route destination row `cell` of a pass along `axis` with one warp into
// `row` (field f at row[f·slots + slot]); `k` holds the class counts of
// rows q−2 … q+2.  Slots at or beyond the count hold 0, num_slots in the
// last field.  Writes the row's count to `count_out` and returns,
// uniformly over the warp, whether the row raises the flag.
__device__ __forceinline__ bool route_cell(const Source& in, const Counts* k, int* row, int* count_out,
                                          long slots, int nf, int m, int axis, int cf, int cell, int num_slots,
                                          float box, int target, float threshold) {
  int b, stride;
  emdee::axis_of(cell, m, axis, b, stride);
  const auto source = [&](int seg, int& bs) { return emdee::cell_at(cell, b, stride, m, seg - 1, bs); };
  const auto live = [&](int r, int j) { return in.live(r, j); };
  const auto word = [&](int f, int r, int j) { return in.word(f, r, j, box); };
  const auto fill = [&](int f) { return f == nf - 1 ? num_slots : 0; };
  int count;
  const bool raised =
      emdee::spill_row(source, live, word, fill, k, row, slots, nf, m, in.c, cf, box, target, threshold, count);
  if ((threadIdx.x & 31) == 0) count_out[cell] = count;
  return raised;
}

// Threads a block (8 rows at a time), and the blocks an SM that the launch
// bounds ask registers for.
constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;

// Each row's five class counts into `scratch` (five words a row), for
// the pass along `axis` that reads `in`.
__device__ __forceinline__ void stage_counts(const Source& in, int* scratch, int m, int axis, int cf,
                                             float box, float threshold) {
  const int rows = m * m * m;
  const int warps = gridDim.x * (kThreads / 32);
  for (int cell = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); cell < rows; cell += warps) {
    int b, stride;
    emdee::axis_of(cell, m, axis, b, stride);
    const Counts k = cell_counts(in, cell, b, cf, box, m, threshold);
    if ((threadIdx.x & 31) == 0) {
      int* w = scratch + 5L * cell;
      w[0] = k.plus;
      w[1] = k.stay;
      w[2] = k.minus;
      w[3] = k.near_stay;
      w[4] = k.near_minus;
    }
  }
}

// One pass along `axis`: every row of this warp's share routed from `in`
// into `out` (nf fields of `slots` words), its counts into `count_out`,
// with the class counts of rows q−2 … q+2 from `scratch`.
__device__ __forceinline__ bool spill_pass(const Source& in, int* out, int* count_out, const int* scratch,
                                           long slots, int nf, int m, int axis, int cf, int num_slots, float box,
                                           int target, float threshold) {
  const int rows = m * m * m;
  const int warps = gridDim.x * (kThreads / 32);
  bool raised = false;
  for (int cell = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); cell < rows; cell += warps) {
    int b, stride;
    emdee::axis_of(cell, m, axis, b, stride);
    Counts k[5];
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      int bs;
      const int* w = scratch + 5L * emdee::cell_at(cell, b, stride, m, r - 2, bs);
      k[r] = Counts{w[0], w[1], w[2], w[3], w[4]};
    }
    raised |= route_cell(in, k, out + static_cast<long>(cell) * in.c, count_out, slots, nf, m, axis, cf, cell,
                        num_slots, box, target, threshold);
  }
  return raised;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
spill_routing_kernel(const __grid_constant__ Fields caller, const uint8_t* __restrict__ valid, int wrap, int* out,
                     int* mid, int* counts, int* scratch, int* __restrict__ flag, int nf, int m, int c,
                     int num_slots, int target, float threshold, const float* __restrict__ box_ptr) {
  const float box = *box_ptr;
  const int rows = m * m * m;
  const long slots = static_cast<long>(rows) * c;
  if (blockIdx.x == 0 && threadIdx.x == 0) *flag = 0;
  cg::grid_group grid = cg::this_grid();
  // The passes' sources: the caller's fields, then out, then mid.
  const Source from_caller{&caller, valid, nullptr, nullptr, slots, wrap, c};
  const Source from_out{nullptr, nullptr, out, counts, slots, 0, c};
  const Source from_mid{nullptr, nullptr, mid, counts + rows, slots, 0, c};
  bool raised = false;
  // One pass along `axis` (coordinate field cf) from `in` into `to`, its
  // row counts into `count_out`.
  const auto pass = [&](const Source& in, int* to, int* count_out, int axis, int cf) {
    stage_counts(in, scratch, m, axis, cf, box, threshold);
    grid.sync();
    raised |= spill_pass(in, to, count_out, scratch, slots, nf, m, axis, cf, num_slots, box, target, threshold);
  };
  pass(from_caller, out, counts, 0, 2);  // z: caller → out
  grid.sync();
  pass(from_out, mid, counts + rows, 1, 1);  // y: out → mid
  grid.sync();
  pass(from_mid, out, counts, 2, 0);  // x: mid → out (the y pass is done reading counts[0 … rows))
  if (__syncthreads_or(raised) && threadIdx.x == 0) atomicOr(flag, 1);
}

// Resident blocks an SM and SMs of the current device: the cooperative grid.
cudaError_t grid_of(int& per_sm, int& sms) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, spill_routing_kernel, kThreads, 0);
  return err;
}

}  // namespace

// ptrs, strides: nf field pointers and element strides between slots (host
// arrays), positions x, y, z first and atom_id last; valid: (M³, C) bool;
// out, mid: (nf, M³, C) int32; counts: (2, M³) int32; scratch: (M³, 5)
// int32; flag: a 0-d int32 the launch zeroes and
// raises; target, threshold: the spill target c_t and the float32 threshold
// 1 − ε/h.
extern "C" int emdee_spill_routing(const void* ptrs, const long* strides, int nf, const uint8_t* valid, int wrap,
                                   int* out, int* mid, int* counts, int* scratch, int* flag, int m,
                                   int c, int num_slots, int target, float threshold, const float* box,
                                   void* stream) {
  if (m < 3 || c < 1 || nf < 4 || nf > emdee::kMaxFields || valid == nullptr || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Fields in{};
  for (int f = 0; f < nf; ++f) {
    in.ptr[f] = static_cast<const int* const*>(ptrs)[f];
    in.stride[f] = strides[f];
  }
  int per_sm = 0, sms = 0;
  cudaError_t err = grid_of(per_sm, sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int rows_a_block = kThreads / 32, needed = (m * m * m + rows_a_block - 1) / rows_a_block;
  const unsigned blocks = static_cast<unsigned>(needed < per_sm * sms ? needed : per_sm * sms);
  void* args[] = {&in,  &valid, &wrap, &out,       &mid,    &counts,    &scratch, &flag,
                  &nf,  &m,     &c,    &num_slots, &target, &threshold, &box};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(spill_routing_kernel), dim3(blocks),
                                    dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// out (int[4]): the cooperative grid — resident blocks an SM, SMs, threads
// a block, rows a block at a time (one a warp).
extern "C" int emdee_spill_routing_attrs(int* out) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = grid_of(per_sm, sms);
  out[0] = per_sm;
  out[1] = sms;
  out[2] = kThreads;
  out[3] = kThreads / 32;
  return static_cast<int>(err);
}
