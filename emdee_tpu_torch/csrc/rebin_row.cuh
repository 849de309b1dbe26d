// The per-row routing of the shift rebin's ±1-cell passes, shared by the
// whole-grid rebin (rebin_routing.cu, K4) and the window pass
// (rebin_window.cu, K6): a candidate's routing decision and the fill of
// empty slots, and K6's placement of a row by a block.
//
// A block routes one destination row (cell): 3C candidate lanes, rounded up
// to a warp, in the reference's order [cell b−1's +1 movers, the row's
// stayers, cell b+1's −1 movers] (seg 0, 1, 2, slot j within the segment).
// Exclusive arrival ranks come from a warp ballot and popcount plus
// per-warp offsets in shared memory; a kept lane of rank r < C copies its nf
// fields to slot r.  Slots at or beyond the count take the reference's
// fill: the NaN-pattern sentinel in the position fields 0-2, num_slots in
// the last field (atom_id), 0 elsewhere.  The sticky flag is raised on
// count > C or on an illegal move (more than one cell) among the row's own
// atoms, and stays on the device.  K4 ranks the same candidates in the
// same order with a warp per row.
#pragma once

#include <cuda_runtime.h>

namespace emdee {

constexpr int kSentinel = 0x7FC00000;

// The routing decision of one candidate lane: `bits` is its coordinate
// along the pass axis (the sentinel in an empty slot), `bs` the cell
// coordinate it sits in (0 ≤ bs < m), `seg` its segment.  The target cell is
// bit-exact with the reference: t = clip(floor(m·(s − floor(s))), 0, m−1)
// with s = coord / box, written with round-to-nearest intrinsics so that no
// contraction changes a bit.
__device__ __forceinline__ void route_lane(int bits, float box, int m, int bs, int seg,
                                           bool& keep, bool& bad) {
  keep = bad = false;
  if (bits == kSentinel) return;
  const float s = __fdiv_rn(__int_as_float(bits), box);
  const float w = __fsub_rn(s, floorf(s));
  int t = static_cast<int>(floorf(__fmul_rn(static_cast<float>(m), w)));
  t = min(max(t, 0), m - 1);
  int d = t - bs;  // (t − bs) mod m: both lie in [0, m)
  if (d < 0) d += m;
  const int want = seg == 0 ? 1 : (seg == 1 ? 0 : m - 1);
  keep = d == want;
  if (seg == 1) bad = !(d == 0 || d == 1 || d == m - 1);
}

// The fill of an empty slot in field f of nf.
__device__ __forceinline__ int fill_value(int f, int nf, int num_slots) {
  return f < 3 ? kSentinel : (f == nf - 1 ? num_slots : 0);
}

// Place one destination row.  Every thread of the block calls it.  `src`
// points at the lane's candidate slot in field 0 (fields `src_fstride`
// apart), `out` at slot 0 of the row in field 0 (fields `out_fstride`
// apart).
__device__ __forceinline__ void place_row(bool keep, bool bad, const int* __restrict__ src,
                                          long src_fstride, int* __restrict__ out,
                                          long out_fstride, int nf, int c, int num_slots,
                                          int* __restrict__ flag) {
  __shared__ int warp_count[32];
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  const int in_warp = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_count[warp] = __popc(ballot);
  const int any_bad = __syncthreads_or(bad);
  int rank = in_warp, count = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const int n = warp_count[w];
    if (w < warp) rank += n;
    count += n;
  }
  if (keep && rank < c) {
    for (int f = 0; f < nf; ++f) out[f * out_fstride + rank] = src[f * src_fstride];
  }
  if (k < c && k >= count) {
    for (int f = 0; f < nf; ++f)
      out[f * out_fstride + k] = fill_value(f, nf, num_slots);
  }
  if (k == 0 && (any_bad || count > c)) atomicOr(flag, 1);
}

}  // namespace emdee
