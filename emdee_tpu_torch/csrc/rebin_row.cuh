// The per-row routing of the shift rebin's ±1-cell passes, shared by the
// whole-grid rebin (rebin_routing.cu, K4), the grid's window pass
// (rebin_window.cu, K6) and the spill route (spill_routing.cu, K7): a
// candidate's routing decision, the fill of empty slots, the caller's field
// table, and the routing of one destination row by one warp.
//
// A destination row (cell) has 3C candidates in the reference's order
// [cell b−1's +1 movers, the row's stayers, cell b+1's −1 movers] (seg 0,
// 1, 2, slot j within the segment).  `route_row` takes them with one warp in
// chunks of 32 j of one segment; one ballot a chunk gives each kept
// candidate its exclusive rank, and a kept candidate of rank r < C copies
// its nf fields to slot r.  Slots at or beyond the count take the
// reference's fill: the NaN-pattern sentinel in the position fields 0-2,
// num_slots in the last field (atom_id), 0 elsewhere.  The sticky flag is
// raised on count > C or on an illegal move (more than one cell) among the
// row's own atoms, and stays on the device.  `place_row` is the former
// layout, a block of 3C threads a row, which the witnesses of K4 and K6
// keep.
#pragma once

#include <cuda_runtime.h>

namespace emdee {

constexpr int kSentinel = 0x7FC00000;

// The most fields a routing kernel takes.
constexpr int kMaxFields = 16;

// The caller's fields: a pointer and an element stride between slots each
// (field f of flat slot s at ptr[f][s·stride[f]]), so that strided views of
// an (…, C, k) tensor need no copy.
struct Fields {
  const int* ptr[kMaxFields];
  long stride[kMaxFields];
};

// This cell's coordinate and index stride along the pass axis
// (axis 0 = z, 1 = y, 2 = x; cell id = x + M·(y + M·z)).
__device__ __forceinline__ void axis_of(int cell, int m, int axis, int& b, int& stride) {
  if (axis == 0) { b = cell / (m * m); stride = m * m; }
  else if (axis == 1) { b = (cell / m) % m; stride = m; }
  else { b = cell % m; stride = 1; }
}

// The cell d ∈ [−2, 2] cells from `cell` along the pass axis, periodically
// (m ≥ 3), and its coordinate bs there; b and stride as `axis_of` gives them.
__device__ __forceinline__ int cell_at(int cell, int b, int stride, int m, int d, int& bs) {
  bs = b + d;
  int out = cell + d * stride;
  if (bs < 0) { bs += m; out += m * stride; }
  else if (bs >= m) { bs -= m; out -= m * stride; }
  return out;
}

// x − floor(x/L)·L, each operation rounded on its own, as the torch ops.
__device__ __forceinline__ int wrapped(int bits, float box) {
  const float x = __int_as_float(bits);
  return __float_as_int(__fsub_rn(x, __fmul_rn(floorf(__fdiv_rn(x, box)), box)));
}

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

// A kept candidate's nf fields to its slot.  `dst` is restrict: no load of
// a field waits on the store of the one before.
template <class Field, class Src>
__device__ __forceinline__ void copy_fields(Field field, Src src, int j, int* __restrict__ dst, long slots,
                                            int nf) {
  for (int f = 0; f < nf; ++f) dst[f * slots] = field(f, src, j);
}

// Candidate chunks a warp looks at before it ranks them: their coordinate
// loads are issued together.  Three cover the three segments of C ≤ 32.
constexpr int kAhead = 3;

// Route one destination row with one warp into `row` (field f at
// row[f·slots + slot]).  The candidates, k = seg·C + j, are taken in the
// reference's order as chunks of 32 consecutive j of one segment, lane l
// taking j = j0 + l; a kept candidate's exclusive rank is the count of kept
// candidates before it, from one ballot a chunk.  `source(seg, bs)` names
// segment seg's source row (any value the other two take) and sets its
// coordinate bs along the pass axis; `coord(src, j)` is slot j's
// coordinate bits there (the sentinel in an empty slot), `field(f, src, j)`
// its bits in field f.  Returns, uniformly over the warp, whether the row
// raises the flag.
template <class Source, class Coord, class Field>
__device__ __forceinline__ bool route_row(Source source, Coord coord, Field field, int* row, long slots,
                                          int nf, int m, int c, int num_slots, float box) {
  const int lane = threadIdx.x & 31;
  const unsigned before = (1u << lane) - 1u;
  int count = 0;
  bool bad_any = false;
  int seg = 0, j0 = 0;  // the next chunk
  while (seg < 3) {
    int bits[kAhead];
    int s = seg, jj = j0;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      int bs;
      const int j = jj + lane;
      bits[u] = s < 3 && j < c ? coord(source(s, bs), j) : kSentinel;
      jj += 32;
      if (jj >= c) { jj = 0; ++s; }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (seg < 3) {  // uniform over the warp
        int bs;
        const auto src = source(seg, bs);
        const int j = j0 + lane;
        bool keep = false, bad = false;
        if (j < c) route_lane(bits[u], box, m, bs, seg, keep, bad);
        const unsigned kept = __ballot_sync(0xffffffffu, keep);
        bad_any |= __any_sync(0xffffffffu, bad);
        const int rank = count + __popc(kept & before);
        if (keep && rank < c) copy_fields(field, src, j, row + rank, slots, nf);
        count += __popc(kept);
        j0 += 32;
        if (j0 >= c) { j0 = 0; ++seg; }
      }
    }
  }
  for (int j = count + lane; j < c; j += 32)
    for (int f = 0; f < nf; ++f) row[f * slots + j] = fill_value(f, nf, num_slots);
  return bad_any || count > c;
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
