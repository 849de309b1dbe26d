// The per-row logic of a spill configuration's routing pass, shared by the
// whole-grid spill route (spill_routing.cu, K7) and the grid-sharded spill
// pass (spill_window.cu, K7-G): a live slot's class, a row's class counts,
// and the routing of one destination row by one warp with boundary spill
// and hold-backs.
//
// The two kernels differ only in where a row lies (K7: a cell of the whole
// grid, read from the caller's fields or the previous pass's output; K7-G:
// an own row of a shard or a row of a halo plane) and in their fill of
// empty slots, so both functions here take a row as an opaque handle and
// read it through the caller's functors.  Every float operation is a
// round-to-nearest intrinsic, bit-exact with the torch ops of
// `cell_dense._route_windows`.
#pragma once

#include <cuda_runtime.h>

namespace emdee {

// A live slot's class along the pass axis.
enum : int { kNone = 0, kStay, kPlus, kMinus, kIllegal };

// The class of a slot whose coordinate bits are `bits`, in a row at
// coordinate bs, and whether it is near the +face; `live` false gives
// kNone.
__device__ __forceinline__ int classify(bool live, int bits, float box, int m, int bs, float threshold,
                                        bool& near) {
  near = false;
  if (!live) return kNone;
  const float s = __fdiv_rn(__int_as_float(bits), box);
  const float ms = __fmul_rn(static_cast<float>(m), __fsub_rn(s, floorf(s)));
  int t = static_cast<int>(floorf(ms));
  t = min(max(t, 0), m - 1);
  near = __fsub_rn(ms, static_cast<float>(t)) > threshold;
  int d = t - bs;  // (t − bs) mod m: both lie in [0, m)
  if (d < 0) d += m;
  return d == 0 ? kStay : (d == 1 ? kPlus : (d == m - 1 ? kMinus : kIllegal));
}

// A row's class counts: +1 movers, stayers, −1 movers, near-face stayers
// (spill candidates), near-face −1 movers (hold candidates).
struct Counts {
  int plus, stay, minus, near_stay, near_minus;
};

// The class counts of row `row` at coordinate bs, warp uniform.
// live(row, j): whether slot j is live; word(f, row, j): its bits in field
// f (read only for live slots).
template <class Row, class Live, class Word>
__device__ __forceinline__ Counts count_row(Row row, Live live, Word word, int c, int bs, int cf, float box, int m,
                                            float threshold) {
  Counts k{0, 0, 0, 0, 0};
  for (int j0 = 0; j0 < c; j0 += 32) {
    const int j = j0 + (threadIdx.x & 31);
    const bool lv = j < c && live(row, j);
    bool near;
    const int cls = classify(lv, lv ? word(cf, row, j) : 0, box, m, bs, threshold, near);
    k.plus += __popc(__ballot_sync(0xffffffffu, cls == kPlus));
    k.stay += __popc(__ballot_sync(0xffffffffu, cls == kStay));
    k.minus += __popc(__ballot_sync(0xffffffffu, cls == kMinus));
    k.near_stay += __popc(__ballot_sync(0xffffffffu, cls == kStay && near));
    k.near_minus += __popc(__ballot_sync(0xffffffffu, cls == kMinus && near));
  }
  return k;
}

// Route destination row q with one warp into `out` (field f at
// out[f·slots + slot]); `k` holds the class counts of rows q−2 … q+2.
// source(seg, bs) gives the handle of segment seg's source row (0: q−1,
// 1: q, 2: q+1) and sets its global coordinate bs along the pass axis;
// live and word as `count_row`; fill(f) is field f's value in an empty
// slot.  Sets `count` to the row's kept count and returns, uniformly over
// the warp, whether the row raises the flag (an illegal move among q's own
// slots, or a count above C).
template <class Source, class Live, class Word, class Fill>
__device__ __forceinline__ bool spill_row(Source source, Live live, Word word, Fill fill, const Counts* k, int* out,
                                          long slots, int nf, int m, int c, int cf, float box, int target,
                                          float threshold, int& count) {
  const int lane = threadIdx.x & 31;
  const unsigned before = (1u << lane) - 1u;
  // excess and room of rows q−1, q, q+1 (index 0, 1, 2).
  int excess[3], room[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int count0 = k[i].plus + k[i + 1].stay + k[i + 2].minus;
    excess[i] = max(count0 - target, 0);
    room[i] = max(target - count0, 0);
  }
  // Spills out of a row (n_plus) and holds in the row above it (n_hold),
  // decided by rows q−1 and q.
  int spills[2], holds[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    spills[i] = min(min(excess[i], room[i + 1]), k[i + 1].near_stay);
    holds[i] = min(min(excess[i] - spills[i], room[i + 1] - spills[i]), k[i + 2].near_minus);
  }

  count = 0;
  bool bad_any = false;
  for (int seg = 0; seg < 3; ++seg) {
    int bs;
    const auto src = source(seg, bs);
    int ranked_stay = 0, ranked_minus = 0;  // the row's near-face stayers and −1 movers so far
    for (int j0 = 0; j0 < c; j0 += 32) {
      const int j = j0 + lane;
      const bool lv = j < c && live(src, j);
      const int bits = lv ? word(cf, src, j) : 0;
      bool near;
      const int cls = classify(lv, bits, box, m, bs, threshold, near);
      const bool near_stay = cls == kStay && near, near_minus = cls == kMinus && near;
      const unsigned ballot_stay = __ballot_sync(0xffffffffu, near_stay);
      const unsigned ballot_minus = __ballot_sync(0xffffffffu, near_minus);
      // In-cell exclusive ranks among the row's spill and hold candidates.
      const int rank_stay = ranked_stay + __popc(ballot_stay & before);
      const int rank_minus = ranked_minus + __popc(ballot_minus & before);
      ranked_stay += __popc(ballot_stay);
      ranked_minus += __popc(ballot_minus);
      bool keep, seam = false;
      if (seg == 0) {  // row q−1: its +1 movers and its spills
        const bool spill = near_stay && rank_stay < spills[0];
        keep = cls == kPlus || spill;
        seam = spill && bs == m - 1;
      } else if (seg == 1) {  // row q: its stayers but its spills, and its holds
        const bool spill = near_stay && rank_stay < spills[1];
        const bool hold = near_minus && rank_minus < holds[0];
        keep = (cls == kStay && !spill) || hold;
        seam = hold && bs == 0;
        bad_any |= __any_sync(0xffffffffu, cls == kIllegal);
      } else {  // row q+1: its −1 movers but its holds
        keep = cls == kMinus && !(near_minus && rank_minus < holds[1]);
      }
      const unsigned kept = __ballot_sync(0xffffffffu, keep);
      const int rank = count + __popc(kept & before);
      if (keep && rank < c) {
        int* __restrict__ dst = out + rank;
        for (int f = 0; f < nf; ++f) {
          int v = f == cf ? bits : word(f, src, j);
          if (f == cf && seam) v = __float_as_int(__fsub_rn(__int_as_float(v), box));
          dst[f * slots] = v;
        }
      }
      count += __popc(kept);
    }
  }
  for (int j = count + lane; j < c; j += 32)
    for (int f = 0; f < nf; ++f) out[f * slots + j] = fill(f);
  return bad_any || count > c;
}

}  // namespace emdee
