// One ±1-cell routing pass of the dense-cell shift rebin, for Hopper (sm_90a).
//
// Replaces: emdee_tpu/neighbors/pallas_rebin.py `_make_pass_kernel` /
// `_one_pass` (K4), called three times per rebin by `rebin_routing_pallas`
// (z, then y, then x).  Plain PyTorch version:
// emdee_tpu_torch/neighbors/cell_dense.py `_route_axis_pass`; wrapper:
// emdee_tpu_torch/neighbors/rebin_kernel.py `rebin_routing`.
//
// Input and output are the nf transported fields stacked as int32 (nf, M³, C)
// (float32 fields viewed as int32: transport only selects and copies bits).
// Positions x, y, z are fields 0-2 and carry the NaN-pattern sentinel
// 0x7FC00000 in empty slots (in-band validity); atom_id is the last field.
//
// Design.  One block per destination cell, one thread per candidate lane
// (3C lanes, rounded up to a warp).  Lane k = seg·C + j reads slot j of
// cell b−1 (seg 0, kept if it moves +1), of the own cell (seg 1, kept if it
// stays) or of cell b+1 (seg 2, kept if it moves −1) along this pass's axis,
// periodically — the candidate order of the reference.  Exclusive arrival
// ranks come from a warp ballot and popcount plus per-warp offsets in
// shared memory; a kept lane of rank r < C copies its nf fields to slot r.
// Slots at or beyond the count take the reference's fill: the sentinel in
// the position fields, num_slots in atom_id, 0 elsewhere.  The sticky flag
// is raised on count > C or on an illegal move (more than one cell) in the
// own cell, and stays on the device.
//
// The target cell is bit-exact with the reference:
// t = clip(floor(m·(s − floor(s))), 0, m−1) with s = coord / box, written
// with round-to-nearest intrinsics so no contraction changes a bit.
//
// Bound on this card: pure data movement — each pass reads a coordinate
// three times and every field about once, and writes every field once:
// about 13 × 4 B × 157,216 slots ≈ 8 MB a pass at the 97,556-atom melt, a few
// microseconds at HBM rate.  Launch latency dominates; fusing the three
// passes needs the neighbor cells' previous-pass output, so it would take a
// grid-wide barrier — left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 0x7FC00000;

__global__ void rebin_pass_kernel(const int* __restrict__ in,
                                  int* __restrict__ out, int* __restrict__ flag,
                                  int nf, int m, int c, int axis, int cf,
                                  int num_slots, float box) {
  __shared__ int warp_count[32];
  const int cell = blockIdx.x;
  const long slots = static_cast<long>(m) * m * m * c;
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;

  // This cell's coordinate and index stride along the pass axis
  // (axis 0 = z, 1 = y, 2 = x; cell id = x + M·(y + M·z)).
  int b, stride;
  if (axis == 0) { b = cell / (m * m); stride = m * m; }
  else if (axis == 1) { b = (cell / m) % m; stride = m; }
  else { b = cell % m; stride = 1; }

  bool keep = false, bad = false;
  long src = 0;
  if (k < 3 * c) {
    const int seg = k / c, j = k - seg * c;
    int bs = b + seg - 1;
    int src_cell = cell + (seg - 1) * stride;
    if (bs < 0) { bs += m; src_cell += m * stride; }
    else if (bs >= m) { bs -= m; src_cell -= m * stride; }
    src = static_cast<long>(src_cell) * c + j;
    const int bits = in[cf * slots + src];
    if (bits != kSentinel) {
      const float s = __fdiv_rn(__int_as_float(bits), box);
      const float w = __fsub_rn(s, floorf(s));
      int t = static_cast<int>(floorf(__fmul_rn(static_cast<float>(m), w)));
      t = min(max(t, 0), m - 1);
      const int d = ((t - bs) % m + m) % m;
      const int want = seg == 0 ? 1 : (seg == 1 ? 0 : m - 1);
      keep = d == want;
      if (seg == 1) bad = !(d == 0 || d == 1 || d == m - 1);
    }
  }

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

  const long base = static_cast<long>(cell) * c;
  if (keep && rank < c) {
    for (int f = 0; f < nf; ++f) out[f * slots + base + rank] = in[f * slots + src];
  }
  if (k < c && k >= count) {
    for (int f = 0; f < nf; ++f)
      out[f * slots + base + k] = f < 3 ? kSentinel : (f == nf - 1 ? num_slots : 0);
  }
  if (k == 0 && (any_bad || count > c)) atomicOr(flag, 1);
}

}  // namespace

extern "C" int emdee_rebin_pass(const int* in, int* out, int* flag, int nf,
                                int m, int c, int axis, int cf, int num_slots,
                                float box, void* stream) {
  const int threads = ((3 * c + 31) / 32) * 32;
  if (m < 3 || c < 1 || threads > 1024 || nf < 4 || axis < 0 || axis > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  rebin_pass_kernel<<<m * m * m, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, flag, nf, m, c, axis, cf, num_slots, box);
  return static_cast<int>(cudaGetLastError());
}
