// Window compaction of the dense-cell shift rebin's spill route, for Hopper
// (sm_90a).
//
// Replaces: emdee_tpu/neighbors/pallas_compact.py `compact_window_pallas` /
// `_make_compact_kernel` (K7), the compaction step of the XLA routing pass
// `_route_axis_pass` (emdee_tpu/neighbors/cell_dense.py), which is the rebin
// of every boundary-spill configuration.  Plain PyTorch version and wrapper:
// emdee_tpu_torch/neighbors/compact_kernel.py (`compact_plain`,
// `compact_stacked`).
//
// What it computes.  Row r of a (rows, 3C) candidate window holds nf fields
// of 32-bit words (float32 viewed as int32: the compaction only copies
// bits).  A kept lane k of row r lands in slot k − s[r, k] of the output row
// — its exclusive rank among the row's kept lanes — when that slot is below
// C; a kept lane of rank ≥ C is dropped (its caller's overflow flag records
// it).  Slots at or beyond the row's kept count take the routing fill: 0 in
// every field but the last, which takes `last_fill` (the atom-id sentinel).
// The window is addressed through strides (field, row; lanes contiguous), so
// the caller's concatenation of cells b−1, b and b+1 needs no copy into a
// field-major layout; the output is (nf, rows, C) with its own strides.
//
// Design.  One warp per row.  Lanes walk the 3C candidates 32 at a time,
// count the kept lanes with a ballot, and copy each kept lane's nf words
// straight to its slot.  Destinations strictly increase along a row, so no
// two lanes write one slot: no atomics and none of the TPU kernel's
// log-shift rounds, which exist because the TPU has no cheap scatter.  Then
// the lanes write the fill into slots count … C−1.  The result is the same
// in every slot on every run.
//
// Bound on this card: pure data movement.  Each launch reads s (4 B) and the
// keep mask (1 B) of every candidate lane and the nf window words of each
// kept lane only, and writes nf words per slot: at the 97,556-atom spill
// config (M = 16, C = 32, 4,096 rows, nf = 7, ~98k kept lanes a pass) about
// 8.4 MB, ~2.5 µs at 3.35 TB/s (chip_smoke.py counts the kept lanes).  A
// row's reads of s and keep are coalesced 128-byte lines; its kept words and
// its writes land in a few lines per field.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void compact_kernel(const int* __restrict__ s,
                               const uint8_t* __restrict__ keep,
                               const int* __restrict__ win,
                               int* __restrict__ out, int rows, int nf, int c,
                               long win_f, long win_r, long out_f, long out_r,
                               int last_fill) {
  const long row = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps only: the row is uniform in a warp
  const int k3 = 3 * c;
  const long lanes = row * k3;
  const int* src_row = win + row * win_r;
  int* dst_row = out + row * out_r;

  int count = 0;
  for (int base = 0; base < k3; base += 32) {
    const int k = base + lane;
    bool kept = false;
    int dest = 0;
    if (k < k3) {
      kept = keep[lanes + k] != 0;
      dest = k - s[lanes + k];
    }
    count += __popc(__ballot_sync(0xffffffffu, kept));
    if (kept && dest >= 0 && dest < c) {
      for (int f = 0; f < nf; ++f) dst_row[f * out_f + dest] = src_row[f * win_f + k];
    }
  }
  for (int slot = count + lane; slot < c; slot += 32) {
    for (int f = 0; f < nf; ++f) dst_row[f * out_f + slot] = f == nf - 1 ? last_fill : 0;
  }
}

}  // namespace

extern "C" int emdee_compact_window(const int* s, const uint8_t* keep, const int* win,
                                    int* out, int rows, int nf, int c, long win_f,
                                    long win_r, long out_f, long out_r, int last_fill,
                                    void* stream) {
  if (rows < 0 || nf < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int threads = 256;  // 8 rows a block
  const long blocks = (static_cast<long>(rows) * 32 + threads - 1) / threads;
  compact_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, keep, win, out, rows, nf, c, win_f, win_r, out_f, out_r, last_fill);
  return static_cast<int>(cudaGetLastError());
}
