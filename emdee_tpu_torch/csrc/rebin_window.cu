// One ±1-cell routing pass over pre-built candidate windows, for Hopper
// (sm_90a): the grid-sharded engine's rebin pass.
//
// Replaces: emdee_tpu/neighbors/pallas_rebin.py `rebin_window_pass_pallas`
// (K6; kernel `_make_window_pass_kernel`), called once per axis pass by
// emdee_tpu/distributed/grid_sharded.py `_rebin_local`.  Plain PyTorch
// version: emdee_tpu_torch/neighbors/rebin_window_kernel.py
// `rebin_window_plain` (cell_dense._route_axis_pass with a window-backed
// neighbour); wrapper: the same module's `rebin_window_pass`.
//
// Inputs: the nf transported fields of the own cells, x, and of their
// neighbours one cell down (wl) and up (wr) along the pass axis, each
// (nf, planes, rows, C) int32 (float32 fields viewed as int32; positions
// carry the NaN-pattern sentinel in empty slots), already exchanged across
// shard boundaries by the caller; b (planes, rows) int32, each row's GLOBAL
// cell coordinate along the pass axis; cf, the coordinate field the pass
// bins on; m, the global cell count on that axis.  A grid-sharded engine
// stacks its shards as planes, so one launch routes every local shard.
//
// Design.  One block per destination row, one thread per candidate lane: the
// lanes of segment 0 read the row's slot in wl (masks at b−1, kept if they
// move +1), segment 1 in x (at b, kept if they stay) and segment 2 in wr (at
// b+1, kept if they move −1) — the reference's masks at b−1, b, b+1
// (pallas_rebin.py:326-330) and its candidate order.  Ranks, placement, fill
// and flag are `rebin_row.cuh`, shared with the whole-grid pass
// (rebin_routing.cu, K4): on a one-shard grid whose windows are the
// periodic neighbours, the two give the same bits in every slot.  The box is
// read from a 0-d float32 device tensor.
//
// Bound on this card: pure data movement — each lane reads its coordinate
// word and, when kept, its nf words; each slot is written once.  At the
// 97,556-atom melt (nf = 10, 157,216 slots at M = 17, C = 32) that is
// ~19 MB a pass counting every window word, a few microseconds at HBM rate,
// against a launch of one 96-thread block per row (latency-bound).

#include <cuda_runtime.h>
#include <stdint.h>

#include "rebin_row.cuh"

namespace {

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
