// The dense-cell shift rebin's three ±1-cell routing passes in one launch,
// for Hopper (sm_90a).
//
// Replaces: emdee_tpu/neighbors/pallas_rebin.py `_make_pass_kernel` /
// `_one_pass` (K4), called three times per rebin by `rebin_routing_pallas`
// (z, then y, then x), together with the park of empty slots and the wrap
// of positions that emdee_tpu/neighbors/cell_dense.py `_rebin_shift_core`
// does before it.  Plain PyTorch version:
// emdee_tpu_torch/neighbors/rebin_kernel.py `_rebin_routing_plain`
// (`cell_dense._route_axis_pass` three times); wrapper: the same module's
// `rebin_routing`.
//
// Fields: nf transported fields of (M³, C) slots, float32 fields moved as
// their int32 bits (transport only selects and copies), positions x, y, z
// first and atom_id last.  The caller's fields are read where they lie,
// each through its pointer and the element stride between slots, so strided
// views of an (M³, C, 3) tensor need no copy.  With a valid mask, empty
// slots' positions are parked at the NaN-pattern sentinel 0x7FC00000 and,
// with `wrap`, positions are wrapped x − floor(x/L)·L (round-to-nearest
// intrinsics, the bits of the torch ops) as the first pass reads them;
// without one, the positions carry the sentinel already (in-band validity).
// The output is (nf, M³, C) int32 with the routing fill in empty slots.
//
// Design.  One cooperative launch of a persistent grid (as many blocks of
// 256 threads as the card keeps resident); each warp routes destination
// rows (cells) by grid stride, a row at a time.  The row's candidates are
// k = seg·C + j: slot j of cell b−1 (seg 0, kept if it moves +1), of the own
// cell (seg 1, kept if it stays) or of cell b+1 (seg 2, kept if it moves
// −1) along the pass axis, periodically — the candidate order of the
// reference.  The warp takes them in that order in chunks of 32 j of one
// segment, so no lane divides by C (`rebin_row.cuh` `route_row`, shared
// with K6); it loads three chunks' coordinates at once, decides each
// candidate (`route_lane`), and a ballot a chunk gives each kept candidate
// its exclusive rank in candidate order, so a row needs no barrier.  A kept candidate of rank
// r < C moves its nf fields to slot r; slots at or beyond the count take
// the fill.  A grid-wide barrier separates the z pass (caller's fields →
// out), the y pass (out → mid) and the x pass (mid → out): each pass routes
// the previous pass's rows whole, as three launches did, so an overflowing
// or illegal intermediate pass comes out the same.  The sticky flag is
// zeroed before the first barrier and raised once per block after the last
// pass; it is the only atomic.  The box is read from a 0-d float32 device
// tensor (the NPT engine's dynamic box, or the static box held on the
// device).
//
// Bound on this card: pure data movement — the nf fields read once and
// written once, and the valid mask: ~9 MB at the 97,556-atom melt (nf = 7,
// 157,216 slots), under 3 µs at HBM rate.  A pass is a chain of dependent
// loads per row (the coordinates, then the kept candidates' fields), so the
// time is set by the rows in flight and the instructions per candidate: a
// warp a row keeps 48 rows an SM in flight where a block of 3C threads a
// row kept 21, and the intermediate rows (4–6 MB a copy at 97,556 atoms)
// stay in the 50 MB L2 between passes.
//
// `emdee_rebin_pass` keeps the former design, one launch per pass over an
// (nf, M³, C) stack, as the witness that the fused launch is bit for bit
// the three passes; no path of the engine calls it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rebin_row.cuh"

namespace cg = cooperative_groups;

namespace {

using emdee::axis_of;
using emdee::Fields;
using emdee::kMaxFields;
using emdee::wrapped;

// Lane k's candidate slot (flat index) for destination `cell`, and the
// coordinate bs of the cell it sits in.
__device__ __forceinline__ long candidate(int cell, int m, int c, int axis, int k, int& seg,
                                          int& bs) {
  int b, stride;
  axis_of(cell, m, axis, b, stride);
  seg = k / c;
  const int j = k - seg * c;
  return static_cast<long>(emdee::cell_at(cell, b, stride, m, seg - 1, bs)) * c + j;
}

// Threads a block (8 rows at a time), and the blocks an SM that the
// launch bounds ask registers for: 48 warps (40 registers; at 64 warps, 32
// registers, the kernel spills and runs slower).
constexpr int kThreads = 256;
constexpr int kMinBlocks = 6;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
rebin_routing_kernel(Fields in, const uint8_t* __restrict__ valid, int wrap, int* out, int* mid,
                     int* __restrict__ flag, int nf, int m, int c, int num_slots,
                     const float* __restrict__ box_ptr) {
  const float box = *box_ptr;
  const int rows = m * m * m;
  const long slots = static_cast<long>(rows) * c;
  const int warps = gridDim.x * (kThreads / 32);
  const int first = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (blockIdx.x == 0 && threadIdx.x == 0) *flag = 0;

  // z pass: the caller's fields → out, parked and wrapped on the way (a
  // kept lane is a live atom, which the park leaves as it is).
  const auto caller = [&](int f, long base, int j) {
    const int bits = in.ptr[f][(base + j) * in.stride[f]];
    return f < 3 && wrap ? wrapped(bits, box) : bits;
  };
  const auto parked = [&](long base, int j) {
    const long src = base + j;
    const int bits = in.ptr[2][src * in.stride[2]];
    if (valid != nullptr && !valid[src]) return emdee::kSentinel;
    return wrap ? wrapped(bits, box) : bits;
  };
  bool raised = false;
  // Route every row of this warp's share along `axis` from `coord` and
  // `field` into `to`.
  const auto pass = [&](int axis, int* to, auto coord, auto field) {
    for (int cell = first; cell < rows; cell += warps) {
      int b, stride;
      axis_of(cell, m, axis, b, stride);
      const auto source = [&](int seg, int& bs) {
        return static_cast<long>(emdee::cell_at(cell, b, stride, m, seg - 1, bs)) * c;
      };
      raised |= emdee::route_row(source, coord, field, to + static_cast<long>(cell) * c, slots, nf, m, c,
                                 num_slots, box);
    }
  };
  pass(0, out, parked, caller);
  cg::this_grid().sync();
  // y pass: out → mid.
  const auto from_out = [&](int f, long base, int j) { return out[f * slots + base + j]; };
  pass(1, mid, [&](long base, int j) { return from_out(1, base, j); }, from_out);
  cg::this_grid().sync();
  // x pass: mid → out.
  const auto from_mid = [&](int f, long base, int j) { return mid[f * slots + base + j]; };
  pass(2, out, [&](long base, int j) { return from_mid(0, base, j); }, from_mid);
  if (__syncthreads_or(raised) && threadIdx.x == 0) atomicOr(flag, 1);
}

// Resident blocks an SM and SMs of the current device: the cooperative grid.
cudaError_t grid_of(int& per_sm, int& sms) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rebin_routing_kernel, kThreads, 0);
  return err;
}

// One pass of the former design: one block per destination row.
__global__ void rebin_pass_kernel(const int* __restrict__ in,
                                  int* __restrict__ out, int* __restrict__ flag,
                                  int nf, int m, int c, int axis, int cf,
                                  int num_slots, const float* __restrict__ box_ptr) {
  const float box = *box_ptr;
  const int cell = blockIdx.x;
  const long slots = static_cast<long>(m) * m * m * c;
  const int k = threadIdx.x;
  bool keep = false, bad = false;
  long src = 0;
  if (k < 3 * c) {
    int seg, bs;
    src = candidate(cell, m, c, axis, k, seg, bs);
    emdee::route_lane(in[cf * slots + src], box, m, bs, seg, keep, bad);
  }
  emdee::place_row(keep, bad, in + src, slots, out + static_cast<long>(cell) * c, slots,
                   nf, c, num_slots, flag);
}

}  // namespace

// ptrs, strides: nf field pointers and element strides between slots (host
// arrays); valid: (M³, C) bool or null; out, mid: (nf, M³, C) int32; flag:
// a 0-d int32 the launch zeroes and raises.
extern "C" int emdee_rebin_routing(const void* ptrs, const long* strides, int nf,
                                   const uint8_t* valid, int wrap, int* out, int* mid, int* flag,
                                   int m, int c, int num_slots, const float* box, void* stream) {
  if (m < 3 || c < 1 || nf < 4 || nf > kMaxFields || (wrap && !valid))
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
  void* args[] = {&in, &valid, &wrap, &out, &mid, &flag, &nf, &m, &c, &num_slots, &box};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(rebin_routing_kernel),
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// out (int[4]): the cooperative grid — resident blocks an SM, SMs, threads
// a block, rows a block at a time (one a warp).
extern "C" int emdee_rebin_routing_attrs(int* out) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = grid_of(per_sm, sms);
  out[0] = per_sm;
  out[1] = sms;
  out[2] = kThreads;
  out[3] = kThreads / 32;
  return static_cast<int>(err);
}

extern "C" int emdee_rebin_pass(const int* in, int* out, int* flag, int nf,
                                int m, int c, int axis, int cf, int num_slots,
                                const float* box, void* stream) {
  const int threads = ((3 * c + 31) / 32) * 32;
  if (m < 3 || c < 1 || threads > 1024 || nf < 4 || axis < 0 || axis > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  rebin_pass_kernel<<<m * m * m, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, flag, nf, m, c, axis, cf, num_slots, box);
  return static_cast<int>(cudaGetLastError());
}
