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
// segment, so no lane divides by C; it loads three chunks' coordinates at
// once, decides each candidate (`rebin_row.cuh` `route_lane`, shared with
// K6), and a ballot a chunk gives each kept candidate its exclusive rank in
// candidate order, so a row needs no barrier.  A kept candidate of rank
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

constexpr int kMaxFields = 16;

// The caller's fields: a pointer and an element stride between slots each.
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

// Lane k's candidate slot (flat index) for destination `cell`, and the
// coordinate bs of the cell it sits in.
__device__ __forceinline__ long candidate(int cell, int m, int c, int axis, int k, int& seg,
                                          int& bs) {
  int b, stride;
  axis_of(cell, m, axis, b, stride);
  seg = k / c;
  const int j = k - seg * c;
  bs = b + seg - 1;
  int src_cell = cell + (seg - 1) * stride;
  if (bs < 0) { bs += m; src_cell += m * stride; }
  else if (bs >= m) { bs -= m; src_cell -= m * stride; }
  return static_cast<long>(src_cell) * c + j;
}

// x − floor(x/L)·L, each operation rounded on its own, as the torch ops.
__device__ __forceinline__ int wrapped(int bits, float box) {
  const float x = __int_as_float(bits);
  return __float_as_int(__fsub_rn(x, __fmul_rn(floorf(__fdiv_rn(x, box)), box)));
}

// A kept lane's nf fields to its slot.  `dst` is restrict: no load of a
// field waits on the store of the one before.
template <class Field>
__device__ __forceinline__ void copy_fields(Field field, long src, int* __restrict__ dst, long slots,
                                            int nf) {
  for (int f = 0; f < nf; ++f) dst[f * slots] = field(f, src);
}

// Candidate chunks a warp looks at before it ranks them: their coordinate
// loads are issued together.  Three cover the three segments of C ≤ 32.
constexpr int kAhead = 3;

// Route destination row `cell` with one warp into `row` (field f at
// row[f·slots + slot]).  The candidates, k = seg·C + j, are taken in the
// reference's order as chunks of 32 consecutive j of one segment, lane l
// taking j = j0 + l; a kept candidate's exclusive rank is the count of
// kept candidates before it, from one ballot a chunk.  `coord(src)` is a
// candidate slot's coordinate bits along the pass axis (the sentinel in an
// empty slot), `field(f, src)` its bits in field f.  Returns, uniformly
// over the warp, whether the row raises the flag.
template <class Coord, class Field>
__device__ __forceinline__ bool route_row(Coord coord, Field field, int* row, long slots, int nf, int m,
                                          int c, int axis, int cell, int num_slots, float box) {
  const int lane = threadIdx.x & 31;
  const unsigned before = (1u << lane) - 1u;
  int b, stride;
  axis_of(cell, m, axis, b, stride);
  // Segment seg's source cell and its coordinate along the axis.
  const auto source = [&](int seg, int& bs) {
    bs = b + seg - 1;
    int src_cell = cell + (seg - 1) * stride;
    if (bs < 0) { bs += m; src_cell += m * stride; }
    else if (bs >= m) { bs -= m; src_cell -= m * stride; }
    return static_cast<long>(src_cell) * c;
  };
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
      bits[u] = s < 3 && j < c ? coord(source(s, bs) + j) : emdee::kSentinel;
      jj += 32;
      if (jj >= c) { jj = 0; ++s; }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (seg < 3) {  // uniform over the warp
        int bs;
        const long src = source(seg, bs) + j0 + lane;
        bool keep = false, bad = false;
        if (j0 + lane < c) emdee::route_lane(bits[u], box, m, bs, seg, keep, bad);
        const unsigned kept = __ballot_sync(0xffffffffu, keep);
        bad_any |= __any_sync(0xffffffffu, bad);
        const int rank = count + __popc(kept & before);
        if (keep && rank < c) copy_fields(field, src, row + rank, slots, nf);
        count += __popc(kept);
        j0 += 32;
        if (j0 >= c) { j0 = 0; ++seg; }
      }
    }
  }
  for (int j = count + lane; j < c; j += 32)
    for (int f = 0; f < nf; ++f) row[f * slots + j] = emdee::fill_value(f, nf, num_slots);
  return bad_any || count > c;
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
  const auto caller = [&](int f, long src) {
    const int bits = in.ptr[f][src * in.stride[f]];
    return f < 3 && wrap ? wrapped(bits, box) : bits;
  };
  const auto parked = [&](long src) {
    const int bits = in.ptr[2][src * in.stride[2]];
    if (valid != nullptr && !valid[src]) return emdee::kSentinel;
    return wrap ? wrapped(bits, box) : bits;
  };
  bool raised = false;
  for (int cell = first; cell < rows; cell += warps)
    raised |= route_row(parked, caller, out + static_cast<long>(cell) * c, slots, nf, m, c, 0, cell,
                        num_slots, box);
  cg::this_grid().sync();
  // y pass: out → mid.
  const auto from_out = [&](int f, long src) { return out[f * slots + src]; };
  for (int cell = first; cell < rows; cell += warps)
    raised |= route_row([&](long src) { return from_out(1, src); }, from_out,
                        mid + static_cast<long>(cell) * c, slots, nf, m, c, 1, cell, num_slots, box);
  cg::this_grid().sync();
  // x pass: mid → out.
  const auto from_mid = [&](int f, long src) { return mid[f * slots + src]; };
  for (int cell = first; cell < rows; cell += warps)
    raised |= route_row([&](long src) { return from_mid(0, src); }, from_mid,
                        out + static_cast<long>(cell) * c, slots, nf, m, c, 2, cell, num_slots, box);
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
