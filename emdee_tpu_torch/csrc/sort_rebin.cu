// The dense-cell sort rebin in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's sort rebin,
// emdee_tpu/neighbors/cell_dense.py `_rebin`, is `jnp.argsort` and
// gathers that XLA compiles.  Plain PyTorch version: emdee_tpu_torch/
// neighbors/cell_dense.py `_rebin` on CPU tensors or with backend 'torch'
// (a stable argsort of the cell keys, `searchsorted` for each cell's start,
// one packed gather of every field and the wrap, ~63 device ops a rebin);
// wrapper: emdee_tpu_torch/neighbors/sort_rebin_kernel.py `sort_rebin`.
//
// What it computes.  Every live source slot s has the cell key x + M(y +
// Mz) of its position, t = clip(floor(M·(q − floor(q))), 0, M−1) with q =
// p/L on each axis.  New cell k takes its atoms in the order of their
// source slots (the stable argsort's order): the atom of rank r in cell k
// lands in slot k·C + r with its fields — positions wrapped p − floor(p/L)·L,
// velocities, 1/m, σ/2, 2√ε, the atom id and, when given, the forces and the
// charges — and the valid mask; slots at or beyond the cell's count hold 0,
// the atom id num_slots.  A cell of more than C atoms raises the sticky
// flag and keeps its first C atoms by source slot, as the argsort does.
//
// Design.  One cooperative launch of a persistent grid, three parts split
// by grid barriers: (0) zero the per-cell counts and the flag; (1) a thread
// a source slot computes its key and takes a place in its cell's bucket of
// C source indices by one atomic on the cell's count, aggregated over the
// lanes of a warp that share the cell (`__match_any_sync`), so that a warp
// of neighbouring slots makes one or two atomics; a place at or beyond C
// raises the flag; (2) a warp a new cell reads its count's bucket
// entries, a lane an entry, gathers the entry's fields, ranks it by the
// entries smaller than it (shuffles; C > 32 in chunks of 32 against chunks
// of 32), so that the atomics' order never shows, and stores the fields in
// the slot of that rank; lanes at or beyond the count write the fill.  A
// cell over C (the flag's case) is found whole by one warp scanning the
// source slots in order, so that even then every slot is the argsort's.
// Each output field is its own contiguous tensor.  Every float operation
// is a round-to-nearest intrinsic (no contraction of floor(·)·L into the
// subtraction, nor of M·w), so the keys and the wrap are the bits of the
// torch ops.  The box is read from a 0-d float32 device tensor (the NPT
// engine's dynamic box, or the static box held on the device); the old
// flag is read and the new one written on the device.  Scratch: nc + 1 +
// nc·C int32 (counts, flag, buckets); the launch zeroes what it reads.
//
// Bound on this card: data movement — each source slot's position and
// valid byte read once (13 B), each live atom's bucket entry written and
// read back (8 B) and its fields gathered once (40 B, 56 with forces and
// charges), every new slot's fields and valid byte written once (41 B,
// 57): ~135 MB at the 1M melt (1,620,896 slots, 1,000,188 atoms), ~40 µs
// at HBM rate.  The buckets (6.5 MB there) and counts stay in the 50 MB L2.
// Part 1 is one coalesced read a slot; part 2 is a dependent chain a cell
// (count and entries, then the gathers, issued together, and the rank),
// so the time is set by the cells in flight: a warp a cell, 32 warps an
// SM (56 registers a thread, 64 allowed).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "rebin_row.cuh"

namespace cg = cooperative_groups;

namespace {

// The transported fields, in this order; a field's words a slot, the
// first of them among a slot's kWords words.
constexpr int kFields = 8, kWords = 14;
constexpr int kPos = 0, kAtomId = 5;
__host__ __device__ constexpr int width(int f) { return f == 0 || f == 1 || f == 6 ? 3 : 1; }
__host__ __device__ constexpr int offset(int f) { return f <= 1 ? 3 * f : (f <= 6 ? f + 4 : 13); }

// The caller's fields (positions, velocities, inv_masses, half_sigma,
// twice_sqrt_eps, atom_id, forces, charges; the last two may be null),
// each read where it lies: word w of slot s of field f at
// ptr[f][s·slot[f] + w·word[f]].
struct Sources {
  const int* ptr[kFields];
  long slot[kFields];
  long word[kFields];
};

// The outputs: field f of slot s, word w at ptr[f][s·width + w]
// (contiguous); null where the source is.
struct Dests {
  int* ptr[kFields];
};

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;
constexpr unsigned kAll = 0xffffffffu;

// The cell key of source slot s, as the torch ops form it; -1 for an
// empty slot.
__device__ __forceinline__ int cell_key(const Sources& in, const uint8_t* valid, long valid_slot, long s,
                                        float box, int m) {
  if (!valid[s * valid_slot]) return -1;
  const int* p = in.ptr[kPos] + s * in.slot[kPos];
  long long t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float q = __fdiv_rn(__int_as_float(p[a * in.word[kPos]]), box);
    const float w = __fsub_rn(q, floorf(q));
    const long long v = static_cast<long long>(floorf(__fmul_rn(static_cast<float>(m), w)));
    t[a] = v < 0 ? 0 : (v > m - 1 ? m - 1 : v);
  }
  return static_cast<int>(t[0] + m * (t[1] + m * t[2]));
}

// Source slot src's words into `bits`.
__device__ __forceinline__ void load_fields(const Sources& in, int src, int* bits) {
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    if (in.ptr[f] == nullptr) continue;
    const int* from = in.ptr[f] + static_cast<long>(src) * in.slot[f];
#pragma unroll
    for (int w = 0; w < width(f); ++w) bits[offset(f) + w] = from[w * in.word[f]];
  }
}

// `bits` into new slot dst, the positions wrapped, the slot live.
__device__ __forceinline__ void store_fields(const Dests& out, uint8_t* valid_out, long dst, const int* bits,
                                             float box) {
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    if (out.ptr[f] == nullptr) continue;
#pragma unroll
    for (int w = 0; w < width(f); ++w) {
      const int b = bits[offset(f) + w];
      out.ptr[f][dst * width(f) + w] = f == kPos ? emdee::wrapped(b, box) : b;
    }
  }
  valid_out[dst] = 1;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
sort_rebin_kernel(Sources in, const uint8_t* __restrict__ valid, long valid_slot, Dests out,
                  uint8_t* __restrict__ valid_out, int* scratch, const uint8_t* __restrict__ flag_in,
                  uint8_t* __restrict__ flag_out, int m, int c, const float* __restrict__ box_ptr) {
  const float box = *box_ptr;
  const int nc = m * m * m;
  const int num_slots = nc * c;
  int* count = scratch;
  int* flag = scratch + nc;
  int* bucket = scratch + nc + 1;
  const int lane = threadIdx.x & 31;
  const unsigned before = (1u << lane) - 1u;
  const long thread = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  const long threads = static_cast<long>(gridDim.x) * kThreads;
  cg::grid_group grid = cg::this_grid();

  // (0) Zero the counts and the flag.
  for (long i = thread; i <= nc; i += threads) scratch[i] = 0;
  grid.sync();

  // (1) A thread a source slot: its place in its cell's bucket.  The loop
  // is uniform over a warp, which `__match_any_sync` needs.
  bool raised = false;
  for (long first = thread - lane; first < num_slots; first += threads) {
    const long s = first + lane;
    const int key = s < num_slots ? cell_key(in, valid, valid_slot, s, box, m) : -1;
    const unsigned peers = __match_any_sync(kAll, key);
    if (key >= 0) {
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(count + key, __popc(peers));
      const int r = __shfl_sync(peers, base, leader) + __popc(peers & before);
      if (r < c) bucket[static_cast<long>(key) * c + r] = static_cast<int>(s);
      else raised = true;
    }
  }
  if (__syncthreads_or(raised) && threadIdx.x == 0) atomicOr(flag, 1);
  grid.sync();
  if (thread == 0) *flag_out = static_cast<uint8_t>(*flag_in != 0 || *flag != 0);

  // (2) A warp a new cell: gather its entries' fields, rank the entries by
  // source slot, store; fill the rest.  Each lane issues every load before
  // its first store, so that its gathers are in flight together.
  const long warps = threads / 32;
  for (long cell = thread / 32; cell < nc; cell += warps) {
    const int* entries = bucket + cell * c;
    const long row = cell * c;
    const int total = count[cell];
    if (total > c) {  // uniform over the warp
      // An overflowing cell keeps its first C atoms by source slot, as the
      // stable argsort does: the warp scans the source slots in order
      // until it has found them (a fault's path, off the hot one).
      int found = 0;
      for (long first = 0; found < c && first < num_slots; first += 32) {
        const long s = first + lane;
        const bool member = s < num_slots && cell_key(in, valid, valid_slot, s, box, m) == cell;
        const unsigned members = __ballot_sync(kAll, member);
        const int rank = found + __popc(members & before);
        if (member && rank < c) {
          int bits[kWords];
          load_fields(in, static_cast<int>(s), bits);
          store_fields(out, valid_out, row + rank, bits, box);
        }
        found += __popc(members);
      }
      continue;
    }
    for (int j0 = 0; j0 < c; j0 += 32) {
      const int i = j0 + lane;
      const int entry = i < c ? entries[i] : 0;
      if (j0 < total) {  // uniform over the warp
        const bool live = i < total;
        const int src = live ? entry : INT_MAX;
        int bits[kWords];
        if (live) load_fields(in, src, bits);
        int rank = 0;
        for (int k0 = 0; k0 < total; k0 += 32) {
          const int other = k0 + lane < total ? entries[k0 + lane] : INT_MAX;
          const int chunk = min(32, total - k0);
          for (int t = 0; t < chunk; ++t) rank += __shfl_sync(kAll, other, t) < src;
        }
        if (live) store_fields(out, valid_out, row + rank, bits, box);
      }
      if (i >= total && i < c) {
        const long dst = row + i;
#pragma unroll
        for (int f = 0; f < kFields; ++f) {
          if (out.ptr[f] == nullptr) continue;
#pragma unroll
          for (int w = 0; w < width(f); ++w) out.ptr[f][dst * width(f) + w] = f == kAtomId ? num_slots : 0;
        }
        valid_out[dst] = 0;
      }
    }
  }
}

// Resident blocks an SM and SMs of the current device: the cooperative grid.
cudaError_t grid_of(int& per_sm, int& sms) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sort_rebin_kernel, kThreads, 0);
  return err;
}

}  // namespace

// ptrs, slot, word: the 8 fields' pointers (forces and charges may be
// null) and element strides between slots and between a slot's words (host
// arrays); valid: the (M³, C) bool mask, valid_slot its stride; outs: the
// 8 contiguous outputs (null where the field is); valid_out: (M³, C) bool;
// scratch: M³ + 1 + M³·C int32; flag_in, flag_out: 0-d bool, the state's
// sticky flag and the new one (flag_in | a cell over C).
extern "C" int emdee_sort_rebin(const void* ptrs, const long* slot, const long* word, const uint8_t* valid,
                                long valid_slot, const void* outs, uint8_t* valid_out, int* scratch,
                                const uint8_t* flag_in, uint8_t* flag_out, int m, int c, const float* box,
                                void* stream) {
  if (m < 1 || c < 1 || c > 1024) return static_cast<int>(cudaErrorInvalidValue);
  Sources in{};
  Dests out{};
  for (int f = 0; f < kFields; ++f) {
    in.ptr[f] = static_cast<const int* const*>(ptrs)[f];
    in.slot[f] = slot[f];
    in.word[f] = word[f];
    out.ptr[f] = static_cast<int* const*>(outs)[f];
    if ((in.ptr[f] == nullptr) != (out.ptr[f] == nullptr) || (f < 6 && in.ptr[f] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  int per_sm = 0, sms = 0;
  cudaError_t err = grid_of(per_sm, sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long slots = static_cast<long>(m) * m * m * c;
  const long needed = (slots + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(needed < per_sm * sms ? needed : per_sm * sms);
  void* args[] = {&in, &valid, &valid_slot, &out, &valid_out, &scratch, &flag_in, &flag_out, &m, &c, &box};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sort_rebin_kernel), dim3(blocks),
                                    dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// out (int[4]): the cooperative grid — resident blocks an SM, SMs, threads
// a block, cells a block at a time (one a warp).
extern "C" int emdee_sort_rebin_attrs(int* out) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = grid_of(per_sm, sms);
  out[0] = per_sm;
  out[1] = sms;
  out[2] = kThreads;
  out[3] = kThreads / 32;
  return static_cast<int>(err);
}
