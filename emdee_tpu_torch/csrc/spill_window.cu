// A spill configuration's rebin on the grid-sharded engine, for Hopper
// (sm_90a): the routing passes with boundary spill and hold-backs over the
// shards' own rows.  (K7-G.)  Two forms:
//
// - `spill_grid_kernel` (entry `emdee_spill_grid_routing`): all three passes
//   (z, then y, then x) of the rebin in one cooperative launch, where every
//   shard of the mesh lies in one tensor on this card (a `LocalMesh`, or a
//   `DistMesh` of one rank); a row's neighbours across a shard face are
//   read in place, in the neighbouring shard.
// - `spill_halo_kernel` (entry `emdee_spill_halo`): one pass a launch,
//   reading the rows two cells down and up the pass axis from halo planes
//   two layers deep that the host exchanged between the launches: the
//   route of a mesh whose shards lie on several ranks, and the one-launch
//   form's witness.
//
// Replaces: emdee_tpu/neighbors/pallas_compact.py `compact_window_pallas`
// (K7), the compaction step of the reference's XLA routing pass
// `_route_axis_pass` with `spill_eps` (emdee_tpu/neighbors/cell_dense.py,
// spill branch at :437-486), which the reference's grid engine runs on each
// shard for a spill configuration (emdee_tpu/distributed/grid_sharded.py
// `_rebin_local`, :1019-1023 and :1074-1078), together with the masks,
// spill and hold-back decisions and ranks around it.  Plain PyTorch
// versions: emdee_tpu_torch/neighbors/rebin_window_kernel.py
// `spill_grid_rebin_plain` (the shards' rows gathered into the whole grid,
// `compact_kernel.spill_route_plain`'s three passes, K6's fill, the rows
// scattered back) and `spill_halo_plain` (the park, windows two rows deep
// each side, then `cell_dense._route_windows` with spill and the
// compaction of the own rows); wrappers: the same module's
// `spill_grid_rebin` and `spill_halo_pass`.
//
// Inputs: K6's (rebin_window.cu `emdee_rebin_halo`) — the nf transported
// fields of the local shards, (sz, sy, sx, mz, my, mx, C) slots each, read
// where they lie through a pointer and a slot stride each (positions
// first, atom_id last); m, the global cell count an axis; the spill target
// c_t and the float32 threshold 1 − ε/h.  The per-pass form also takes the
// halo planes along the pass axis, two layers deep, (nf, sz, sy, sx, hz,
// hy, hx, C) with the pass axis' extent 2 — lo: the top two layers of the
// shard below (far, then near), hi: the bottom two layers of the shard
// above (near, then far) — or none where the axis holds one shard, whose
// own far layers are then the neighbours; and b, each row's GLOBAL cell
// coordinate along the pass axis.  In the first pass (`raw`) validity is
// atom_id < num_slots and positions are wrapped x − floor(x/L)·L as they
// are read; later passes read the previous pass's output, whose positions
// carry the NaN-pattern sentinel in empty slots.  The output is (nf, sz,
// sy, sx, mz, my, mx, C) int32 with K6's fill in empty slots (the sentinel
// in positions, atom_id = num_slots, 0 elsewhere).
//
// Design.  A warp a destination row q.  A spill pass's keep mask for q
// reads the class counts of rows q−2 … q+2 (spill_routing.cu's note).  The
// one-launch form is K7's design (spill_routing.cu) laid over the shard
// layout: a persistent grid; in each pass every warp counts its own row's
// classes once (coordinate words only, one ballot a class a chunk of 32
// slots) into scratch, five words a row, and after a grid barrier reads the
// counts of rows q−2 … q+2 there.  The row d cells along the pass axis is
// found by index arithmetic on its global coordinate g + d (mod M): the
// shard (g + d) div n along that mesh axis and its layer (g + d) mod n, n
// the shard's layers — the own shard, its neighbour, or across the
// periodic seam.  No halo plane is built.  The passes run caller's fields →
// out → mid → out with a grid barrier between them.  The per-pass form has
// no barrier to share counts across ranks, so each warp counts the five
// rows itself, each in place or in a halo plane.  Both then decide q−1's
// spills, q's spills and holds and q+1's holds, apply the seam shift (the
// coordinate less L for a spill out of the row at global b = M−1 and a
// hold in the row at b = 0) and compact q's 3C candidates in the
// reference's order (`spill_row.cuh`, K7's own per-row code).  Every float
// operation is a round-to-nearest intrinsic.  The sticky flag (an illegal
// move among q's slots, or a count above C) is OR'd into the caller's and
// is the only atomic; the box is read from a 0-d float32 device tensor.
//
// Bound on this card: pure data movement — the nf fields read once and
// written once (and, per pass, the halo planes): ~9.2 MB a pass at the
// 97,556-atom spill melt (nf = 9, 131,072 slots at M = 16, C = 32), ~2.7 µs
// at HBM rate.  As for K6 and K7 the row's dependent loads (coordinates,
// then the kept candidates' fields) set the time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rebin_row.cuh"
#include "spill_row.cuh"

namespace cg = cooperative_groups;

namespace {

// A halo plane two layers deep: field f of slot j of the row at shard (pz,
// py, px), local cell (lz, ly, lx) with the pass axis' coordinate the
// layer (0 or 1), at ptr[f·s[0] + pz·s[1] + py·s[2] + px·s[3] + lz·s[4] +
// ly·s[5] + lx·s[6] + j·s[7]].
struct Halo {
  const int* ptr;
  long s[8];
};

// A row: an own row (`halo` null; `off` its first flat slot) or a row of a
// halo plane (`off` its offset there, field 0, slot 0).
struct RowRef {
  const Halo* halo;
  long off;
};

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;

// kRaw: the first pass, on the caller's fields through `in`; else the
// previous pass's (nf, rows, C) output at in.ptr[0].
template <bool kRaw>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spill_halo_kernel(const __grid_constant__ emdee::Fields in, const __grid_constant__ Halo lo,
                  const __grid_constant__ Halo hi, const int* __restrict__ b, int* out, int* __restrict__ flag,
                  int nf, int sy, int sx, int mz, int my, int mx, int rows, int c, int axis, int cf, int m,
                  int num_slots, int target, float threshold, const float* __restrict__ box_ptr) {
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warps only: the row is uniform in a warp
  const float box = *box_ptr;
  const long slots = static_cast<long>(rows) * c;
  int t = r;
  const int lx = t % mx;
  t /= mx;
  const int ly = t % my;
  t /= my;
  const int lz = t % mz;
  t /= mz;  // the shard
  const int px = t % sx;
  t /= sx;
  const int py = t % sy;
  const int pz = t / sy;
  const int l = axis == 0 ? lz : (axis == 1 ? ly : lx);
  const int n = axis == 0 ? mz : (axis == 1 ? my : mx);
  const int step = axis == 0 ? my * mx : (axis == 1 ? mx : 1);
  const int b_row = b[r];
  const auto plane_off = [&](const Halo& h, int layer) {
    return pz * h.s[1] + py * h.s[2] + px * h.s[3] + (axis == 0 ? layer : lz) * h.s[4] +
           (axis == 1 ? layer : ly) * h.s[5] + (axis == 2 ? layer : lx) * h.s[6];
  };
  // The row d ∈ [−2, 2] cells along the axis: an own row, a halo plane's
  // row past the shard's first or last layer, or where the axis holds one
  // shard the own row across the periodic seam.
  const auto row_at = [&](int d) {
    const int ld = l + d;
    if (ld >= 0 && ld < n) return RowRef{nullptr, static_cast<long>(r + d * step) * c};
    if (lo.ptr == nullptr) {
      const int w = ld < 0 ? ld + n : ld - n;
      return RowRef{nullptr, static_cast<long>(r + (w - l) * step) * c};
    }
    return ld < 0 ? RowRef{&lo, plane_off(lo, 2 + ld)} : RowRef{&hi, plane_off(hi, ld - n)};
  };
  RowRef ref[5];
  int bsd[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    ref[i] = row_at(i - 2);
    int bs = b_row + i - 2;
    if (bs < 0) bs += m;
    else if (bs >= m) bs -= m;
    bsd[i] = bs;
  }
  const int* x = in.ptr[0];
  const auto raw_word = [&](int f, const RowRef& row, int j) {
    if (row.halo != nullptr) return row.halo->ptr[f * row.halo->s[0] + row.off + j * row.halo->s[7]];
    if constexpr (kRaw) return in.ptr[f][(row.off + j) * in.stride[f]];
    return x[f * slots + row.off + j];
  };
  const auto live = [&](const RowRef& row, int j) {
    if constexpr (kRaw) return raw_word(nf - 1, row, j) < num_slots;
    return raw_word(cf, row, j) != emdee::kSentinel;
  };
  const auto word = [&](int f, const RowRef& row, int j) {
    const int bits = raw_word(f, row, j);
    return kRaw && f < 3 ? emdee::wrapped(bits, box) : bits;
  };
  emdee::Counts k[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) k[i] = emdee::count_row(ref[i], live, word, c, bsd[i], cf, box, m, threshold);
  const auto source = [&](int seg, int& bs) {
    bs = bsd[seg + 1];
    return ref[seg + 1];
  };
  const auto fill = [&](int f) { return emdee::fill_value(f, nf, num_slots); };
  int count;
  if (emdee::spill_row(source, live, word, fill, k, out + static_cast<long>(r) * c, slots, nf, m, c, cf, box,
                       target, threshold, count) &&
      (threadIdx.x & 31) == 0)
    atomicOr(flag, 1);
}

// The shard layout of the one-launch form: rows in (sz, sy, sx, mz, my, mx)
// order, s[a] shards and n[a] cells a shard along grid axis a (0 = z,
// 1 = y, 2 = x), s[a]·n[a] = m on every axis.
struct Layout {
  int s[3], n[3];
  int m;

  // Row r's global cell coordinate g along `axis`, and `base`, the row of
  // the same shard and cell but at shard 0, layer 0 along it: the row at
  // global coordinate h is then row(base, axis, h).
  __device__ __forceinline__ void along(int r, int axis, int& g, int& base) const {
    const int ln = axis == 2 ? 1 : (axis == 1 ? n[2] : n[1] * n[2]);  // a layer's rows
    const int sh = n[0] * n[1] * n[2] * (axis == 2 ? 1 : (axis == 1 ? s[2] : s[1] * s[2]));  // a shard's
    const int l = (r / ln) % n[axis], p = (r / sh) % s[axis];
    g = p * n[axis] + l;
    base = r - p * sh - l * ln;
  }
  __device__ __forceinline__ int row(int base, int axis, int h) const {
    const int ln = axis == 2 ? 1 : (axis == 1 ? n[2] : n[1] * n[2]);
    const int sh = n[0] * n[1] * n[2] * (axis == 2 ? 1 : (axis == 1 ? s[2] : s[1] * s[2]));
    return base + (h / n[axis]) * sh + (h % n[axis]) * ln;
  }
};

// Where a pass of the one-launch form reads: the caller's fields (kRaw,
// the first pass: validity atom_id < num_slots, positions wrapped as they
// are read) or the previous pass's (nf, rows, C) output, whose empty slots
// carry the sentinel in positions.  A row is its index in the layout.
template <bool kRaw>
struct GridSource {
  const emdee::Fields* caller;
  const int* prev;
  long slots;
  int c, nf, cf, num_slots;
  float box;

  __device__ __forceinline__ int raw_word(int f, int r, int j) const {
    const long slot = static_cast<long>(r) * c + j;
    if constexpr (kRaw) return caller->ptr[f][slot * caller->stride[f]];
    return prev[f * slots + slot];
  }
  __device__ __forceinline__ bool live(int r, int j) const {
    if constexpr (kRaw) return raw_word(nf - 1, r, j) < num_slots;
    return raw_word(cf, r, j) != emdee::kSentinel;
  }
  __device__ __forceinline__ int word(int f, int r, int j) const {
    const int bits = raw_word(f, r, j);
    return kRaw && f < 3 ? emdee::wrapped(bits, box) : bits;
  }
};

// One pass of the one-launch form along `axis` from `in` into `out`: every
// row's class counts into `scratch` (five words a row), a grid barrier,
// then every row routed with the counts of rows q−2 … q+2 from there.
// Returns whether one of this warp's rows raised the flag (warp uniform).
template <bool kRaw>
__device__ __forceinline__ bool grid_pass(const GridSource<kRaw>& in, int* out, int* scratch, const Layout& lay,
                                          int rows, int axis, int target, float threshold, cg::grid_group& grid) {
  const int warps = gridDim.x * (kThreads / 32);
  const int first = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const auto live = [&](int r, int j) { return in.live(r, j); };
  const auto word = [&](int f, int r, int j) { return in.word(f, r, j); };
  for (int r = first; r < rows; r += warps) {
    int g, base;
    lay.along(r, axis, g, base);
    const emdee::Counts k = emdee::count_row(r, live, word, in.c, g, in.cf, in.box, lay.m, threshold);
    if ((threadIdx.x & 31) == 0) {
      int* w = scratch + 5L * r;
      w[0] = k.plus;
      w[1] = k.stay;
      w[2] = k.minus;
      w[3] = k.near_stay;
      w[4] = k.near_minus;
    }
  }
  grid.sync();
  const auto fill = [&](int f) { return emdee::fill_value(f, in.nf, in.num_slots); };
  bool raised = false;
  for (int r = first; r < rows; r += warps) {
    int g, base;
    lay.along(r, axis, g, base);
    int row_d[5], g_d[5];
    emdee::Counts k[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      int h = g + i - 2;
      if (h < 0) h += lay.m;
      else if (h >= lay.m) h -= lay.m;
      g_d[i] = h;
      row_d[i] = lay.row(base, axis, h);
      const int* w = scratch + 5L * row_d[i];
      k[i] = emdee::Counts{w[0], w[1], w[2], w[3], w[4]};
    }
    const auto source = [&](int seg, int& bs) {
      bs = g_d[seg + 1];
      return row_d[seg + 1];
    };
    int count;
    raised |= emdee::spill_row(source, live, word, fill, k, out + static_cast<long>(r) * in.c, in.slots, in.nf,
                               lay.m, in.c, in.cf, in.box, target, threshold, count);
  }
  return raised;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
spill_grid_kernel(const __grid_constant__ emdee::Fields caller, int* out, int* mid, int* scratch,
                  int* __restrict__ flag, const __grid_constant__ Layout lay, int nf, int rows, int c,
                  int num_slots, int target, float threshold, const float* __restrict__ box_ptr) {
  const float box = *box_ptr;
  const long slots = static_cast<long>(rows) * c;
  cg::grid_group grid = cg::this_grid();
  // The passes' sources: the caller's fields (z), then out (y), then mid (x).
  const GridSource<true> z{&caller, nullptr, slots, c, nf, 2, num_slots, box};
  const GridSource<false> y{nullptr, out, slots, c, nf, 1, num_slots, box};
  const GridSource<false> x{nullptr, mid, slots, c, nf, 0, num_slots, box};
  bool raised = grid_pass(z, out, scratch, lay, rows, 0, target, threshold, grid);
  grid.sync();
  raised |= grid_pass(y, mid, scratch, lay, rows, 1, target, threshold, grid);
  grid.sync();
  raised |= grid_pass(x, out, scratch, lay, rows, 2, target, threshold, grid);
  if (__syncthreads_or(raised) && threadIdx.x == 0) atomicOr(flag, 1);
}

// Resident blocks an SM and SMs of the current device: the one-launch
// form's cooperative grid.
cudaError_t grid_of(int& per_sm, int& sms) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, spill_grid_kernel, kThreads, 0);
  return err;
}

}  // namespace

// ptrs, strides: nf field pointers and element strides between slots (host
// arrays; without `raw`, the fields of one contiguous (nf, rows, C) block);
// lo, hi: the two-layer halo planes (both null where the axis holds one
// shard), lo_s, hi_s their eight strides (host arrays); b: (rows,) int32;
// out: (nf, rows, C) int32; flag: a 0-d int32 the launch raises (never
// zeroes); shape: sz, sy, sx, mz, my, mx (host int[6]); target, threshold:
// the spill target c_t and the float32 threshold 1 − ε/h.
extern "C" int emdee_spill_halo(const void* ptrs, const long* strides, int nf, const int* lo, const long* lo_s,
                                const int* hi, const long* hi_s, const int* b, int* out, int* flag,
                                const int* shape, int c, int axis, int cf, int m, int num_slots, int raw, int target,
                                float threshold, const float* box, void* stream) {
  const long rows = static_cast<long>(shape[0]) * shape[1] * shape[2] * shape[3] * shape[4] * shape[5];
  const int n = shape[3 + axis];
  if (m < 3 || c < 1 || nf < 4 || nf > emdee::kMaxFields || axis < 0 || axis > 2 || cf < 0 || cf > 2 ||
      rows < 1 || rows > 0x7fffffffL - kThreads || (lo == nullptr) != (hi == nullptr) ||
      (lo != nullptr && n < 2) || (lo == nullptr && n != m))
    return static_cast<int>(cudaErrorInvalidValue);
  emdee::Fields in{};
  for (int f = 0; f < nf; ++f) {
    in.ptr[f] = static_cast<const int* const*>(ptrs)[f];
    in.stride[f] = strides[f];
  }
  Halo h_lo{lo, {}}, h_hi{hi, {}};
  for (int i = 0; i < 8; ++i) {
    h_lo.s[i] = lo_s[i];
    h_hi.s[i] = hi_s[i];
  }
  const int rows_a_block = kThreads / 32;
  const unsigned blocks = static_cast<unsigned>((rows + rows_a_block - 1) / rows_a_block);
  const auto kernel = raw ? spill_halo_kernel<true> : spill_halo_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, h_lo, h_hi, b, out, flag, nf, shape[1], shape[2], shape[3], shape[4], shape[5], static_cast<int>(rows), c,
      axis, cf, m, num_slots, target, threshold, box);
  return static_cast<int>(cudaGetLastError());
}

// The one-launch form: ptrs, strides as emdee_spill_halo's first pass (the
// caller's raw fields); out, mid: (nf, rows, C) int32; scratch: (rows, 5)
// int32; flag: a 0-d int32 the launch raises (never zeroes); shape: sz, sy,
// sx, mz, my, mx (host int[6]), every shard of the mesh; m: the global
// cell count an axis (sz·mz = sy·my = sx·mx); target, threshold: the spill
// target c_t and the float32 threshold 1 − ε/h.  A card that refuses the
// cooperative launch returns its error: there is no other route here.
extern "C" int emdee_spill_grid_routing(const void* ptrs, const long* strides, int nf, int* out, int* mid,
                                        int* scratch, int* flag, const int* shape, int c, int m, int num_slots,
                                        int target, float threshold, const float* box, void* stream) {
  const long rows = static_cast<long>(shape[0]) * shape[1] * shape[2] * shape[3] * shape[4] * shape[5];
  if (m < 3 || c < 1 || nf < 4 || nf > emdee::kMaxFields || rows < 1 || rows > 0x7fffffffL - kThreads ||
      scratch == nullptr || mid == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout lay{};
  lay.m = m;
  for (int a = 0; a < 3; ++a) {
    lay.s[a] = shape[a];
    lay.n[a] = shape[3 + a];
    if (shape[a] < 1 || shape[3 + a] < 1 || shape[a] * shape[3 + a] != m)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  emdee::Fields in{};
  for (int f = 0; f < nf; ++f) {
    in.ptr[f] = static_cast<const int* const*>(ptrs)[f];
    in.stride[f] = strides[f];
  }
  int per_sm = 0, sms = 0;
  cudaError_t err = grid_of(per_sm, sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long rows_a_block = kThreads / 32, needed = (rows + rows_a_block - 1) / rows_a_block;
  const unsigned blocks = static_cast<unsigned>(needed < per_sm * sms ? needed : per_sm * sms);
  int n_rows = static_cast<int>(rows);
  void* args[] = {&in, &out, &mid, &scratch, &flag, &lay, &nf, &n_rows, &c, &num_slots, &target, &threshold, &box};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(spill_grid_kernel), dim3(blocks), dim3(kThreads),
                                    args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// out (int[4]): the one-launch form's cooperative grid — resident blocks an
// SM, SMs, threads a block, rows a block at a time (one a warp).
extern "C" int emdee_spill_grid_attrs(int* out) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = grid_of(per_sm, sms);
  out[0] = per_sm;
  out[1] = sms;
  out[2] = kThreads;
  out[3] = kThreads / 32;
  return static_cast<int>(err);
}
