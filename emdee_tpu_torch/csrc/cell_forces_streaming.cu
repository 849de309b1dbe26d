// Streaming half-shell Lennard-Jones force kernel for Hopper (sm_90a): K5.
//
// Replaces: emdee_tpu/neighbors/pallas_cell_kernel.py — the streaming kernel
// `_make_streaming_kernel` / `streaming_halfshell_call` (one program per
// (z, y) pencil, the self cell plus 13 half-shell neighbour cells in the five
// row groups `_HS_ROW_GROUPS`, Newton reaction rows written per program at
// the wrapped row and summed by the caller), as entered by
// `pallas_cell_forces_streaming` (per-atom or uniform parameters, optional
// per-slot ½E and ½W) and `pallas_cell_forces_streaming_split` (component
// arrays, uniform parameters, forces only).  The pair math is K1's
// (`_build_pair_pass`), shared with cell_forces.cu through lj_pair.cuh.
// Plain PyTorch version: emdee_tpu_torch/neighbors/cell_dense.py
// `_dense_forces` (the same half shell with rolled reactions); wrapper:
// emdee_tpu_torch/neighbors/streaming_kernel.py.
//
// Design.  One block per (z, y) pencil (M² blocks of 8 warps).  The block
// walks 14 phases: the self cell; dx = −1, 0, +1 of the row groups (0, 1),
// (1, −1), (1, 0), (1, 1); and dx = +1 of the own row (0, 0).  In a phase
// warp w takes the centre cells x ≡ w (mod 8) of the pencil and evaluates
// every pair of centre cell x with neighbour cell (x+dx, y+dy, z+dz), each
// unique pair once.  The warp first compacts the live slots of both cells
// into its two shared tiles (ballot ranks, slot order).  A lane holds a
// live centre slot; the neighbour cell's live slots travel round a ring of
// W = max(live centre, live neighbour) lanes as packets (position,
// parameters and the reaction sums), one lane per step by shuffle, so after
// W steps every lane has met every packet and each packet is back on its own
// lane with −Σᵢ f_ij summed in a fixed order.  At 1M a cell holds ~20 atoms
// in its 32 slots, so a cell pair takes ~22 steps, not 32.  Capacities
// above 32 take a second centre slot per lane and a second packet chunk
// (C ≤ 64).
//
// No float atomics.  Each block owns the centre accumulators of its pencil
// and one reaction row per group in shared memory.  Within a phase the map
// x → x+dx is a bijection, so no two warps touch the same reaction lane, and
// phases are separated by barriers, so each slot's contributions arrive in
// the order of the phases.  The wrapped x lanes fold by indexing modulo M
// (the TPU kernel's `wrap_reaction`).  After its three dx phases a group's
// row is written to its own slice of a (4, n_r, M³·C) scratch array at the
// wrapped row (z+dz, y+dy): each group is a bijection on rows, so every row
// of every slice is written by exactly one block.  The own row (0, 0) is the
// block's own pencil: its reactions are added to the centre sums in the
// kernel.  A second small launch (`fold_kernel`) adds the four group slices
// in a fixed order — centre + (0,0), then (0,1), (1,−1), (1,0), (1,1) — so
// reruns are bitwise equal (the engine's determinism contract).
//
// Coordinates: across a periodic face the displacement is the raw
// difference less ±box on that axis, (x_i − x_j) − shift, the TPU kernel's
// ghost copies taken after the difference: for every pair inside the cutoff
// that is bit for bit the plain version's minimum image d − L·rint(d/L),
// where shifting x_j first would round at the scale of the box.  Atoms are
// never wrapped, since between rebins positions overhang the box by up to
// skin/2.
// The box is read from a 0-d float32 device tensor (the NPT engine's dynamic
// box, or the static box held on the device), only where a neighbour index
// wraps: holding it in a register from the kernel's start cost ~2% at 1M.
// Ring lanes past the live packets carry NaN coordinates, which fail the
// cutoff test; lanes past the live centre slots and the self pair are
// skipped; an empty slot's outputs are exact zeros.
//
// Numerics: the Horner form of the switched −r·dE/dr in r² with an exact
// IEEE 1/r² (no fast math), pairs at r² ≥ rc² skipped, as in cell_forces.cu.
//
// Bound on this card: at the 1,000,188-atom melt (M = 37, C = 32) the ring
// loop runs ~50,653 × 14 × 22 steps of 32 lanes, about 60% of the lanes
// live, and ~27 M of the pairs lie inside the cutoff: ~1.4 GFLOP, ~0.02 ms
// at 67 TFLOP/s.  The function's own bytes (25 B a slot in, out) take
// ~0.012 ms at 3.35 TB/s, the four reaction slices (78 MB forces only,
// written once and read back by the fold) ~0.05 ms.  The launch pair takes
// ~1.3 ms (chip_smoke.py): the candidate loop's instruction rate and
// latency set it, not bytes or arithmetic; the same holds for the
// full-shell kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lj_pair.cuh"

namespace {

using emdee::PairConsts;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroups = 4;  // row groups written to the scratch array
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 64;  // entries of a warp's cell tile (C ≤ 64)
// The row groups (dz, dy) in fold order; the own row (0, 0) comes last.
__constant__ int kGroupDz[kGroups] = {0, 1, 1, 1};
__constant__ int kGroupDy[kGroups] = {1, -1, 0, 1};

struct Fields {
  const float* px;
  const float* py;
  const float* pz;
  int pstride;
  const float* hs;
  const float* tse;
  const uint8_t* valid;
};

// Centre sums and one reaction row of a pencil, (2, n_r, M·C) float32, then
// each warp's two cell tiles.
size_t smem_bytes(int m, int c, bool energy);

__device__ __forceinline__ int wrap(int v, int m, const float* __restrict__ box, float& shift) {
  shift = 0.f;
  if (v < 0) { shift = -*box; return v + m; }
  if (v >= m) { shift = *box; return v - m; }
  return v;
}

// A warp's compacted copy of one cell: the live slots' fields in slot
// order at entries 0 … n−1, and each entry's slot.
struct Tile {
  float f[5][kTile];  // x, y, z, σ/2, 2√ε
  int slot[kTile];
};

// Compact cell `cell`'s live slots into `t` (ballot ranks, slot order);
// returns their count.  The caller brackets it with warp barriers.
template <int NA, bool UNIFORM>
__device__ __forceinline__ int compact(const Fields& f, long cell, int c, Tile& t) {
  const int lane = threadIdx.x & 31;
  int n = 0;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int j = 32 * a + lane;
    const long s = cell * c + j;
    const bool live = j < c && f.valid[s];
    const unsigned mask = __ballot_sync(kFull, live);
    if (live) {
      const int e = n + __popc(mask & ((1u << lane) - 1u));
      t.f[0][e] = f.px[s * f.pstride];
      t.f[1][e] = f.py[s * f.pstride];
      t.f[2][e] = f.pz[s * f.pstride];
      if (!UNIFORM) {
        t.f[3][e] = f.hs[s];
        t.f[4][e] = f.tse[s];
      }
      t.slot[e] = j;
    }
    n += __popc(mask);
  }
  return n;
}

// All pairs of centre cell `cen` with neighbour cell `nb` (shifted by
// (shx, shy, shz)) for one warp, through its two tiles.  Centre sums go to
// cen_acc[k·mc + x·C + i]; with REACT, the reaction sums go to
// row[k·mc + nx·C + j].
template <int NA, bool UNIFORM, bool ENERGY, bool REACT>
__device__ __forceinline__ void cell_pair(const Fields& f, long cen, long nb, int c, int x,
                                          int nx, float shx, float shy, float shz, int mc,
                                          float* cen_acc, float* row, Tile* tiles,
                                          const PairConsts& k) {
  const int lane = threadIdx.x & 31;
  Tile& tc = tiles[0];
  Tile& tn = REACT ? tiles[1] : tiles[0];  // the self pass pairs a cell with itself
  __syncwarp();  // the previous cell pair's reads of the tiles are done
  const int n_cen = compact<NA, UNIFORM>(f, cen, c, tc);
  const int n_nb = REACT ? compact<NA, UNIFORM>(f, nb, c, tn) : n_cen;
  __syncwarp();
  if (n_cen == 0 || n_nb == 0) return;

  float xi[NA], yi[NA], zi[NA], hsi[NA], tsei[NA];
  bool vi[NA];
  float fxa[NA], fya[NA], fza[NA], ea[NA], wa[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int e = 32 * a + lane;
    vi[a] = e < n_cen;
    xi[a] = vi[a] ? tc.f[0][e] : 0.f;
    yi[a] = vi[a] ? tc.f[1][e] : 0.f;
    zi[a] = vi[a] ? tc.f[2][e] : 0.f;
    hsi[a] = (!UNIFORM && vi[a]) ? tc.f[3][e] : 0.f;
    tsei[a] = (!UNIFORM && vi[a]) ? tc.f[4][e] : 0.f;
    fxa[a] = fya[a] = fza[a] = ea[a] = wa[a] = 0.f;
  }
  const int ring_cen = min(n_cen, 32);  // live centre lanes of the fullest chunk
#pragma unroll
  for (int b = 0; b < NA; ++b) {
    const int n_b = min(n_nb - 32 * b, 32);  // live packets of this chunk
    if (n_b <= 0) break;
    // The packets travel round a ring of the first `ring` lanes.
    const int ring = max(ring_cen, n_b);
    const int e = 32 * b + lane;
    const bool vj = lane < n_b;
    const float nan = __int_as_float(0x7fc00000);
    float nxp = vj ? tn.f[0][e] : nan;
    float nyp = vj ? tn.f[1][e] : nan;
    float nzp = vj ? tn.f[2][e] : nan;
    float nhs = (!UNIFORM && vj) ? tn.f[3][e] : 0.f;
    float ntse = (!UNIFORM && vj) ? tn.f[4][e] : 0.f;
    float rx = 0.f, ry = 0.f, rz = 0.f, re = 0.f, rw = 0.f;
    // Lane l takes the packet of lane l+1 round the ring: after `step`
    // rotations lane l holds entry 32b + (l + step) mod ring, and after
    // `ring` its own again.  Lanes past the ring keep theirs.
    const int from = lane + 1 == ring ? 0 : (lane < ring ? lane + 1 : lane);
    for (int step = 0; step < ring; ++step) {
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        // The self pair (same cell, same slot) meets its own packet at step 0.
        if (!REACT && a == b && step == 0) continue;
        if (!vi[a]) continue;
        const float dvx = (xi[a] - nxp) - shx;
        const float dvy = (yi[a] - nyp) - shy;
        const float dvz = (zi[a] - nzp) - shz;
        const float r2 = dvx * dvx + dvy * dvy + dvz * dvz;
        if (!(r2 < k.rc2)) continue;
        const float rinv = 1.0f / r2;
        float t6, s6;
        if (UNIFORM) {
          const float s2 = k.sig2_u * rinv;
          s6 = s2 * s2 * s2;
          t6 = k.eps4_u * s6;
        } else {
          const float sig = hsi[a] + nhs;
          const float s2 = sig * sig * rinv;
          s6 = s2 * s2 * s2;
          t6 = (tsei[a] * ntse) * s6;
        }
        float t12, xs;
        const float tot = emdee::switched_tot(r2, t6, s6, k, t12, xs);
        const float gf = tot * rinv;
        const float gx = gf * dvx, gy = gf * dvy, gz = gf * dvz;
        fxa[a] += gx;
        fya[a] += gy;
        fza[a] += gz;
        if (REACT) {
          rx -= gx;
          ry -= gy;
          rz -= gz;
        }
        if (ENERGY) {
          const float gsw = 1.f + (xs * xs * xs) * ((-6.f * xs + 15.f) * xs - 10.f);
          const float he = 0.5f * ((t12 - t6) * gsw);
          const float hw = 0.5f * tot;
          ea[a] += he;
          wa[a] += hw;
          if (REACT) {
            re += he;
            rw += hw;
          }
        }
      }
      nxp = __shfl_sync(kFull, nxp, from);
      nyp = __shfl_sync(kFull, nyp, from);
      nzp = __shfl_sync(kFull, nzp, from);
      if (!UNIFORM) {
        nhs = __shfl_sync(kFull, nhs, from);
        ntse = __shfl_sync(kFull, ntse, from);
      }
      if (REACT) {
        rx = __shfl_sync(kFull, rx, from);
        ry = __shfl_sync(kFull, ry, from);
        rz = __shfl_sync(kFull, rz, from);
        if (ENERGY) {
          re = __shfl_sync(kFull, re, from);
          rw = __shfl_sync(kFull, rw, from);
        }
      }
    }
    if (REACT && vj) {
      float* r = row + nx * c + tn.slot[e];
      r[0] += rx;
      r[mc] += ry;
      r[2 * mc] += rz;
      if (ENERGY) {
        r[3 * mc] += re;
        r[4 * mc] += rw;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    if (!vi[a]) continue;
    float* o = cen_acc + x * c + tc.slot[32 * a + lane];
    o[0] += fxa[a];
    o[mc] += fya[a];
    o[2 * mc] += fza[a];
    if (ENERGY) {
      o[3 * mc] += ea[a];
      o[4 * mc] += wa[a];
    }
  }
}

template <int NA, bool UNIFORM, bool ENERGY>
__global__ void __launch_bounds__(kThreads)
    streaming_kernel(Fields f, float* __restrict__ fx, float* __restrict__ fy,
                     float* __restrict__ fz, int fstride, float* __restrict__ e_out,
                     float* __restrict__ w_out, float* __restrict__ groups, int m, int c,
                     const float* __restrict__ box_ptr, PairConsts k) {
  constexpr int NR = ENERGY ? 5 : 3;
  extern __shared__ float smem[];
  const int mc = m * c;
  float* cen_acc = smem;        // (NR, M·C) centre sums of this pencil
  float* row = smem + NR * mc;  // (NR, M·C) one group's reaction row
  const int warp = threadIdx.x >> 5;
  Tile* tiles = reinterpret_cast<Tile*>(smem + 2 * NR * mc) + 2 * warp;  // this warp's two
  const int z = blockIdx.x / m, y = blockIdx.x % m;
  const long pencil = static_cast<long>(blockIdx.x) * m;  // cell id of x = 0
  const long ns = static_cast<long>(m) * m * mc;

  for (int t = threadIdx.x; t < 2 * NR * mc; t += kThreads) smem[t] = 0.f;
  __syncthreads();

  // Self cell: every ordered pair, no reaction.
  for (int x = warp; x < m; x += kWarps)
    cell_pair<NA, UNIFORM, ENERGY, false>(f, pencil + x, pencil + x, c, x, x, 0.f, 0.f, 0.f,
                                          mc, cen_acc, row, tiles, k);

  for (int g = 0; g <= kGroups; ++g) {
    const bool own = g == kGroups;  // the own row (0, 0): dx = +1 only
    float shy, shz;
    const int ny = wrap(y + (own ? 0 : kGroupDy[g]), m, box_ptr, shy);
    const int nz = wrap(z + (own ? 0 : kGroupDz[g]), m, box_ptr, shz);
    const long nrow = static_cast<long>(nz) * m + ny;
    for (int dx = own ? 1 : -1; dx <= 1; ++dx) {
      for (int x = warp; x < m; x += kWarps) {
        float shx;
        const int nx = wrap(x + dx, m, box_ptr, shx);
        cell_pair<NA, UNIFORM, ENERGY, true>(f, pencil + x, nrow * m + nx, c, x, nx, shx, shy,
                                             shz, mc, cen_acc, row, tiles, k);
      }
      __syncthreads();
    }
    if (!own) {
      float* out = groups + static_cast<long>(g) * NR * ns + nrow * mc;
      for (int t = threadIdx.x; t < NR * mc; t += kThreads) {
        out[(t / mc) * ns + t % mc] = row[t];
        row[t] = 0.f;
      }
      __syncthreads();
    }
  }

  // Centre sums + the own row's reactions, to this pencil's output slots.
  float* outs[5] = {fx, fy, fz, e_out, w_out};
  for (int t = threadIdx.x; t < NR * mc; t += kThreads) {
    const int comp = t / mc;
    const long s = pencil * c + t % mc;
    outs[comp][comp < 3 ? s * fstride : s] = cen_acc[t] + row[t];
  }
}

// out_k[s] += group 0..3 of component k at slot s, in that order.
template <int NR>
__global__ void fold_kernel(float* fx, float* fy, float* fz, int fstride, float* e_out,
                            float* w_out, const float* __restrict__ groups, long ns) {
  const long s = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= ns) return;
  float* outs[5] = {fx, fy, fz, e_out, w_out};
#pragma unroll
  for (int comp = 0; comp < NR; ++comp) {
    float* o = outs[comp] + (comp < 3 ? s * fstride : s);
    float v = *o;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) v += groups[(static_cast<long>(g) * NR + comp) * ns + s];
    *o = v;
  }
}

size_t smem_bytes(int m, int c, bool energy) {
  return sizeof(float) * 2 * (energy ? 5 : 3) * static_cast<size_t>(m) * c +
         sizeof(Tile) * 2 * kWarps;
}

template <int NA, bool UNIFORM, bool ENERGY>
int launch(const Fields& f, float* fx, float* fy, float* fz, int fstride, float* e, float* w,
           float* groups, int m, int c, const float* box, const PairConsts& k, cudaStream_t stream) {
  const size_t smem = smem_bytes(m, c, ENERGY);
  auto kernel = streaming_kernel<NA, UNIFORM, ENERGY>;
  static size_t smem_allowed = 48 * 1024;  // raised once per variant, not per launch
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  kernel<<<m * m, kThreads, smem, stream>>>(f, fx, fy, fz, fstride, e, w, groups, m, c, box, k);
  return static_cast<int>(cudaGetLastError());
}

template <int NA>
int dispatch(const Fields& f, float* fx, float* fy, float* fz, int fstride, float* e, float* w,
             float* groups, int m, int c, const float* box, const PairConsts& k, int uniform,
             int energy, cudaStream_t s) {
  if (uniform && energy) return launch<NA, true, true>(f, fx, fy, fz, fstride, e, w, groups, m, c, box, k, s);
  if (uniform) return launch<NA, true, false>(f, fx, fy, fz, fstride, e, w, groups, m, c, box, k, s);
  if (energy) return launch<NA, false, true>(f, fx, fy, fz, fstride, e, w, groups, m, c, box, k, s);
  return launch<NA, false, false>(f, fx, fy, fz, fstride, e, w, groups, m, c, box, k, s);
}

}  // namespace

// The pair pass: centre sums (+ own-row reactions) into fx, fy, fz [, e, w]
// and the four reaction rows of every pencil into `groups` (4, n_r, M³·C).
extern "C" int emdee_streaming_forces(
    const float* px, const float* py, const float* pz, int pstride, const float* hs,
    const float* tse, const uint8_t* valid, float* fx, float* fy, float* fz, int fstride,
    float* e, float* w, float* groups, int m, int c, const float* box, float rc2, float rs2,
    float invd2, float a_m, float pa1, float pa2, float pb1, float pb2, float sig2_u,
    float eps4_u, int uniform, int energy, void* stream) {
  const size_t smem = smem_bytes(m, c, energy);
  if (m < 3 || c < 1 || c > 64 || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const PairConsts k{rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, sig2_u, eps4_u};
  const Fields f{px, py, pz, pstride, hs, tse, valid};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 32) return dispatch<1>(f, fx, fy, fz, fstride, e, w, groups, m, c, box, k, uniform, energy, s);
  return dispatch<2>(f, fx, fy, fz, fstride, e, w, groups, m, c, box, k, uniform, energy, s);
}

// The fold: adds the four reaction slices to the outputs in place.
extern "C" int emdee_streaming_fold(float* fx, float* fy, float* fz, int fstride, float* e,
                                    float* w, const float* groups, long ns, int energy,
                                    void* stream) {
  const int threads = 256;
  const long blocks = (ns + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (energy)
    fold_kernel<5><<<blocks, threads, 0, s>>>(fx, fy, fz, fstride, e, w, groups, ns);
  else
    fold_kernel<3><<<blocks, threads, 0, s>>>(fx, fy, fz, fstride, e, w, groups, ns);
  return static_cast<int>(cudaGetLastError());
}
