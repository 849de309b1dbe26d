// Aux side of the straggler pass (K3) for Hopper (sm_90a).
//
// Replaces: emdee_tpu/neighbors/pallas_cell_kernel.py — the straggler-side
// Newton reactions of the `strag_kn > 0` tile of `_make_kernel` (the `sro`
// rows, :849-857) with their fold onto the aux buffer
// (cell_dense_straggler.py `_fold_strag_react`, :238), and the
// straggler↔straggler all-pairs term (`_aux_pair_forces`, :254).  The grid
// side is the STRAG variant of cell_forces.cu.  Plain PyTorch version:
// emdee_tpu_torch/neighbors/straggler_kernel.py `aux_forces_plain`;
// wrapper: `straggler_forces`.
//
// What it computes.  A live aux atom (parked cell < M³) pairs with every
// live slot of its parked cell's 27 neighbor cells — 27·C candidates in a
// fixed (dz, dy, dx, slot) order — and then with every other live aux
// atom.  Differences are min-imaged raw differences d − L·rint(d/L); pairs
// at r² ≥ rc² are skipped.  Lane l of a warp sums candidates l, l+32, … of
// each list in its own partial sums, which a fixed xor-butterfly of warp
// shuffles adds up: no float atomics, so reruns are bitwise equal.  An
// empty aux lane writes exact zeros.  Between rebins the neighbor cells of
// the parked cell hold every grid atom within rc of the aux atom (neither
// has moved skin/2 since the rebin), so these are the grid side's pairs
// seen from the other end.
//
// Bound on this card: tiny work — at bench.py's production config (17 aux
// atoms, 931 aux-grid pairs inside the cutoff) the bytes bound it at
// ~0.04 µs.  One warp per aux slot walked 27·C/32 ≈ 24 rounds of dependent
// global loads (~25 µs a launch): latency-bound.
//
// Design.  One block per aux slot.  Its threads take the candidates one
// each (looping where 27·C or A exceeds the block) and stage, for each, the
// force factor and the three min-imaged differences — zeros for a skipped
// candidate — in shared memory: one round of independent loads.  Warp 0
// then sums the grid candidates and warp 1 the aux candidates, lane l
// taking entries l, l+32, … with the former kernel's expression and
// butterfly.  A staged zero adds +0 to a partial sum that starts at +0 and
// so is never −0 (a round-to-nearest sum is −0 only when both terms are):
// the sum is left exactly as the former kernel's `continue` left it, so
// the output is that kernel's bit for bit.
//
// `emdee_straggler_aux_warp` keeps the former design, one warp per aux
// slot, as the witness of those bits; no path of the engine calls it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lj_pair.cuh"

namespace {

using emdee::PairConsts;

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The staged terms of one candidate: force factor and min-imaged
// differences, or zeros where the candidate is skipped.
__device__ __forceinline__ float4 staged(float xa, float ya, float za, float xb, float yb, float zb,
                                         float box, const PairConsts& k) {
  const float dvx = emdee::min_image(xa - xb, box);
  const float dvy = emdee::min_image(ya - yb, box);
  const float dvz = emdee::min_image(za - zb, box);
  const float r2 = dvx * dvx + dvy * dvy + dvz * dvz;
  if (!(r2 < k.rc2)) return make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(emdee::uniform_force_factor(r2, k), dvx, dvy, dvz);
}

constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads) straggler_aux_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const uint8_t* __restrict__ valid,
    const float* __restrict__ ax, const float* __restrict__ ay,
    const float* __restrict__ az, const int* __restrict__ acell,
    float* __restrict__ afx, float* __restrict__ afy, float* __restrict__ afz,
    int m, int c, int a_cap, float box, PairConsts k) {
  __shared__ float4 grid_terms[kMaxThreads];  // this chunk's aux ↔ grid candidates
  __shared__ float4 aux_terms[kMaxThreads];   // this chunk's aux ↔ aux candidates
  __shared__ float aux_sum[3];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int a = blockIdx.x;
  const int nc = m * m * m;
  const int cell = acell[a];
  if (cell >= nc) {  // uniform across the block
    if (t == 0) afx[a] = afy[a] = afz[a] = 0.f;
    return;
  }
  const float xa = ax[a], ya = ay[a], za = az[a];
  const int cx = cell % m, cy = (cell / m) % m, cz = cell / (m * m);
  const int nq = 27 * c, n = nq > a_cap ? nq : a_cap, chunk = blockDim.x;
  float sx = 0.f, sy = 0.f, sz = 0.f;  // warp 0: aux ↔ grid; warp 1: aux ↔ aux
  for (int base = 0; base < n; base += chunk) {
    const int q = base + t;
    if (q < nq) {
      const int nb = q / c, j = q - nb * c;
      const int nx = (cx + nb % 3 - 1 + m) % m;
      const int ny = (cy + (nb / 3) % 3 - 1 + m) % m;
      const int nz = (cz + nb / 9 - 1 + m) % m;
      const long s = static_cast<long>(nx + m * (ny + m * nz)) * c + j;
      grid_terms[t] = valid[s] ? staged(xa, ya, za, px[s], py[s], pz[s], box, k)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (q < a_cap) {
      aux_terms[t] = q != a && acell[q] < nc ? staged(xa, ya, za, ax[q], ay[q], az[q], box, k)
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    if (warp < 2) {
      const float4* terms = warp == 0 ? grid_terms : aux_terms;
      const int len = min(chunk, (warp == 0 ? nq : a_cap) - base);
      for (int i = lane; i < len; i += 32) {
        const float4 e = terms[i];
        sx += e.x * e.y;
        sy += e.x * e.z;
        sz += e.x * e.w;
      }
    }
    __syncthreads();
  }
  if (warp < 2) {
    sx = warp_sum(sx);
    sy = warp_sum(sy);
    sz = warp_sum(sz);
  }
  if (t == 32) {
    aux_sum[0] = sx;
    aux_sum[1] = sy;
    aux_sum[2] = sz;
  }
  __syncthreads();
  if (t == 0) {
    afx[a] = sx + aux_sum[0];
    afy[a] = sy + aux_sum[1];
    afz[a] = sz + aux_sum[2];
  }
}

// The former design: one warp per aux slot, four slots per block.
__global__ void straggler_aux_warp_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const uint8_t* __restrict__ valid,
    const float* __restrict__ ax, const float* __restrict__ ay,
    const float* __restrict__ az, const int* __restrict__ acell,
    float* __restrict__ afx, float* __restrict__ afy, float* __restrict__ afz,
    int m, int c, int a_cap, float box, PairConsts k) {
  const int lane = threadIdx.x & 31;
  const int a = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (a >= a_cap) return;  // whole warp
  const int nc = m * m * m;
  const int cell = acell[a];
  float gx = 0.f, gy = 0.f, gz = 0.f;  // aux ↔ grid
  float hx = 0.f, hy = 0.f, hz = 0.f;  // aux ↔ aux
  if (cell < nc) {  // uniform across the warp
    const float xa = ax[a], ya = ay[a], za = az[a];
    const int cx = cell % m, cy = (cell / m) % m, cz = cell / (m * m);
    const int nq = 27 * c;
    for (int q = lane; q < nq; q += 32) {
      const int nb = q / c, j = q - nb * c;
      const int nx = (cx + nb % 3 - 1 + m) % m;
      const int ny = (cy + (nb / 3) % 3 - 1 + m) % m;
      const int nz = (cz + nb / 9 - 1 + m) % m;
      const long s = static_cast<long>(nx + m * (ny + m * nz)) * c + j;
      if (!valid[s]) continue;
      const float dvx = emdee::min_image(xa - px[s], box);
      const float dvy = emdee::min_image(ya - py[s], box);
      const float dvz = emdee::min_image(za - pz[s], box);
      const float r2 = dvx * dvx + dvy * dvy + dvz * dvz;
      if (!(r2 < k.rc2)) continue;
      const float gf = emdee::uniform_force_factor(r2, k);
      gx += gf * dvx;
      gy += gf * dvy;
      gz += gf * dvz;
    }
    for (int b = lane; b < a_cap; b += 32) {
      if (b == a || acell[b] >= nc) continue;
      const float dvx = emdee::min_image(xa - ax[b], box);
      const float dvy = emdee::min_image(ya - ay[b], box);
      const float dvz = emdee::min_image(za - az[b], box);
      const float r2 = dvx * dvx + dvy * dvy + dvz * dvz;
      if (!(r2 < k.rc2)) continue;
      const float gf = emdee::uniform_force_factor(r2, k);
      hx += gf * dvx;
      hy += gf * dvy;
      hz += gf * dvz;
    }
  }
  gx = warp_sum(gx);
  gy = warp_sum(gy);
  gz = warp_sum(gz);
  hx = warp_sum(hx);
  hy = warp_sum(hy);
  hz = warp_sum(hz);
  if (lane == 0) {
    afx[a] = gx + hx;
    afy[a] = gy + hy;
    afz[a] = gz + hz;
  }
}

}  // namespace

extern "C" int emdee_straggler_aux(
    const float* px, const float* py, const float* pz, const uint8_t* valid,
    const float* ax, const float* ay, const float* az, const int* acell,
    float* afx, float* afy, float* afz, int m, int c, int a_cap, float box,
    float rc2, float rs2, float invd2, float a_m, float pa1, float pa2,
    float pb1, float pb2, float sig2_u, float eps4_u, void* stream) {
  if (m < 3 || c < 1 || a_cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const PairConsts k{rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, sig2_u, eps4_u};
  const int n = 27 * c > a_cap ? 27 * c : a_cap;
  const int threads = n >= kMaxThreads ? kMaxThreads : (n <= 64 ? 64 : (n + 31) / 32 * 32);
  straggler_aux_kernel<<<a_cap, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      px, py, pz, valid, ax, ay, az, acell, afx, afy, afz, m, c, a_cap, box, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int emdee_straggler_aux_warp(
    const float* px, const float* py, const float* pz, const uint8_t* valid,
    const float* ax, const float* ay, const float* az, const int* acell,
    float* afx, float* afy, float* afz, int m, int c, int a_cap, float box,
    float rc2, float rs2, float invd2, float a_m, float pa1, float pa2,
    float pb1, float pb2, float sig2_u, float eps4_u, void* stream) {
  if (m < 3 || c < 1 || a_cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const PairConsts k{rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, sig2_u, eps4_u};
  const int blocks = (a_cap + kWarpsPerBlock - 1) / kWarpsPerBlock;
  straggler_aux_warp_kernel<<<blocks, 32 * kWarpsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      px, py, pz, valid, ax, ay, az, acell, afx, afy, afz, m, c, a_cap, box, k);
  return static_cast<int>(cudaGetLastError());
}
