// Dense-cell Lennard-Jones force kernel for Hopper (sm_90a).
//
// Replaces: emdee_tpu/neighbors/pallas_cell_kernel.py — the pair math of
// `_build_pair_pass` (K1) inside the half-shell kernel `_make_kernel` /
// `halfshell_call`, as entered by `pallas_cell_forces_split` (K2a: uniform
// parameters, forces only, component arrays) and `pallas_cell_forces`
// (K2b: per-atom (σ/2, 2√ε), optional per-slot energies and virials).
// Plain PyTorch version: emdee_tpu_torch/neighbors/cell_dense.py
// `cell_dense_forces`; wrapper: emdee_tpu_torch/neighbors/cell_kernel.py.
//
// Design.  One block per cell (M³ blocks), one thread per center slot (C
// rounded up to a warp; tail threads only help stage).  The block walks the
// 27 neighbor cells in a fixed (dz, dy, dx) order, stages each one's C slots
// in shared memory, and every thread runs the pair math of its center slot
// against them.  A neighbor index that wraps the periodic grid shifts that
// cell's coordinates by ±box on that axis (the TPU kernel's ghost copies);
// atoms are never wrapped, because between rebins positions overhang the
// box by up to skin/2.  Empty slots are skipped through the valid mask, the
// self pair (same cell, same slot) is skipped, and an empty center slot
// writes exact zeros.
//
// Full shell, not half shell: each pair is evaluated from both sides, twice
// the TPU kernel's pair work, in exchange for no atomics, no reaction buffer
// and no fold.  Every sum runs in a fixed order, so results are bitwise
// reproducible run to run (the engine's determinism contract).
//
// Numerics: the TPU kernel's Horner form of the switched −r·dE/dr in r²,
// tot = t12·pa(x) − t6·pb(x), with an exact IEEE 1/r² (no fast math, no
// approximate reciprocal).  It agrees with `pair_interaction` to float32
// roundoff.  Pairs at r² ≥ rc² are skipped: the switch is exactly zero there
// in the plain version, and the Horner polynomials are zero only to roundoff.
//
// Bound on this card: at the 97,556-atom melt (M = 17, C = 32) a launch
// evaluates 4,913 × 32 × 864 ≈ 136 M candidate pairs, of which about 6% lie
// inside the cutoff — arithmetic on registers and broadcast shared-memory
// reads, with ~1.3 MB of inputs.  One 32-thread block per cell caps
// residency at 32 warps per SM (half of 64); that, and the doubled pair work,
// are what a later half-shell, multi-cell-per-block kernel would buy back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct PairConsts {
  float rc2, rs2, invd2;
  float a_m, pa1, pa2, pb1, pb2;  // Horner constants: a_m, a_m+60, 60+2a_m, a_m−30, 2a_m
  float sig2_u, eps4_u;           // uniform-parameter σ² and 4ε
};

template <bool UNIFORM, bool ENERGY>
__global__ void cell_forces_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, int pstride,
    const float* __restrict__ hs, const float* __restrict__ tse,
    const uint8_t* __restrict__ valid,
    float* __restrict__ fx, float* __restrict__ fy, float* __restrict__ fz,
    int fstride, float* __restrict__ e_out, float* __restrict__ w_out,
    int m, int c, float box, PairConsts k) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + c;
  float* sz = sy + c;
  float* shs = sz + c;
  float* stse = shs + c;
  uint8_t* sv = reinterpret_cast<uint8_t*>(stse + c);

  const int cell = blockIdx.x;
  const int i = threadIdx.x;
  const int cx = cell % m, cy = (cell / m) % m, cz = cell / (m * m);
  const long own = static_cast<long>(cell) * c + i;
  const bool center = i < c && valid[own];

  float xi = 0.f, yi = 0.f, zi = 0.f, hsi = 0.f, tsei = 0.f;
  if (center) {
    xi = px[own * pstride];
    yi = py[own * pstride];
    zi = pz[own * pstride];
    if (!UNIFORM) {
      hsi = hs[own];
      tsei = tse[own];
    }
  }
  float fxa = 0.f, fya = 0.f, fza = 0.f, ea = 0.f, wa = 0.f;

  for (int dz = -1; dz <= 1; ++dz) {
    int nz = cz + dz;
    float shz = 0.f;
    if (nz < 0) { nz += m; shz = -box; } else if (nz >= m) { nz -= m; shz = box; }
    for (int dy = -1; dy <= 1; ++dy) {
      int ny = cy + dy;
      float shy = 0.f;
      if (ny < 0) { ny += m; shy = -box; } else if (ny >= m) { ny -= m; shy = box; }
      for (int dx = -1; dx <= 1; ++dx) {
        int nx = cx + dx;
        float shx = 0.f;
        if (nx < 0) { nx += m; shx = -box; } else if (nx >= m) { nx -= m; shx = box; }
        const long nb = static_cast<long>(nx + m * (ny + m * nz)) * c;

        __syncthreads();  // the previous neighbor cell is consumed
        if (i < c) {
          const long s = nb + i;
          sv[i] = valid[s];
          sx[i] = px[s * pstride] + shx;
          sy[i] = py[s * pstride] + shy;
          sz[i] = pz[s * pstride] + shz;
          if (!UNIFORM) {
            shs[i] = hs[s];
            stse[i] = tse[s];
          }
        }
        __syncthreads();
        if (!center) continue;

        const bool self_cell = dz == 0 && dy == 0 && dx == 0;
        for (int j = 0; j < c; ++j) {
          if (!sv[j] || (self_cell && j == i)) continue;
          const float dvx = xi - sx[j];
          const float dvy = yi - sy[j];
          const float dvz = zi - sz[j];
          const float r2 = dvx * dvx + dvy * dvy + dvz * dvz;
          if (!(r2 < k.rc2)) continue;
          const float rinv = 1.0f / r2;
          float t6, s6;
          if (UNIFORM) {
            const float s2 = k.sig2_u * rinv;
            s6 = s2 * s2 * s2;
            t6 = k.eps4_u * s6;
          } else {
            const float sig = hsi + shs[j];
            const float s2 = sig * sig * rinv;
            s6 = s2 * s2 * s2;
            t6 = (tsei * stse[j]) * s6;
          }
          const float t12 = t6 * s6;
          const float x = fminf(fmaxf((r2 - k.rs2) * k.invd2, 0.f), 1.f);
          const float pa = ((((-12.f * x + k.pa1) * x - k.pa2) * x + k.a_m) * x) * x + 12.f;
          const float pb = ((((24.f * x + k.pb1) * x - k.pb2) * x + k.a_m) * x) * x + 6.f;
          const float tot = t12 * pa - t6 * pb;  // switched −r·dE/dr
          const float gf = tot * rinv;
          fxa += gf * dvx;
          fya += gf * dvy;
          fza += gf * dvz;
          if (ENERGY) {
            const float gsw = 1.f + (x * x * x) * ((-6.f * x + 15.f) * x - 10.f);
            ea += 0.5f * ((t12 - t6) * gsw);
            wa += 0.5f * tot;
          }
        }
      }
    }
  }
  if (i < c) {
    fx[own * fstride] = fxa;
    fy[own * fstride] = fya;
    fz[own * fstride] = fza;
    if (ENERGY) {
      e_out[own] = ea;
      w_out[own] = wa;
    }
  }
}

template <bool UNIFORM, bool ENERGY>
void launch(const float* px, const float* py, const float* pz, int pstride,
            const float* hs, const float* tse, const uint8_t* valid, float* fx,
            float* fy, float* fz, int fstride, float* e, float* w, int m,
            int c, float box, const PairConsts& k, cudaStream_t stream) {
  const int threads = ((c + 31) / 32) * 32;
  const size_t smem = 5 * sizeof(float) * c + c;
  cell_forces_kernel<UNIFORM, ENERGY><<<m * m * m, threads, smem, stream>>>(
      px, py, pz, pstride, hs, tse, valid, fx, fy, fz, fstride, e, w, m, c,
      box, k);
}

}  // namespace

extern "C" int emdee_cell_forces(
    const float* px, const float* py, const float* pz, int pstride,
    const float* hs, const float* tse, const uint8_t* valid, float* fx,
    float* fy, float* fz, int fstride, float* e, float* w, int m, int c,
    float box, float rc2, float rs2, float invd2, float a_m, float pa1,
    float pa2, float pb1, float pb2, float sig2_u, float eps4_u, int uniform,
    int energy, void* stream) {
  if (m < 3 || c < 1 || c > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const PairConsts k{rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, sig2_u, eps4_u};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uniform && energy)
    launch<true, true>(px, py, pz, pstride, hs, tse, valid, fx, fy, fz, fstride, e, w, m, c, box, k, s);
  else if (uniform)
    launch<true, false>(px, py, pz, pstride, hs, tse, valid, fx, fy, fz, fstride, e, w, m, c, box, k, s);
  else if (energy)
    launch<false, true>(px, py, pz, pstride, hs, tse, valid, fx, fy, fz, fstride, e, w, m, c, box, k, s);
  else
    launch<false, false>(px, py, pz, pstride, hs, tse, valid, fx, fy, fz, fstride, e, w, m, c, box, k, s);
  return static_cast<int>(cudaGetLastError());
}
