// Pair math shared by the port's force kernels (cell_forces.cu,
// straggler_forces.cu): the constants of the switched 12-6 Lennard-Jones
// pair term, its Horner form, the uniform-parameter force factor, and the
// minimum image of a raw difference.
#pragma once

#include <cuda_runtime.h>

namespace emdee {

struct PairConsts {
  float rc2, rs2, invd2;
  float a_m, pa1, pa2, pb1, pb2;  // Horner constants: a_m, a_m+60, 60+2a_m, a_m−30, 2a_m
  float sig2_u, eps4_u;           // uniform-parameter σ² and 4ε
};

// d − L·rint(d/L), each operation rounded on its own (no contraction), as
// the plain version computes it: exact for pairs within half a box.
__device__ __forceinline__ float min_image(float d, float box) {
  return __fsub_rn(d, __fmul_rn(rintf(__fdiv_rn(d, box)), box));
}

// Switched −r·dE/dr of one pair at r² < rc², tot = t12·pa(x) − t6·pb(x):
// the TPU kernel's Horner form in r² (pallas_cell_kernel.py
// `_build_pair_pass`), given s6 = (σ²/r²)³ and t6 = 4ε·s6.  Also returns
// t12 and the switch argument x, which the energy needs.
__device__ __forceinline__ float switched_tot(float r2, float t6, float s6, const PairConsts& k,
                                              float& t12, float& x) {
  t12 = t6 * s6;
  x = fminf(fmaxf((r2 - k.rs2) * k.invd2, 0.f), 1.f);
  const float pa = ((((-12.f * x + k.pa1) * x - k.pa2) * x + k.a_m) * x) * x + 12.f;
  const float pb = ((((24.f * x + k.pb1) * x - k.pb2) * x + k.a_m) * x) * x + 6.f;
  return t12 * pa - t6 * pb;
}

// Switched −r·dE/dr over r² for one pair at r² < rc² with the uniform
// parameters, with an exact IEEE 1/r².  Force on i is this times (r_i − r_j).
__device__ __forceinline__ float uniform_force_factor(float r2, const PairConsts& k) {
  const float rinv = 1.0f / r2;
  const float s2 = k.sig2_u * rinv;
  const float s6 = s2 * s2 * s2;
  float t12, x;
  return switched_tot(r2, k.eps4_u * s6, s6, k, t12, x) * rinv;
}

}  // namespace emdee
