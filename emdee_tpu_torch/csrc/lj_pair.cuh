// Pair math shared by the port's force kernels (cell_forces.cu,
// cell_forces_streaming.cu, straggler_forces.cu): the constants of the
// switched 12-6 Lennard-Jones pair term, its Horner form, the
// uniform-parameter force factor, the minimum image of a raw difference,
// the molecular terms (DSF Coulomb and tag-borne harmonic bonds) of the
// K2c and K5c variants, and the bounding-box cull's predicate of K2c, K5c
// and K5s-mol.
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

constexpr int kMaxTags = 8;  // E ≤ 8: the band rule of cell_dense_molecular.py
constexpr float kTwoOverSqrtPi = 1.1283791670955126f;

// The molecular operands: per-slot charges and int32 atom ids, the centre
// tags (…, C, ne) and bond weights (…, C, neb), and the DSF constants as
// pointers to 0-d device tensors.
struct Mol {
  const float* q;
  const int* aid;
  const float *ids, *mlj, *mcs, *kb, *kr0, *kr02;
  int ne, neb;
  const float *alpha, *rc, *rc2, *e_shift, *f_shift, *kc;
};

// The DSF constants, read from the device once per thread.
struct Dsf {
  float alpha, rc, rc2, e_shift, f_shift, kc;
};

__device__ __forceinline__ Dsf load_dsf(const Mol& mol) {
  return Dsf{*mol.alpha, *mol.rc, *mol.rc2, *mol.e_shift, *mol.f_shift, *mol.kc};
}

// The molecular terms of one pair at r² below the larger cutoff, added to
// tot = −r·dE/dr and, with ENERGY, to esum: DSF Coulomb in its exact form
// (IEEE erfcf and expf, as the plain `coulomb_interaction`), zero at r² ≥
// rc_C², with qq = kC·qᵢ·qⱼ·(1 − Σ mcs); and the harmonic bond of the
// tag-matched weights (kbm, kr0m, kr02m), −r·dE/dr = kr0·r − kb·r² and E =
// ½(kb·r² + kr02) − kr0·r, only inside the LJ cutoff (`in_lj`), so that
// periodic images of a partner drop out.
template <bool COULOMB, bool BOND, bool ENERGY>
__device__ __forceinline__ void mol_terms(float r2, bool in_lj, float qq, const Dsf& d, float kbm, float kr0m,
                                          float kr02m, float& tot, float& esum) {
  if (!COULOMB && !BOND) return;
  const float r = sqrtf(r2);
  if (COULOMB && r2 < d.rc2) {
    const float ri = 1.0f / r;
    const float ar = d.alpha * r;
    const float erfc_ar = erfcf(ar);
    const float gauss = kTwoOverSqrtPi * d.alpha * expf(-ar * ar);
    const float g_r = erfc_ar * ri * ri + gauss * ri;
    tot += qq * r * (g_r - d.f_shift);
    if (ENERGY) esum += qq * (erfc_ar * ri - d.e_shift + d.f_shift * (r - d.rc));
  }
  if (BOND && in_lj) {
    tot += kr0m * r - kbm * r2;
    if (ENERGY) esum += 0.5f * (kbm * r2 + kr02m) - kr0m * r;
  }
}

// The cull's slack: each axis' gap to a box is lowered by this share of
// the magnitudes in play, far above the rounding of a displacement.
constexpr float kCullSlack = 1.0f / 524288.0f;  // 2⁻¹⁹

// Whether point p lies within the cutoff of the box [lo + o, hi + o],
// conservatively: each axis' gap less the slack, so that no pair whose
// computed r² lies below cut2 is dropped (mirrored by
// cell_kernel.cull_keep for the CPU tests).
__device__ __forceinline__ bool near_box(const float p[3], const float lo[3], const float hi[3], const float o[3],
                                         float cut2) {
  float g2 = 0.f;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const float gap = fmaxf(fmaxf((lo[v] + o[v]) - p[v], p[v] - (hi[v] + o[v])), 0.f);
    const float slack = kCullSlack * (fabsf(p[v]) + fabsf(lo[v]) + fabsf(hi[v]) + 2.f * fabsf(o[v]));
    const float g = fmaxf(gap - slack, 0.f);
    g2 += g * g;
  }
  return g2 < cut2;
}

}  // namespace emdee
