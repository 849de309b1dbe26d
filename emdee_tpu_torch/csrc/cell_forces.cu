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
// against them.  A neighbor index that wraps the periodic grid takes ±box
// off that axis's raw difference, (x_i − x_j) − shift (the TPU kernel's
// ghost copies, applied after the difference so that a pair inside the
// cutoff gets the plain version's minimum image bit for bit); atoms are
// never wrapped, because between rebins positions overhang the box by up to
// skin/2.  Empty slots are skipped through the valid mask, the
// self pair (same cell, same slot) is skipped, and an empty center slot
// writes exact zeros.  The box is read from a 0-d float32 device tensor (the
// NPT engine's dynamic box, or the static box held on the device), so no
// launch waits for a host read of it.
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
// STRAG (the grid side of the straggler pass, K3 — the `strag_kn > 0` tile
// of `_make_kernel`, pallas_cell_kernel.py:620-670 and :807-862; uniform
// parameters, forces only): after the 27 cells the block stages the ≤ Kn aux
// atoms that the (M², Kn) int32 list table holds for its pencil row
// (z·M + y) and every center thread adds those pairs in list order, on
// min-imaged raw differences d − L·rint(d/L) (aux atoms are parked outside
// the grid and carry no ghost shift).  The aux side of the same pairs is
// straggler_forces.cu; each side evaluates each pair once, so there is no
// reaction fold.  Plain version: emdee_tpu_torch/neighbors/straggler_kernel.py
// `grid_forces_plain`.
//
// GHOST (the grid-sharded engine's per-shard force pass, in place of
// emdee_tpu/distributed/grid_sharded.py `_local_forces_pallas` and the
// energy pass of `_local_energy_pallas`, which run K2's half shell with
// reaction ghosts and a reverse fold): the block's neighbours come from a
// shard's (mz+2, my+2, mx+2, C) ghost grid, stacked over the local shards,
// whose positions carry NaN in empty slots (the validity mask).  The block
// walks the same 27 cells in the same order, and takes the periodic shift
// from the neighbour's GLOBAL cell index (the shard's offset plus the local
// index), the raw ghost coordinates unshifted — so every displacement is
// (x_i − x_j) − shift and the forces of any decomposition equal the
// one-card kernel's bit for bit.  Full shell, so no reaction rows, no fold
// and no second exchange.  Plain version:
// emdee_tpu_torch/neighbors/cell_kernel.py `ghost_forces_plain`.
//
// GHOST with COULOMB/EXCL (K2c-G: the molecular branches inside the grid's
// per-shard pass, `_local_forces_pallas` :629-656 and `_local_energy_pallas`
// :704-768 of grid_sharded.py), entered through
// `emdee_cell_forces_ghost_mol`: the ghost grids also carry each slot's
// charge and int32 atom id (−2 on empty slots), staged like the resident
// mode's; the centre tags are per own slot; no bond tags (the grid keeps
// its bonds as term rows, as the reference does).  The pair math and the
// order of every sum are the per-atom path's, so the forces of any
// decomposition equal the one-card K2c-q's bit for bit.
//
// COULOMB, EXCL, BOND (the molecular branches of `_build_pair_pass`: K2c-q,
// `coulomb` :420-424, :525-551 and `excl_e`/`excl_cs` :459-488; K2c-b,
// `excl_eb` :468-487, :502-523; centre tags as `_unpack_centers` :347 lays
// them out), on the per-atom path (not STRAG), entered through
// `emdee_cell_forces_mol` (and, without BOND, in GHOST mode above).  Each staged neighbour cell also brings its
// charges and int32 atom ids to shared memory; each centre keeps its E ≤ 8
// exclusion tags (partner atom id, 1 − s_LJ, 1 − s_C) and its first E_b
// bond weights (k, k·r0, k·r0²) in registers and matches them on integer
// ids.  A matched pair scales the LJ t6 by 1 − Σ mlj and qq by 1 − Σ mcs;
// a matched bond tag adds −r·dE/dr = k·r0·r − k·r² and E = ½(k·r² + k·r0²)
// − k·r0·r, masked to r² < rc² (periodic images of a partner drop out).
// DSF Coulomb is the exact form with IEEE erfcf and expf, as the plain
// `coulomb_interaction` (the reference's XLA path, not its degree-10 fit),
// zero at r² ≥ rc_C²; its constants are read from 0-d device tensors
// (`emdee::mol_terms`, lj_pair.cuh, shared with the streaming kernel).
// Pairs are skipped beyond the larger of the two squared cutoffs; LJ and
// the bonds take only pairs inside rc².  Plain version: cell_dense.py
// `cell_dense_forces(coulomb=, excl=)`.  At the 98,304-atom water box
// (M = 12, C = 64) a launch walks 1,728 × 64 × 27 × 64 ≈ 191 M candidates,
// and every pair inside the cutoff pays an erfc, an exp, a square root and
// 3E tag operations; chip_smoke.py counts the pairs and gives the bound.
//
// Bound on this card: at the 97,556-atom melt (M = 17, C = 32) a launch
// evaluates 4,913 × 32 × 864 ≈ 136 M candidate pairs, of which about 6% lie
// inside the cutoff — arithmetic on registers and broadcast shared-memory
// reads, with ~1.3 MB of inputs.  One 32-thread block per cell caps
// residency at 32 warps per SM (half of 64).  The half-shell kernel
// (cell_forces_streaming.cu, K5) halves the pair work and is not faster at
// this size (chip_smoke.py times both).
// The least time for the work is ~2 µs (2.63 M unique pairs inside the
// cutoff at ~51 float32 operations each, at 67 TFLOP/s; chip_smoke.py counts
// them); a launch takes ~0.18 ms, the same at C_t = 28 with STRAG as at
// C = 32, so the candidate-pair count does not set its time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lj_pair.cuh"

namespace {

using emdee::Dsf;
using emdee::kMaxTags;
using emdee::Mol;
using emdee::PairConsts;

// GHOST geometry: local cells (mz, my, mx) per shard, the local shards'
// grid (sy_n, sx_n after the leading z count), and the global coordinates
// (bz, by, bx) of the first local shard.
struct Ghost {
  int mz, my, mx, sy_n, sx_n, bz, by, bx;
};

template <bool UNIFORM, bool ENERGY, bool STRAG, bool GHOST, bool COULOMB = false, bool EXCL = false,
          bool BOND = false>
__global__ void cell_forces_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, int pstride,
    const float* __restrict__ hs, const float* __restrict__ tse,
    const uint8_t* __restrict__ valid,
    float* __restrict__ fx, float* __restrict__ fy, float* __restrict__ fz,
    int fstride, float* __restrict__ e_out, float* __restrict__ w_out,
    const float* __restrict__ ax, const float* __restrict__ ay,
    const float* __restrict__ az, const int* __restrict__ table, int kn,
    int m, int c, const float* __restrict__ box_ptr, PairConsts k, Ghost g, Mol mol) {
  extern __shared__ float smem[];
  const float box = *box_ptr;
  float* sx = smem;
  float* sy = sx + c;
  float* sz = sy + c;
  float* shs = sz + c;
  float* stse = shs + c;
  float* sq = stse + c;  // the molecular fields (COULOMB or EXCL only)
  int* said = reinterpret_cast<int*>(sq + c);
  float* sax = (COULOMB || EXCL) ? reinterpret_cast<float*>(said + c) : sq;  // the STRAG list (kn = 0 otherwise)
  float* say = sax + kn;
  float* saz = say + kn;
  uint8_t* sv = reinterpret_cast<uint8_t*>(saz + kn);
  uint8_t* sav = sv + c;

  const int cell = blockIdx.x;
  const int i = threadIdx.x;
  // Global cell coordinates; GHOST: the cell's local coordinates and its
  // shard's first ghost cell.
  int cx, cy, cz, lx = 0, ly = 0, lz = 0;
  long gbase = 0;
  if (GHOST) {
    lx = cell % g.mx;
    ly = (cell / g.mx) % g.my;
    const int r = cell / (g.mx * g.my);
    lz = r % g.mz;
    const int s = r / g.mz;
    cx = (g.bx + s % g.sx_n) * g.mx + lx;
    cy = (g.by + (s / g.sx_n) % g.sy_n) * g.my + ly;
    cz = (g.bz + s / (g.sx_n * g.sy_n)) * g.mz + lz;
    gbase = static_cast<long>(s) * (g.mz + 2) * (g.my + 2) * (g.mx + 2);
  } else {
    cx = cell % m;
    cy = (cell / m) % m;
    cz = cell / (m * m);
  }
  const long own = static_cast<long>(cell) * c + i;
  // The center slot's input index (GHOST: in the ghost grid's interior).
  const long in_own = GHOST ? (gbase + ((lz + 1) * (g.my + 2) + ly + 1) * (g.mx + 2) + lx + 1) * c + i
                            : own;
  bool center = false;
  float xi = 0.f, yi = 0.f, zi = 0.f, hsi = 0.f, tsei = 0.f;
  if (i < c) {
    if (GHOST) {
      xi = px[in_own];
      center = !isnan(xi);
    } else {
      center = valid[own];
    }
  }
  if (center) {
    xi = px[in_own * pstride];
    yi = py[in_own * pstride];
    zi = pz[in_own * pstride];
    if (!UNIFORM) {
      hsi = hs[in_own];
      tsei = tse[in_own];
    }
  }
  float fxa = 0.f, fya = 0.f, fza = 0.f, ea = 0.f, wa = 0.f;

  // Molecular centre operands: charge, tags and bond weights in registers
  // (GHOST: the charge from the ghost grid's interior, the tags per own slot).
  float qi = 0.f;
  Dsf dsf{};
  int tid[kMaxTags];
  float tmlj[kMaxTags], tmcs[kMaxTags], tkb[kMaxTags], tkr0[kMaxTags], tkr02[kMaxTags];
  float cut2 = k.rc2;
  if (COULOMB) {
    dsf = emdee::load_dsf(mol);
    cut2 = fmaxf(cut2, dsf.rc2);
    if (center) qi = mol.q[in_own];
  }
#pragma unroll
  for (int t = 0; t < kMaxTags; ++t) {
    tid[t] = -1;
    tmlj[t] = tmcs[t] = tkb[t] = tkr0[t] = tkr02[t] = 0.f;
    if (EXCL && center && t < mol.ne) {
      const long at = own * mol.ne + t;
      tid[t] = __float2int_rn(mol.ids[at]);
      tmlj[t] = mol.mlj[at];
      if (COULOMB) tmcs[t] = mol.mcs[at];
    }
    if (BOND && center && t < mol.neb) {
      const long at = own * mol.neb + t;
      tkb[t] = mol.kb[at];
      tkr0[t] = mol.kr0[at];
      if (ENERGY) tkr02[t] = mol.kr02[at];
    }
  }

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
        const long nb = GHOST ? (gbase + ((lz + 1 + dz) * (g.my + 2) + ly + 1 + dy) * (g.mx + 2) + lx + 1 + dx) * c
                              : static_cast<long>(nx + m * (ny + m * nz)) * c;

        __syncthreads();  // the previous neighbor cell is consumed
        if (i < c) {
          const long s = nb + i;
          sx[i] = px[s * pstride];
          sv[i] = GHOST ? !isnan(sx[i]) : valid[s];
          sy[i] = py[s * pstride];
          sz[i] = pz[s * pstride];
          if (!UNIFORM) {
            shs[i] = hs[s];
            stse[i] = tse[s];
          }
          if (COULOMB) sq[i] = mol.q[s];
          if (EXCL) said[i] = mol.aid[s];
        }
        __syncthreads();
        if (!center) continue;

        const bool self_cell = dz == 0 && dy == 0 && dx == 0;
        for (int j = 0; j < c; ++j) {
          if (!sv[j] || (self_cell && j == i)) continue;
          const float dvx = (xi - sx[j]) - shx;
          const float dvy = (yi - sy[j]) - shy;
          const float dvz = (zi - sz[j]) - shz;
          const float r2 = dvx * dvx + dvy * dvy + dvz * dvz;
          if (!(r2 < cut2)) continue;
          const float rinv = 1.0f / r2;
          // Tag matches: the LJ and Coulomb scales and the bond weights.
          float ljsc = 1.f, csc = 1.f, kbm = 0.f, kr0m = 0.f, kr02m = 0.f;
          if (EXCL) {
            const int aj = said[j];
#pragma unroll
            for (int t = 0; t < kMaxTags; ++t) {
              if (tid[t] != aj) continue;  // pad tags hold −1, never an atom id
              ljsc -= tmlj[t];
              if (COULOMB) csc -= tmcs[t];
              if (BOND) {
                kbm += tkb[t];
                kr0m += tkr0[t];
                if (ENERGY) kr02m += tkr02[t];
              }
            }
          }
          float tot = 0.f, esum = 0.f;
          const bool in_lj = !COULOMB || r2 < k.rc2;  // cut2 is rc² without COULOMB
          if (in_lj) {
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
            if (EXCL) t6 *= ljsc;
            float t12, x;
            tot = emdee::switched_tot(r2, t6, s6, k, t12, x);
            if (ENERGY) esum = (t12 - t6) * (1.f + (x * x * x) * ((-6.f * x + 15.f) * x - 10.f));
          }
          emdee::mol_terms<COULOMB, BOND, ENERGY>(r2, in_lj, COULOMB ? dsf.kc * qi * sq[j] * csc : 0.f, dsf, kbm,
                                                  kr0m, kr02m, tot, esum);
          const float gf = tot * rinv;
          fxa += gf * dvx;
          fya += gf * dvy;
          fza += gf * dvz;
          if (ENERGY) {
            ea += 0.5f * esum;
            wa += 0.5f * tot;
          }
        }
      }
    }
  }
  if (STRAG) {
    __syncthreads();  // the last neighbor cell is consumed
    const long row = cell / m;  // pencil row z·M + y
    for (int s = i; s < kn; s += blockDim.x) {
      const int a = table[row * kn + s];
      sav[s] = a >= 0;
      sax[s] = a >= 0 ? ax[a] : 0.f;
      say[s] = a >= 0 ? ay[a] : 0.f;
      saz[s] = a >= 0 ? az[a] : 0.f;
    }
    __syncthreads();
    if (center) {
      for (int s = 0; s < kn; ++s) {
        if (!sav[s]) continue;
        const float dvx = emdee::min_image(xi - sax[s], box);
        const float dvy = emdee::min_image(yi - say[s], box);
        const float dvz = emdee::min_image(zi - saz[s], box);
        const float r2 = dvx * dvx + dvy * dvy + dvz * dvz;
        if (!(r2 < k.rc2)) continue;
        const float gf = emdee::uniform_force_factor(r2, k);
        fxa += gf * dvx;
        fya += gf * dvy;
        fza += gf * dvz;
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

template <bool UNIFORM, bool ENERGY, bool STRAG = false, bool GHOST = false>
void launch(const float* px, const float* py, const float* pz, int pstride,
            const float* hs, const float* tse, const uint8_t* valid, float* fx,
            float* fy, float* fz, int fstride, float* e, float* w, int m,
            int c, const float* box, const PairConsts& k, cudaStream_t stream,
            const float* ax = nullptr, const float* ay = nullptr,
            const float* az = nullptr, const int* table = nullptr, int kn = 0,
            const Ghost& g = Ghost{}, int blocks = 0, const Mol& mol = Mol{}) {
  const int threads = ((c + 31) / 32) * 32;
  const size_t smem = sizeof(float) * (5 * c + 3 * kn) + c + kn;
  cell_forces_kernel<UNIFORM, ENERGY, STRAG, GHOST><<<GHOST ? blocks : m * m * m, threads, smem, stream>>>(
      px, py, pz, pstride, hs, tse, valid, fx, fy, fz, fstride, e, w, ax, ay,
      az, table, kn, m, c, box, k, g, mol);
}

// The molecular variants: per-atom parameters, stacked positions and forces.
template <bool ENERGY, bool COULOMB, bool EXCL, bool BOND>
void launch_mol(const float* px, const float* hs, const float* tse, const uint8_t* valid, float* f,
                float* e, float* w, int m, int c, const float* box, const PairConsts& k, const Mol& mol,
                cudaStream_t stream) {
  const int threads = ((c + 31) / 32) * 32;
  const size_t smem = sizeof(float) * 7 * c + c;
  cell_forces_kernel<false, ENERGY, false, false, COULOMB, EXCL, BOND><<<m * m * m, threads, smem, stream>>>(
      px, px + 1, px + 2, 3, hs, tse, valid, f, f + 1, f + 2, 3, e, w, nullptr, nullptr, nullptr, nullptr, 0,
      m, c, box, k, Ghost{}, mol);
}

// The GHOST mode's molecular variants (K2c-G): per-atom parameters; the
// charges and the int32 atom ids (a bit view in the float32 ghost stack)
// from the ghost grids, the centre tags per own slot; no bond tags (the
// grid keeps its bonds as term rows).
template <bool ENERGY, bool COULOMB, bool EXCL>
void launch_ghost_mol(const float* px, const float* py, const float* pz, const float* hs, const float* tse,
                      float* fx, float* fy, float* fz, float* e, float* w, int m, int c, const float* box,
                      const PairConsts& k, const Ghost& g, int blocks, const Mol& mol, cudaStream_t stream) {
  const int threads = ((c + 31) / 32) * 32;
  const size_t smem = sizeof(float) * 7 * c + c;
  cell_forces_kernel<false, ENERGY, false, true, COULOMB, EXCL, false><<<blocks, threads, smem, stream>>>(
      px, py, pz, 1, hs, tse, nullptr, fx, fy, fz, 1, e, w, nullptr, nullptr, nullptr, nullptr, 0, m, c, box, k,
      g, mol);
}

template <bool ENERGY>
void dispatch_mol(int coulomb, int excl, int bond, const float* px, const float* hs, const float* tse,
                  const uint8_t* valid, float* f, float* e, float* w, int m, int c, const float* box,
                  const PairConsts& k, const Mol& mol, cudaStream_t s) {
  if (coulomb && bond)
    launch_mol<ENERGY, true, true, true>(px, hs, tse, valid, f, e, w, m, c, box, k, mol, s);
  else if (coulomb && excl)
    launch_mol<ENERGY, true, true, false>(px, hs, tse, valid, f, e, w, m, c, box, k, mol, s);
  else if (coulomb)
    launch_mol<ENERGY, true, false, false>(px, hs, tse, valid, f, e, w, m, c, box, k, mol, s);
  else if (bond)
    launch_mol<ENERGY, false, true, true>(px, hs, tse, valid, f, e, w, m, c, box, k, mol, s);
  else
    launch_mol<ENERGY, false, true, false>(px, hs, tse, valid, f, e, w, m, c, box, k, mol, s);
}

}  // namespace

extern "C" int emdee_cell_forces(
    const float* px, const float* py, const float* pz, int pstride,
    const float* hs, const float* tse, const uint8_t* valid, float* fx,
    float* fy, float* fz, int fstride, float* e, float* w, int m, int c,
    const float* box, float rc2, float rs2, float invd2, float a_m, float pa1,
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

// The molecular entry (K2c): stacked positions and forces (M³, C, 3),
// per-atom (σ/2, 2√ε), optional per-slot energies and virials; q (M³, C)
// charges and the DSF constants' device pointers with `coulomb`; aid (M³,
// C) int32 atom ids and the tags (M³, C, ne) with `excl` (mcs only with
// `coulomb`); the bond weights (M³, C, neb) with `bond` (kr02 only with
// `energy`).
extern "C" int emdee_cell_forces_mol(
    const float* pos, const float* hs, const float* tse, const uint8_t* valid, const float* q,
    const int* aid, const float* ids, const float* mlj, const float* mcs, const float* kb,
    const float* kr0, const float* kr02, int ne, int neb, const float* alpha, const float* rc,
    const float* rc2_c, const float* e_shift, const float* f_shift, const float* kc, float* f, float* e,
    float* w, int m, int c, const float* box, float rc2, float rs2, float invd2, float a_m, float pa1,
    float pa2, float pb1, float pb2, int coulomb, int excl, int bond, int energy, void* stream) {
  if (m < 3 || c < 1 || c > 1024 || (!coulomb && !excl) || (bond && !excl) ||
      (excl && (ne < 1 || ne > kMaxTags)) || (bond && (neb < 1 || neb > ne)))
    return static_cast<int>(cudaErrorInvalidValue);
  const PairConsts k{rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, 0.f, 0.f};
  const Mol mol{q, aid, ids, mlj, mcs, kb, kr0, kr02, excl ? ne : 0, bond ? neb : 0,
                alpha, rc, rc2_c, e_shift, f_shift, kc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (energy)
    dispatch_mol<true>(coulomb, excl, bond, pos, hs, tse, valid, f, e, w, m, c, box, k, mol, s);
  else
    dispatch_mol<false>(coulomb, excl, bond, pos, hs, tse, valid, f, e, w, m, c, box, k, mol, s);
  return static_cast<int>(cudaGetLastError());
}

// The STRAG variant: component arrays (stride 1), uniform parameters,
// forces only, plus the aux coordinates (A,) and the (M², kn) list table.
extern "C" int emdee_cell_forces_strag(
    const float* px, const float* py, const float* pz, const uint8_t* valid,
    float* fx, float* fy, float* fz, const float* ax, const float* ay,
    const float* az, const int* table, int kn, int m, int c, const float* box,
    float rc2, float rs2, float invd2, float a_m, float pa1, float pa2,
    float pb1, float pb2, float sig2_u, float eps4_u, void* stream) {
  if (m < 3 || c < 1 || c > 1024 || kn < 1 || kn > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  const PairConsts k{rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, sig2_u, eps4_u};
  launch<true, false, true>(px, py, pz, 1, nullptr, nullptr, valid, fx, fy, fz, 1,
                            nullptr, nullptr, m, c, box, k,
                            static_cast<cudaStream_t>(stream), ax, ay, az, table, kn);
  return static_cast<int>(cudaGetLastError());
}

// The GHOST mode: the ghost grids of `shards` local shards, px … tse each
// (shards, mz+2, my+2, mx+2, C) float32 with NaN positions in empty slots
// (hs, tse unused with uniform parameters); outputs (shards, mz, my, mx, C).
extern "C" int emdee_cell_forces_ghost(
    const float* px, const float* py, const float* pz, const float* hs,
    const float* tse, float* fx, float* fy, float* fz, float* e, float* w,
    int mz, int my, int mx, int shards, int sy_n, int sx_n, int bz, int by,
    int bx, int m, int c, const float* box, float rc2, float rs2, float invd2,
    float a_m, float pa1, float pa2, float pb1, float pb2, float sig2_u,
    float eps4_u, int uniform, int energy, void* stream) {
  if (m < 3 || c < 1 || c > 1024 || mz < 1 || my < 1 || mx < 1 || shards < 1 ||
      sy_n < 1 || sx_n < 1 || shards % (sy_n * sx_n) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const PairConsts k{rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, sig2_u, eps4_u};
  const Ghost g{mz, my, mx, sy_n, sx_n, bz, by, bx};
  const int blocks = shards * mz * my * mx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uniform && energy)
    launch<true, true, false, true>(px, py, pz, 1, hs, tse, nullptr, fx, fy, fz, 1, e, w, m, c, box, k, s,
                                    nullptr, nullptr, nullptr, nullptr, 0, g, blocks);
  else if (uniform)
    launch<true, false, false, true>(px, py, pz, 1, hs, tse, nullptr, fx, fy, fz, 1, e, w, m, c, box, k, s,
                                     nullptr, nullptr, nullptr, nullptr, 0, g, blocks);
  else if (energy)
    launch<false, true, false, true>(px, py, pz, 1, hs, tse, nullptr, fx, fy, fz, 1, e, w, m, c, box, k, s,
                                     nullptr, nullptr, nullptr, nullptr, 0, g, blocks);
  else
    launch<false, false, false, true>(px, py, pz, 1, hs, tse, nullptr, fx, fy, fz, 1, e, w, m, c, box, k, s,
                                      nullptr, nullptr, nullptr, nullptr, 0, g, blocks);
  return static_cast<int>(cudaGetLastError());
}

// The GHOST mode's molecular entry (K2c-G): the ghost grids as in
// `emdee_cell_forces_ghost` with per-atom parameters, plus q (the charges)
// with `coulomb` and aid (int32 atom ids, −2 on empty slots) with `excl`,
// each (shards, mz+2, my+2, mx+2, C); the centre tags ids, mlj, mcs
// (shards, mz, my, mx, C, ne) with `excl` (mcs only with `coulomb`); the
// DSF constants' device pointers with `coulomb`.
extern "C" int emdee_cell_forces_ghost_mol(
    const float* px, const float* py, const float* pz, const float* hs, const float* tse, const float* q,
    const int* aid, const float* ids, const float* mlj, const float* mcs, int ne, const float* alpha,
    const float* rc, const float* rc2_c, const float* e_shift, const float* f_shift, const float* kc, float* fx,
    float* fy, float* fz, float* e, float* w, int mz, int my, int mx, int shards, int sy_n, int sx_n, int bz,
    int by, int bx, int m, int c, const float* box, float rc2, float rs2, float invd2, float a_m, float pa1,
    float pa2, float pb1, float pb2, int coulomb, int excl, int energy, void* stream) {
  if (m < 3 || c < 1 || c > 1024 || mz < 1 || my < 1 || mx < 1 || shards < 1 || sy_n < 1 || sx_n < 1 ||
      shards % (sy_n * sx_n) != 0 || (!coulomb && !excl) || (excl && (ne < 1 || ne > kMaxTags)))
    return static_cast<int>(cudaErrorInvalidValue);
  const PairConsts k{rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, 0.f, 0.f};
  const Ghost g{mz, my, mx, sy_n, sx_n, bz, by, bx};
  const Mol mol{q, aid, ids, mlj, mcs, nullptr, nullptr, nullptr, excl ? ne : 0, 0,
                alpha, rc, rc2_c, e_shift, f_shift, kc};
  const int blocks = shards * mz * my * mx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EMDEE_GHOST_MOL(EN, CO, EX) \
  launch_ghost_mol<EN, CO, EX>(px, py, pz, hs, tse, fx, fy, fz, e, w, m, c, box, k, g, blocks, mol, s)
  if (energy) {
    if (coulomb && excl) EMDEE_GHOST_MOL(true, true, true);
    else if (coulomb) EMDEE_GHOST_MOL(true, true, false);
    else EMDEE_GHOST_MOL(true, false, true);
  } else {
    if (coulomb && excl) EMDEE_GHOST_MOL(false, true, true);
    else if (coulomb) EMDEE_GHOST_MOL(false, true, false);
    else EMDEE_GHOST_MOL(false, false, true);
  }
#undef EMDEE_GHOST_MOL
  return static_cast<int>(cudaGetLastError());
}
