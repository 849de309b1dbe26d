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
// order of every sum are K2c's (the same `pair_force` and `accumulate`, the same order of
// each centre's pairs), so the forces of any decomposition equal the
// one-card K2c-q's bit for bit.
//
// COULOMB, EXCL, BOND (K2c: the molecular branches of `_build_pair_pass`,
// K2c-q `coulomb` :420-424, :525-551 and `excl_e`/`excl_cs` :459-488;
// K2c-b `excl_eb` :468-487, :502-523; centre tags as `_unpack_centers`
// :347 lays them out), on the per-atom path, entered through
// `emdee_cell_forces_mol`: a kernel of its own, `cell_mol_kernel`.  A
// matched tag scales the LJ t6 by 1 − Σ mlj and qq by 1 − Σ mcs; a matched
// bond tag adds −r·dE/dr = k·r0·r − k·r² and E = ½(k·r² + k·r0²) − k·r0·r,
// masked to r² < rc² (periodic images of a partner drop out).  DSF Coulomb
// is the exact form with IEEE erfcf and expf, as the plain
// `coulomb_interaction` (the reference's XLA path, not its degree-10 fit),
// zero at r² ≥ rc_C²; its constants are read from 0-d device tensors
// (`emdee::mol_terms`, lj_pair.cuh).  Pairs are skipped beyond the larger of
// the two squared cutoffs; LJ and the bonds take only pairs inside rc².
// Plain version: cell_dense.py `cell_dense_forces(coulomb=, excl=)`.
//
// K2c's design.  Only ~9% of the full shell's live candidates lie inside
// the cutoff at the water box (M = 12, C = 80: ~143 of ~1,536 a centre), so
// a warp that steps through the erfc/exp body whenever one of its 32
// centres has a pair inside runs it at ~7% lane efficiency.  So a warp
// takes 32 live centres of one cell (ranks 32·part … by ballot; warp
// part · M³ + cell, 4 a block, no block barrier) and walks the 27
// neighbour cells in the fixed (dz, dy, dx) order.  For each it stages in
// its shared memory, in slot order, only the neighbour's live slots within
// the cutoff of its centres' bounding box (`emdee::near_box`, K5c's
// conservative cull, the box shifted back by the cell's periodic shift), at
// most 256 at a time; pass A has every lane list, in that order, the staged
// entries at r² < cut2 (a byte an entry); pass B runs the pair term over
// each lane's own list, recomputing the displacement with the same float
// operations.  Each centre's pairs are evaluated by the same `pair_force`
// and added by the same `accumulate` (one FMA a component) in the order the
// full-shell kernel adds them, and only pairs at r² ≥ cut2, which it skips
// too, are left out: K2c's sums equal the GHOST mode's (K2c-G) bit for bit.
// The centre tags and bond weights are staged per lane in shared memory.
// Shared memory a block: 4 × (16·C' + 96·(E + E_b) + 32) floats, C' = C
// rounded up to a warp and at most 256 (31,232 B at C = 80, E = E_b = 2);
// C ≤ 1024 as before.  The warps are part-major, so that a block's warps
// are all of one part and the blocks of a part that no cell fills (at C =
// 80, part 2) leave at once instead of holding a quarter of an SM's warp
// slots: that took the launch from ~0.82 ms to ~0.72 at the water box
// (NVIDIA H100, 700 W; `tools/ab_mol.py` against the cell-major order).
// In trials on this card the pair term takes about half of the launch, the
// staging and the candidate loop the rest; a form that evaluated the
// listed pairs 32 at a time across lanes and added them in order from a
// buffer ran the body on fewer warp steps but was no faster, nor were more
// blocks an SM or an unrolled pass B.

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

constexpr int kMaxMolCapacity = 1024;  // K2c: as the full-shell kernel

// The pair term of one pair at r² < cut2: the switched LJ (per-atom or
// uniform parameters, t6 scaled by the tags' ljsc with EXCL) and the
// molecular terms (qq = kC·qᵢ·qⱼ·csc and the matched bond weights).
// Returns gf = tot/r² and sets tot = −r·dE/dr and, with ENERGY, esum = E.
// Every force kernel of this file evaluates a centre's pairs through this
// code and adds them through `accumulate`, so that K2c and the GHOST mode
// round every pair alike.
template <bool UNIFORM, bool ENERGY, bool COULOMB, bool EXCL, bool BOND>
__device__ __forceinline__ float pair_force(float r2, float hsi, float hsj, float tsei, float tsej, float qq,
                                            float ljsc, float kbm, float kr0m, float kr02m, const PairConsts& k,
                                            const Dsf& dsf, float& tot, float& esum) {
  const float rinv = 1.0f / r2;
  tot = 0.f;
  esum = 0.f;
  const bool in_lj = !COULOMB || r2 < k.rc2;  // cut2 is rc² without COULOMB
  if (in_lj) {
    float t6, s6;
    if (UNIFORM) {
      const float s2 = k.sig2_u * rinv;
      s6 = s2 * s2 * s2;
      t6 = k.eps4_u * s6;
    } else {
      const float sig = hsi + hsj;
      const float s2 = sig * sig * rinv;
      s6 = s2 * s2 * s2;
      t6 = (tsei * tsej) * s6;
    }
    if (EXCL) t6 *= ljsc;
    float t12, x;
    tot = emdee::switched_tot(r2, t6, s6, k, t12, x);
    if (ENERGY) esum = (t12 - t6) * (1.f + (x * x * x) * ((-6.f * x + 15.f) * x - 10.f));
  }
  emdee::mol_terms<COULOMB, BOND, ENERGY>(r2, in_lj, qq, dsf, kbm, kr0m, kr02m, tot, esum);
  return tot * rinv;
}

// A pair's force gf·d, and with ENERGY its half-split energy and virial,
// added to its centre's sums.
template <bool ENERGY>
__device__ __forceinline__ void accumulate(float gf, float dvx, float dvy, float dvz, float tot, float esum,
                                           float& fxa, float& fya, float& fza, float& ea, float& wa) {
  fxa += gf * dvx;
  fya += gf * dvy;
  fza += gf * dvz;
  if (ENERGY) {
    ea += 0.5f * esum;
    wa += 0.5f * tot;
  }
}

template <bool UNIFORM, bool ENERGY, bool STRAG, bool GHOST, bool COULOMB = false, bool EXCL = false>
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

  // Molecular centre operands (GHOST only since K2c has a kernel of its
  // own): the charge from the ghost grid's interior, the tags per own slot,
  // in registers.
  float qi = 0.f;
  Dsf dsf{};
  int tid[kMaxTags];
  float tmlj[kMaxTags], tmcs[kMaxTags];
  float cut2 = k.rc2;
  if (COULOMB) {
    dsf = emdee::load_dsf(mol);
    cut2 = fmaxf(cut2, dsf.rc2);
    if (center) qi = mol.q[in_own];
  }
#pragma unroll
  for (int t = 0; t < kMaxTags; ++t) {
    tid[t] = -1;
    tmlj[t] = tmcs[t] = 0.f;
    if (EXCL && center && t < mol.ne) {
      const long at = own * mol.ne + t;
      tid[t] = __float2int_rn(mol.ids[at]);
      tmlj[t] = mol.mlj[at];
      if (COULOMB) tmcs[t] = mol.mcs[at];
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
          // Tag matches: the LJ and Coulomb scales and the bond weights.
          float ljsc = 1.f, csc = 1.f;
          if (EXCL) {
            const int aj = said[j];
#pragma unroll
            for (int t = 0; t < kMaxTags; ++t) {
              if (tid[t] != aj) continue;  // pad tags hold −1, never an atom id
              ljsc -= tmlj[t];
              if (COULOMB) csc -= tmcs[t];
            }
          }
          float tot, esum;
          const float gf = pair_force<UNIFORM, ENERGY, COULOMB, EXCL, false>(
              r2, hsi, shs[j], tsei, stse[j], COULOMB ? dsf.kc * qi * sq[j] * csc : 0.f, ljsc, 0.f, 0.f, 0.f, k, dsf,
              tot, esum);
          accumulate<ENERGY>(gf, dvx, dvy, dvz, tot, esum, fxa, fya, fza, ea, wa);
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

// K2c: kMolWarps warps a block, each owning up to 32 live centres of one
// cell; no block barrier.
constexpr int kMolWarps = 4;
constexpr int kMolThreads = 32 * kMolWarps;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kStage = 256;  // K2c: the most neighbour slots a warp stages at once (a list entry is a byte)

// Floats of one K2c warp's shared memory at tile width nt (C rounded up to
// a warp, at most kStage): the staged neighbour tile (x, y, z, σ/2, 2√ε, q,
// atom id, slot), each lane's list of inside entries (nt bytes a lane),
// the centres' tags (three values a tag and a bond tag, 32 lanes) and the
// rank-to-slot map.
__host__ __device__ constexpr int mol_warp_floats(int nt, int ne, int neb) {
  return 8 * nt + nt * 32 / 4 + 3 * (ne + neb) * 32 + 32;
}

// K2c's pair pass: warp part · M³ + cell takes the live centres of rank
// 32·part … 32·part + 31 of its cell (lane l the centre of rank 32·part + l)
// and walks the 27 neighbour cells in cell_forces_kernel's (dz, dy, dx) order.
// For each it stages, in slot order, the neighbour's live slots within the
// cutoff of the warp's centre box (the conservative `near_box`, the box
// shifted back by the cell's periodic shift), at most kStage at a time;
// pass A lists, per lane and in that order, the staged entries at r² <
// cut2 (the self pair left out); pass B runs the pair term over each
// lane's list.  A centre's pairs are evaluated by `pair_force` and added by
// `accumulate` in cell_forces_kernel's order, and only pairs at r² ≥ cut2,
// which it skips too, are left out: the sums are its sums, bit for bit.
// Part 0 also writes the zeros of the empty slots.
template <bool ENERGY, bool COULOMB, bool EXCL, bool BOND>
__global__ void __launch_bounds__(kMolThreads, 4)
    cell_mol_kernel(const float* __restrict__ pos, const float* __restrict__ hs, const float* __restrict__ tse,
                    const uint8_t* __restrict__ valid, float* __restrict__ f, float* __restrict__ e_out,
                    float* __restrict__ w_out, int m, int c, const float* __restrict__ box_ptr, PairConsts k,
                    Mol mol) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  const int parts = (c + 31) / 32, nt = min(32 * parts, kStage);
  const long item = static_cast<long>(blockIdx.x) * kMolWarps + warp;
  if (item >= static_cast<long>(m) * m * m * parts) return;  // no block barrier follows
  const long cells = static_cast<long>(m) * m * m;
  const int part = static_cast<int>(item / cells);  // part-major: a block's warps are all of one part
  const long cell = item - part * cells;
  float* tile = smem + warp * mol_warp_floats(nt, mol.ne, mol.neb);  // (7, nt) fields
  int* tslot = reinterpret_cast<int*>(tile + 7 * nt);
  uint8_t* list = reinterpret_cast<uint8_t*>(tslot + nt);  // entry k of lane l at k·32 + l
  float* tags = reinterpret_cast<float*>(list + 32 * nt);   // value v of tag u at (3u + v)·32 + lane
  int* cslot = reinterpret_cast<int*>(tags + 3 * (mol.ne + mol.neb) * 32);

  // This warp's centres: the live slots of rank 32·part + lane.
  int n_live = 0;
  for (int a = 0; a < parts; ++a) {
    const int j = 32 * a + lane;
    const bool live = j < c && valid[cell * c + j];
    const unsigned mask = __ballot_sync(kFull, live);
    const int r = n_live + __popc(mask & below) - 32 * part;
    if (live && r >= 0 && r < 32) cslot[r] = j;
    if (part == 0 && j < c && !live) {
      const long s = cell * c + j;
      f[3 * s] = f[3 * s + 1] = f[3 * s + 2] = 0.f;
      if (ENERGY) e_out[s] = w_out[s] = 0.f;
    }
    n_live += __popc(mask);
  }
  const int n_mine = min(n_live - 32 * part, 32);
  if (n_mine <= 0) return;
  __syncwarp();
  const bool centre = lane < n_mine;
  const int si = centre ? cslot[lane] : -1;
  const long own = cell * c + si;
  const float box = *box_ptr;
  float xi = 0.f, yi = 0.f, zi = 0.f, hsi = 0.f, tsei = 0.f, qi = 0.f;
  Dsf dsf{};
  float cut2 = k.rc2;
  if (COULOMB) {
    dsf = emdee::load_dsf(mol);
    cut2 = fmaxf(cut2, dsf.rc2);
  }
  if (centre) {
    xi = pos[3 * own];
    yi = pos[3 * own + 1];
    zi = pos[3 * own + 2];
    hsi = hs[own];
    tsei = tse[own];
    if (COULOMB) qi = mol.q[own];
    for (int u = 0; u < mol.ne; ++u) {
      const long at = own * mol.ne + u;
      tags[(3 * u) * 32 + lane] = __int_as_float(__float2int_rn(mol.ids[at]));
      tags[(3 * u + 1) * 32 + lane] = mol.mlj[at];
      if (COULOMB) tags[(3 * u + 2) * 32 + lane] = mol.mcs[at];
    }
    if (BOND) {
      for (int u = 0; u < mol.neb; ++u) {
        const long at = own * mol.neb + u;
        float* b = tags + 3 * (mol.ne + u) * 32 + lane;
        b[0] = mol.kb[at];
        b[32] = mol.kr0[at];
        if (ENERGY) b[64] = mol.kr02[at];
      }
    }
  }
  // The centres' bounding box, on every lane.
  float lo[3], hi[3];
  {
    const float p[3] = {xi, yi, zi};
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      lo[v] = centre ? p[v] : __int_as_float(0x7f800000);
      hi[v] = centre ? p[v] : -__int_as_float(0x7f800000);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lo[v] = fminf(lo[v], __shfl_xor_sync(kFull, lo[v], off));
        hi[v] = fmaxf(hi[v], __shfl_xor_sync(kFull, hi[v], off));
      }
    }
  }

  const int cx = static_cast<int>(cell % m), cy = static_cast<int>((cell / m) % m), cz = static_cast<int>(cell / (m * m));
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
        const bool self_cell = dz == 0 && dy == 0 && dx == 0;
        const float back[3] = {-shx, -shy, -shz};
        for (int a0 = 0; a0 < parts; a0 += kStage / 32) {
          // Stage the neighbour's live slots near the centre box, in slot
          // order; each chunk's loads go out together.
          __syncwarp();  // the previous stage's reads of the tile are done
          int n = 0;
          for (int a = a0; a < min(parts, a0 + kStage / 32); ++a) {
            const int j = 32 * a + lane;
            const long s = nb + min(j, c - 1);
            const bool live = j < c && valid[s];
            const float p[3] = {pos[3 * s], pos[3 * s + 1], pos[3 * s + 2]};
            const float h = hs[s], t = tse[s], q = COULOMB ? mol.q[s] : 0.f;
            const int id = EXCL ? mol.aid[s] : 0;
            const bool keep = live && emdee::near_box(p, lo, hi, back, cut2);
            const unsigned mask = __ballot_sync(kFull, keep);
            if (keep) {
              const int e = n + __popc(mask & below);
              tile[e] = p[0];
              tile[nt + e] = p[1];
              tile[2 * nt + e] = p[2];
              tile[3 * nt + e] = h;
              tile[4 * nt + e] = t;
              if (COULOMB) tile[5 * nt + e] = q;
              if (EXCL) tile[6 * nt + e] = __int_as_float(id);
              tslot[e] = j;
            }
            n += __popc(mask);
          }
          __syncwarp();
          if (n == 0) continue;
          // Pass A: this lane's entries inside the cutoff, in slot order.
          int len = 0;
          if (centre) {
#pragma unroll 4
            for (int e = 0; e < n; ++e) {
              const float dvx = (xi - tile[e]) - shx;
              const float dvy = (yi - tile[nt + e]) - shy;
              const float dvz = (zi - tile[2 * nt + e]) - shz;
              const float r2 = dvx * dvx + dvy * dvy + dvz * dvz;
              if (r2 < cut2 && !(self_cell && tslot[e] == si)) list[32 * len++ + lane] = static_cast<uint8_t>(e);
            }
          }
          // Pass B: the pair term over the list.
          const int steps = __reduce_max_sync(kFull, len);
          for (int t = 0; t < steps; ++t) {
            if (t >= len) continue;
            const int e = list[32 * t + lane];
            const float dvx = (xi - tile[e]) - shx;
            const float dvy = (yi - tile[nt + e]) - shy;
            const float dvz = (zi - tile[2 * nt + e]) - shz;
            const float r2 = dvx * dvx + dvy * dvy + dvz * dvz;
            // Tag matches: the LJ and Coulomb scales and the bond weights.
            float ljsc = 1.f, csc = 1.f, kbm = 0.f, kr0m = 0.f, kr02m = 0.f;
            if (EXCL) {
              const int aj = __float_as_int(tile[6 * nt + e]);
              for (int u = 0; u < mol.ne; ++u) {
                if (__float_as_int(tags[(3 * u) * 32 + lane]) != aj) continue;
                ljsc -= tags[(3 * u + 1) * 32 + lane];
                if (COULOMB) csc -= tags[(3 * u + 2) * 32 + lane];
                if (BOND && u < mol.neb) {
                  const float* b = tags + 3 * (mol.ne + u) * 32 + lane;
                  kbm += b[0];
                  kr0m += b[32];
                  if (ENERGY) kr02m += b[64];
                }
              }
            }
            float tot, esum;
            const float gf = pair_force<false, ENERGY, COULOMB, EXCL, BOND>(
                r2, hsi, tile[3 * nt + e], tsei, tile[4 * nt + e],
                COULOMB ? dsf.kc * qi * tile[5 * nt + e] * csc : 0.f, ljsc, kbm, kr0m, kr02m, k, dsf, tot, esum);
            accumulate<ENERGY>(gf, dvx, dvy, dvz, tot, esum, fxa, fya, fza, ea, wa);
          }
        }
      }
    }
  }
  if (centre) {
    f[3 * own] = fxa;
    f[3 * own + 1] = fya;
    f[3 * own + 2] = fza;
    if (ENERGY) {
      e_out[own] = ea;
      w_out[own] = wa;
    }
  }
}

// K2c's variant for these flags, and its dynamic shared memory a block.
using MolKernel = void (*)(const float*, const float*, const float*, const uint8_t*, float*, float*, float*, int, int,
                           const float*, PairConsts, Mol);

template <bool ENERGY>
MolKernel mol_variant_e(int coulomb, int excl, int bond) {
  if (coulomb && bond) return cell_mol_kernel<ENERGY, true, true, true>;
  if (coulomb && excl) return cell_mol_kernel<ENERGY, true, true, false>;
  if (coulomb) return cell_mol_kernel<ENERGY, true, false, false>;
  if (bond) return cell_mol_kernel<ENERGY, false, true, true>;
  return cell_mol_kernel<ENERGY, false, true, false>;
}

size_t mol_smem_bytes(int c, int ne, int neb) {
  return sizeof(float) * kMolWarps * static_cast<size_t>(mol_warp_floats(32 * ((c + 31) / 32), ne, neb));
}

// The K2c variant for these flags, refused as the launch entry refuses it
// (but for M), its dynamic shared memory (`*smem`) allowed.
int mol_kernel(int c, int ne, int neb, int coulomb, int excl, int bond, int energy, MolKernel* kernel,
               size_t* smem) {
  if (!excl) ne = 0;
  if (!bond) neb = 0;
  *smem = mol_smem_bytes(c, ne, neb);
  if (c < 1 || c > kMaxMolCapacity || *smem > 232448 || (!coulomb && !excl) || (bond && !excl) ||
      (excl && (ne < 1 || ne > kMaxTags)) || (bond && (neb < 1 || neb > ne)))
    return static_cast<int>(cudaErrorInvalidValue);
  *kernel = energy ? mol_variant_e<true>(coulomb, excl, bond) : mol_variant_e<false>(coulomb, excl, bond);
  static size_t smem_allowed[2][5] = {};  // raised once per variant, not per launch
  size_t& allowed = smem_allowed[energy ? 1 : 0][coulomb && bond ? 0 : coulomb && excl ? 1 : coulomb ? 2 : bond ? 3 : 4];
  if (*smem > 48 * 1024 && *smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(*kernel),
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = *smem;
  }
  return 0;
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
  cell_forces_kernel<false, ENERGY, false, true, COULOMB, EXCL><<<blocks, threads, smem, stream>>>(
      px, py, pz, 1, hs, tse, nullptr, fx, fy, fz, 1, e, w, nullptr, nullptr, nullptr, nullptr, 0, m, c, box, k,
      g, mol);
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
// `energy`).  C ≤ 256 (a list entry is one byte).
extern "C" int emdee_cell_forces_mol(
    const float* pos, const float* hs, const float* tse, const uint8_t* valid, const float* q,
    const int* aid, const float* ids, const float* mlj, const float* mcs, const float* kb,
    const float* kr0, const float* kr02, int ne, int neb, const float* alpha, const float* rc,
    const float* rc2_c, const float* e_shift, const float* f_shift, const float* kc, float* f, float* e,
    float* w, int m, int c, const float* box, float rc2, float rs2, float invd2, float a_m, float pa1,
    float pa2, float pb1, float pb2, int coulomb, int excl, int bond, int energy, void* stream) {
  if (m < 3) return static_cast<int>(cudaErrorInvalidValue);
  MolKernel kernel;
  size_t smem;
  const int err = mol_kernel(c, ne, neb, coulomb, excl, bond, energy, &kernel, &smem);
  if (err) return err;
  PairConsts k{rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, 0.f, 0.f};
  Mol mol{q, aid, ids, mlj, mcs, kb, kr0, kr02, excl ? ne : 0, bond ? neb : 0, alpha, rc, rc2_c, e_shift, f_shift,
          kc};
  const long warps = static_cast<long>(m) * m * m * ((c + 31) / 32);
  const unsigned blocks = static_cast<unsigned>((warps + kMolWarps - 1) / kMolWarps);
  void* args[] = {&pos, &hs, &tse, &valid, &f, &e, &w, &m, &c, &box, &k, &mol};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(kMolThreads),
                                           args, smem, static_cast<cudaStream_t>(stream)));
}

// The K2c variant these flags select, as the card reports it: out[0..3] =
// registers a thread, local (spill) bytes a thread, shared bytes a block,
// resident blocks an SM.  Launches nothing.
extern "C" int emdee_cell_forces_mol_attrs(int c, int ne, int neb, int coulomb, int excl, int bond, int energy,
                                           int* out) {
  MolKernel kernel;
  size_t smem;
  const int err = mol_kernel(c, ne, neb, coulomb, excl, bond, energy, &kernel, &smem);
  if (err) return err;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, reinterpret_cast<const void*>(kernel), kMolThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(smem + fa.sharedSizeBytes);
  out[3] = blocks;
  return 0;
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
