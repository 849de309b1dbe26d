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
// above 32 take a second centre slot per lane and a second packet chunk,
// above 64 a third (C ≤ 96: the water boxes need C = 80 and 88).
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
// COULOMB, EXCL, BOND (K5c: the streaming kernel's molecular branches,
// `_make_streaming_kernel` :1185-1250 with `names` + q, aid and the centre
// tags and bond weights of `_unpack_centers` :347; entry
// `pallas_cell_forces_streaming` :1417-1500), through
// `emdee_streaming_forces_mol`: per-atom parameters, the stacked state.
// The tiles also carry each live slot's charge and int32 atom id, and the
// packets take them round the ring (a ring lane past the live packets
// carries atom id −2, which no tag holds).  The centre's E ≤ 8 tags (atom
// id, 1 − s_LJ, 1 − s_C) and E_b bond weights (k, k·r0, k·r0²) are staged
// per warp in shared memory, tag-major so that the lanes read consecutive
// words: held in registers they would take 3 centre slots × 8 tags × 6
// values a lane.  Each lane stages and reads only its own centre entries,
// so the staging needs no barrier.  A pair matches the centre's tags
// against the packet's atom id only: the tables are symmetric (a pair sits
// in both atoms' rows with the same weights), so the scale is the one the
// full shell gives from either side, and a bond is evaluated once, its
// reaction on the packet.  The pair math is K2c's (`emdee::mol_terms`,
// lj_pair.cuh): DSF in the exact erfcf/expf form with its constants read
// from 0-d device tensors, the bond only inside the LJ cutoff, pairs
// skipped beyond the larger of the two cutoffs.  Per-slot ½E and ½W go half
// to the centre and half to the reaction row, as K5 does.  The plain
// version is K2c's, `cell_dense_forces(coulomb=, excl=)`.
//
// GHOST (K5s: the streaming kernel on each shard of the grid-sharded
// engine, `streaming_halfshell_call` with `wrap_reaction=False` as
// emdee_tpu/distributed/grid_sharded.py `_local_forces_streaming` :658-702
// and `_local_energy_pallas` :704-744 call it), through
// `emdee_streaming_ghost`: one block per interior pencil (z, y) of each
// local shard, centres and neighbours read from the shards' stacked
// (mz+2, my+2, mx+2, C) ghost grids, whose positions carry NaN in empty
// slots; nothing wraps.  The 14 phases are the one-card kernel's; each
// periodic shift comes from the neighbour's GLOBAL cell index on raw
// coordinates, as cell_forces.cu's GHOST mode takes it, so every
// displacement is (x_i − x_j) − shift.  A group's reaction row is
// (mx+2)·C wide, its x-ghost columns kept, and every group — the own row
// (0, 0) too, whose column mx+1 belongs to the +x neighbour — leaves to its
// own slice of a (5, n_r, pencils, (mx+2)·C) scratch at the block's own
// pencil, so each slice is written whole by exactly one block.  A second
// launch (`ghost_assemble_kernel`) adds, for each slot of the ghost grids,
// the slices in the fixed order (0,0), (0,1), (1,−1), (1,0), (1,1) from the
// pencils that wrote its row: onto the centre sums for an interior slot,
// into a reaction ghost grid (n_r, shards, mz+2, my+2, mx+2, C) for a ghost
// slot (exact zeros where no group wrote).  The engine returns the ghost
// layers to their owners through the mesh (`grid_sharded._fold3`, the
// reference's second exchange).  No float atomics: reruns are bitwise
// equal; but the fold adds a shard's boundary reactions in another order
// than one card's kernel, so decompositions agree to roundoff, not bit for
// bit.  With COULOMB/EXCL (K5s-mol) the ghost grids also carry charges and
// int32 atom ids, the centre tags are per own slot; no bond tags (the grid
// keeps its bonds as term rows).  Plain version:
// emdee_tpu_torch/neighbors/streaming_kernel.py `streaming_ghost_forces_plain`.
//
// Bound on this card: at the 1,000,188-atom melt (M = 37, C = 32) the ring
// loop runs ~50,653 × 14 × 22 steps of 32 lanes, about 60% of the lanes
// live, and ~27 M of the pairs lie inside the cutoff: ~1.4 GFLOP, ~0.02 ms
// at 67 TFLOP/s.  The function's own bytes (25 B a slot in, out) take
// ~0.012 ms at 3.35 TB/s, the four reaction slices (78 MB forces only,
// written once and read back by the fold) ~0.05 ms.  The launch pair takes
// ~1.3 ms (chip_smoke.py): the candidate loop's instruction rate and
// latency set it, not bytes or arithmetic; the same holds for the
// full-shell kernel.  At the 98,304-atom water box (M = 12, C = 80) K5c's
// unique pairs inside the cutoff each pay an erfc, an exp, a square root
// and 3E tag operations; chip_smoke.py counts them and gives the bound.

// emdee-build-parts: 3
// csrc/build.py compiles this file as three objects at once, to cut the
// build's wall time: EMDEE_PART 0 holds the LJ entry and the fold, 1 the
// molecular entry, 2 the GHOST entries (each part instantiates only its
// entries' kernel variants); without EMDEE_PART the file holds them all.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lj_pair.cuh"

#ifndef EMDEE_PART
#define EMDEE_PART (-1)
#endif
#define EMDEE_IN_PART(k) (EMDEE_PART < 0 || EMDEE_PART == (k))

namespace {

using emdee::Dsf;
using emdee::kMaxTags;
using emdee::Mol;
using emdee::PairConsts;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroups = 4;  // row groups written to the scratch array
constexpr int kMaxCapacity = 96;  // three centre slots per lane
constexpr unsigned kFull = 0xffffffffu;
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

// Entries of a warp's cell tile: 64 up to two centre slots a lane (the LJ
// kernel's tile since K5), 96 with three.
template <int NA>
__host__ __device__ constexpr int tile_entries() {
  return NA <= 2 ? 64 : 96;
}

// A warp's compacted copy of one cell: the live slots' fields in slot
// order at entries 0 … n−1 — x, y, z, σ/2, 2√ε and, with the molecular
// terms (NF = 7), the charge and the atom id's bits — and each entry's slot.
template <int NT, int NF>
struct Tile {
  float f[NF][NT];
  int slot[NT];
};

// Floats of a warp's staged centre tags: per entry, three values for each
// exclusion tag and each bond tag.
__host__ __device__ constexpr int tag_floats(int nt, int ne, int neb) { return 3 * (ne + neb) * nt; }

// Centre sums and one reaction row of a pencil, (2, n_r, M·C) float32, each
// warp's two cell tiles and, with EXCL, its staged centre tags.
size_t smem_bytes(int m, int c, bool energy, bool mol, int ne, int neb);

__device__ __forceinline__ int wrap(int v, int m, const float* __restrict__ box, float& shift) {
  shift = 0.f;
  if (v < 0) { shift = -*box; return v + m; }
  if (v >= m) { shift = *box; return v - m; }
  return v;
}

// Compact cell `cell`'s live slots into `t` (ballot ranks, slot order);
// returns their count.  The caller brackets it with warp barriers.  Without
// a valid mask (the ghost grids), a slot is live where its x is not NaN.
template <int NA, int NT, int NF, bool UNIFORM>
__device__ __forceinline__ int compact(const Fields& f, const Mol& mol, long cell, int c, Tile<NT, NF>& t) {
  const int lane = threadIdx.x & 31;
  int n = 0;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int j = 32 * a + lane;
    const long s = cell * c + j;
    // GHOST (no valid mask): an empty ghost slot holds NaN coordinates.
    const bool live = j < c && (f.valid ? f.valid[s] != 0 : !isnan(f.px[s * f.pstride]));
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
      if constexpr (NF > 5) {
        t.f[5][e] = mol.q ? mol.q[s] : 0.f;
        t.f[6][e] = __int_as_float(mol.aid ? mol.aid[s] : -2);
      }
      t.slot[e] = j;
    }
    n += __popc(mask);
  }
  return n;
}

// Stage the tags of this lane's centre entries 32a + lane (a < NA) of
// tile `t` (cell `cell`, `n` live entries), tag-major: tags[(3u + v)·NT +
// e] holds tag u's atom id bits, 1 − s_LJ, 1 − s_C (v = 0, 1, 2), and
// tags[(3(ne + u) + v)·NT + e] bond tag u's k, k·r0, k·r0².
template <int NA, int NT, bool COULOMB, bool BOND, bool ENERGY>
__device__ __forceinline__ void stage_tags(const Mol& mol, long cell, int c, const Tile<NT, 7>& t, int n,
                                           float* tags) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int e = 32 * a + lane;
    if (e >= n) break;
    const long s = cell * c + t.slot[e];
    for (int u = 0; u < mol.ne; ++u) {
      const long at = s * mol.ne + u;
      tags[(3 * u) * NT + e] = __int_as_float(__float2int_rn(mol.ids[at]));
      tags[(3 * u + 1) * NT + e] = mol.mlj[at];
      if (COULOMB) tags[(3 * u + 2) * NT + e] = mol.mcs[at];
    }
    if (BOND) {
      for (int u = 0; u < mol.neb; ++u) {
        const long at = s * mol.neb + u;
        float* b = tags + 3 * (mol.ne + u) * NT + e;
        b[0] = mol.kb[at];
        b[NT] = mol.kr0[at];
        if (ENERGY) b[2 * NT] = mol.kr02[at];
      }
    }
  }
}

// All pairs of centre cell `cen` with neighbour cell `nb` (shifted by
// (shx, shy, shz)) for one warp, through its two tiles (and, with EXCL,
// its tag tile, read at the centre's own cell `tag_cell`).  Centre sums go
// to cen_acc[k·mc + x·C + i]; with REACT, the reaction sums go to
// row[k·mr + nx·C + j].
template <int NA, bool UNIFORM, bool ENERGY, bool REACT, bool COULOMB, bool EXCL, bool BOND>
__device__ __forceinline__ void cell_pair(const Fields& f, const Mol& mol, const Dsf& dsf, float cut2, long cen,
                                          long nb, long tag_cell, int c, int x, int nx, float shx, float shy,
                                          float shz, int mc, int mr, float* cen_acc, float* row,
                                          Tile<tile_entries<NA>(), (COULOMB || EXCL) ? 7 : 5>* tiles,
                                          float* tags, const PairConsts& k) {
  constexpr int NT = tile_entries<NA>();
  constexpr bool MOL = COULOMB || EXCL;
  const int lane = threadIdx.x & 31;
  auto& tc = tiles[0];
  auto& tn = REACT ? tiles[1] : tiles[0];  // the self pass pairs a cell with itself
  __syncwarp();  // the previous cell pair's reads of the tiles are done
  const int n_cen = compact<NA, NT, MOL ? 7 : 5, UNIFORM>(f, mol, cen, c, tc);
  const int n_nb = REACT ? compact<NA, NT, MOL ? 7 : 5, UNIFORM>(f, mol, nb, c, tn) : n_cen;
  __syncwarp();
  if (n_cen == 0 || n_nb == 0) return;
  if constexpr (EXCL) stage_tags<NA, NT, COULOMB, BOND, ENERGY>(mol, tag_cell, c, tc, n_cen, tags);

  float xi[NA], yi[NA], zi[NA], hsi[NA], tsei[NA], qi[NA];
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
    qi[a] = 0.f;
    if constexpr (COULOMB) qi[a] = vi[a] ? tc.f[5][e] : 0.f;
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
    float nq = 0.f;
    int naid = -2;
    if constexpr (MOL) {
      nq = vj ? tn.f[5][e] : 0.f;
      naid = vj ? __float_as_int(tn.f[6][e]) : -2;
    }
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
        if (!(r2 < cut2)) continue;
        const float rinv = 1.0f / r2;
        // Tag matches: the LJ and Coulomb scales and the bond weights.
        float ljsc = 1.f, csc = 1.f, kbm = 0.f, kr0m = 0.f, kr02m = 0.f;
        if (EXCL) {
          const float* tg = tags + 32 * a + lane;
          for (int u = 0; u < mol.ne; ++u) {
            if (__float_as_int(tg[(3 * u) * NT]) != naid) continue;
            ljsc -= tg[(3 * u + 1) * NT];
            if (COULOMB) csc -= tg[(3 * u + 2) * NT];
            if (BOND && u < mol.neb) {
              const float* bw = tg + 3 * (mol.ne + u) * NT;
              kbm += bw[0];
              kr0m += bw[NT];
              if (ENERGY) kr02m += bw[2 * NT];
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
            const float sig = hsi[a] + nhs;
            const float s2 = sig * sig * rinv;
            s6 = s2 * s2 * s2;
            t6 = (tsei[a] * ntse) * s6;
          }
          if (EXCL) t6 *= ljsc;
          float t12, xs;
          tot = emdee::switched_tot(r2, t6, s6, k, t12, xs);
          if (ENERGY) esum = (t12 - t6) * (1.f + (xs * xs * xs) * ((-6.f * xs + 15.f) * xs - 10.f));
        }
        emdee::mol_terms<COULOMB, BOND, ENERGY>(r2, in_lj, COULOMB ? dsf.kc * qi[a] * nq * csc : 0.f, dsf, kbm,
                                                kr0m, kr02m, tot, esum);
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
          const float he = 0.5f * esum;
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
      if (COULOMB) nq = __shfl_sync(kFull, nq, from);
      if (EXCL) naid = __shfl_sync(kFull, naid, from);
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
      r[mr] += ry;
      r[2 * mr] += rz;
      if (ENERGY) {
        r[3 * mr] += re;
        r[4 * mr] += rw;
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

template <int NA, bool UNIFORM, bool ENERGY, bool COULOMB, bool EXCL, bool BOND>
__global__ void __launch_bounds__(kThreads)
    streaming_kernel(Fields f, Mol mol, float* __restrict__ fx, float* __restrict__ fy,
                     float* __restrict__ fz, int fstride, float* __restrict__ e_out,
                     float* __restrict__ w_out, float* __restrict__ groups, int m, int c,
                     const float* __restrict__ box_ptr, PairConsts k) {
  constexpr int NR = ENERGY ? 5 : 3;
  constexpr int NT = tile_entries<NA>();
  using TileT = Tile<NT, (COULOMB || EXCL) ? 7 : 5>;
  extern __shared__ float smem[];
  const int mc = m * c;
  float* cen_acc = smem;        // (NR, M·C) centre sums of this pencil
  float* row = smem + NR * mc;  // (NR, M·C) one group's reaction row
  const int warp = threadIdx.x >> 5;
  TileT* tiles = reinterpret_cast<TileT*>(smem + 2 * NR * mc);
  float* tags = reinterpret_cast<float*>(tiles + 2 * kWarps) + warp * tag_floats(NT, mol.ne, mol.neb);
  tiles += 2 * warp;  // this warp's two
  const int z = blockIdx.x / m, y = blockIdx.x % m;
  const long pencil = static_cast<long>(blockIdx.x) * m;  // cell id of x = 0
  const long ns = static_cast<long>(m) * m * mc;
  Dsf dsf{};
  float cut2 = k.rc2;
  if (COULOMB) {
    dsf = emdee::load_dsf(mol);
    cut2 = fmaxf(cut2, dsf.rc2);
  }

  for (int t = threadIdx.x; t < 2 * NR * mc; t += kThreads) smem[t] = 0.f;
  __syncthreads();

  // Self cell: every ordered pair, no reaction.
  for (int x = warp; x < m; x += kWarps)
    cell_pair<NA, UNIFORM, ENERGY, false, COULOMB, EXCL, BOND>(f, mol, dsf, cut2, pencil + x, pencil + x,
                                                                pencil + x, c, x, x, 0.f, 0.f, 0.f, mc, mc,
                                                                cen_acc, row, tiles, tags, k);

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
        cell_pair<NA, UNIFORM, ENERGY, true, COULOMB, EXCL, BOND>(f, mol, dsf, cut2, pencil + x, nrow * m + nx,
                                                                   pencil + x, c, x, nx, shx, shy, shz, mc, mc,
                                                                   cen_acc, row, tiles, tags, k);
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

// GHOST geometry, as cell_forces.cu's: local cells (mz, my, mx) per shard,
// the local shards' grid (sy_n, sx_n after the leading z count), and the
// global coordinates (bz, by, bx) of the first local shard.
struct Ghost {
  int mz, my, mx, sy_n, sx_n, bz, by, bx;
};

// The periodic shift of a neighbour at global cell coordinate v.
__device__ __forceinline__ float ghost_shift(int v, int m, const float* __restrict__ box) {
  return v < 0 ? -*box : (v >= m ? *box : 0.f);
}

// The row groups in assembly order: slice 0 is the own row (0, 0), slices
// 1-4 the groups kGroupDz/kGroupDy.
__constant__ int kSliceDz[kGroups + 1] = {0, 0, 1, 1, 1};
__constant__ int kSliceDy[kGroups + 1] = {0, 1, -1, 0, 1};

// GHOST (K5s): one block per interior pencil (s, lz, ly) of the local
// shards, centres and neighbours read from the shards' ghost grids.  The
// centre sums go to out (NR, shards·mz·my·mx·C); each group's reaction row,
// (mx+2)·C wide, to its slice of groups (5, NR, pencils, (mx+2)·C) at the
// block's own pencil.
template <int NA, bool UNIFORM, bool ENERGY, bool COULOMB, bool EXCL>
__global__ void __launch_bounds__(kThreads)
    streaming_ghost_kernel(Fields f, Mol mol, float* __restrict__ out, float* __restrict__ groups, Ghost g, int m,
                           int c, const float* __restrict__ box_ptr, PairConsts k) {
  constexpr int NR = ENERGY ? 5 : 3;
  constexpr int NT = tile_entries<NA>();
  using TileT = Tile<NT, (COULOMB || EXCL) ? 7 : 5>;
  extern __shared__ float smem[];
  const int gy = g.my + 2, gx = g.mx + 2;
  const int mc = g.mx * c;  // a centre row
  const int mr = gx * c;    // a reaction row, x-ghost columns included
  float* cen_acc = smem;        // (NR, mx·C) centre sums of this pencil
  float* row = smem + NR * mc;  // (NR, (mx+2)·C) one group's reaction row
  const int warp = threadIdx.x >> 5;
  TileT* tiles = reinterpret_cast<TileT*>(smem + NR * (mc + mr));
  float* tags = reinterpret_cast<float*>(tiles + 2 * kWarps) + warp * tag_floats(NT, mol.ne, 0);
  tiles += 2 * warp;  // this warp's two
  const int pencil = blockIdx.x;
  const int ly = pencil % g.my, lz = (pencil / g.my) % g.mz, s = pencil / (g.my * g.mz);
  // Global cell coordinates of the pencil (z, y) and of its x = 0.
  const int cz = (g.bz + s / (g.sx_n * g.sy_n)) * g.mz + lz;
  const int cy = (g.by + (s / g.sx_n) % g.sy_n) * g.my + ly;
  const int cx0 = (g.bx + s % g.sx_n) * g.mx;
  const long gbase = static_cast<long>(s) * (g.mz + 2) * gy * gx;  // the shard's ghost cell 0
  const long cen_row = gbase + (static_cast<long>(lz + 1) * gy + ly + 1) * gx + 1;  // ghost cell of x = 0
  const long own_row = static_cast<long>(pencil) * g.mx;  // own cell id of x = 0
  const long n_own = static_cast<long>(gridDim.x) * mc;
  Dsf dsf{};
  float cut2 = k.rc2;
  if (COULOMB) {
    dsf = emdee::load_dsf(mol);
    cut2 = fmaxf(cut2, dsf.rc2);
  }

  for (int t = threadIdx.x; t < NR * (mc + mr); t += kThreads) smem[t] = 0.f;
  __syncthreads();

  // Self cell: every ordered pair, no reaction.
  for (int x = warp; x < g.mx; x += kWarps)
    cell_pair<NA, UNIFORM, ENERGY, false, COULOMB, EXCL, false>(f, mol, dsf, cut2, cen_row + x, cen_row + x,
                                                                 own_row + x, c, x, x, 0.f, 0.f, 0.f, mc, mr,
                                                                 cen_acc, row, tiles, tags, k);

  for (int gi = 0; gi <= kGroups; ++gi) {
    const bool own = gi == kGroups;  // the own row (0, 0): dx = +1 only
    const int dz = own ? 0 : kGroupDz[gi], dy = own ? 0 : kGroupDy[gi];
    const float shz = ghost_shift(cz + dz, m, box_ptr);
    const float shy = ghost_shift(cy + dy, m, box_ptr);
    const long nrow = gbase + (static_cast<long>(lz + 1 + dz) * gy + ly + 1 + dy) * gx;  // ghost column 0
    for (int dx = own ? 1 : -1; dx <= 1; ++dx) {
      for (int x = warp; x < g.mx; x += kWarps) {
        const float shx = ghost_shift(cx0 + x + dx, m, box_ptr);
        cell_pair<NA, UNIFORM, ENERGY, true, COULOMB, EXCL, false>(f, mol, dsf, cut2, cen_row + x,
                                                                    nrow + x + 1 + dx, own_row + x, c, x,
                                                                    x + 1 + dx, shx, shy, shz, mc, mr, cen_acc,
                                                                    row, tiles, tags, k);
      }
      __syncthreads();
    }
    const int slice = own ? 0 : gi + 1;
    float* dst = groups + (static_cast<long>(slice) * NR * gridDim.x + pencil) * mr;
    for (int t = threadIdx.x; t < NR * mr; t += kThreads) {
      dst[static_cast<long>(t / mr) * gridDim.x * mr + t % mr] = row[t];
      row[t] = 0.f;
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < NR * mc; t += kThreads) out[(t / mc) * n_own + own_row * c + t % mc] = cen_acc[t];
}

// The GHOST assembly: one thread per slot of the shards' ghost grids.  An
// interior slot's centre sums in `out` get the five slices in order, (0,0),
// (0,1), (1,−1), (1,0), (1,1), each from the pencil that wrote that row;
// a ghost slot's sum of the same goes to react (NR, shards, mz+2, my+2,
// mx+2, C), whose interior slots are zero.
template <int NR>
__global__ void ghost_assemble_kernel(float* __restrict__ out, const float* __restrict__ groups,
                                      float* __restrict__ react, Ghost g, int c, int pencils) {
  const int gz = g.mz + 2, gy = g.my + 2, gx = g.mx + 2;
  const long n_ghost = static_cast<long>(pencils / (g.mz * g.my)) * gz * gy * gx * c;
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_ghost) return;
  const int slot = t % c;
  long r = t / c;
  const int xg = r % gx;
  r /= gx;
  const int yg = r % gy;
  r /= gy;
  const int zg = r % gz;
  const int s = r / gz;
  const bool interior = zg >= 1 && zg <= g.mz && yg >= 1 && yg <= g.my && xg >= 1 && xg <= g.mx;
  const long n_own = static_cast<long>(pencils) * g.mx * c;
  const long own = ((static_cast<long>(s * g.mz + zg - 1) * g.my + yg - 1) * g.mx + xg - 1) * c + slot;
  const long mr = static_cast<long>(gx) * c;
#pragma unroll
  for (int comp = 0; comp < NR; ++comp) {
    float v = interior ? out[comp * n_own + own] : 0.f;
#pragma unroll
    for (int sl = 0; sl <= kGroups; ++sl) {
      const int sz = zg - 1 - kSliceDz[sl], sy = yg - 1 - kSliceDy[sl];
      if (sz < 0 || sz >= g.mz || sy < 0 || sy >= g.my) continue;
      const long p = (static_cast<long>(s) * g.mz + sz) * g.my + sy;
      v += groups[((static_cast<long>(sl) * NR + comp) * pencils + p) * mr + xg * c + slot];
    }
    if (interior) out[comp * n_own + own] = v;
    react[comp * n_ghost + t] = interior ? 0.f : v;
  }
}

int centre_slots(int c) { return c <= 32 ? 1 : (c <= 64 ? 2 : 3); }

size_t smem_bytes(int m, int c, bool energy, bool mol, int ne, int neb) {
  const int na = centre_slots(c);
  const int nt = na <= 2 ? 64 : 96;
  const int nf = mol ? 7 : 5;
  return sizeof(float) * 2 * (energy ? 5 : 3) * static_cast<size_t>(m) * c +
         sizeof(float) * (nf + 1) * nt * 2 * kWarps + sizeof(float) * tag_floats(nt, ne, neb) * kWarps;
}

// GHOST: the centre sums and one (mx+2)·C reaction row, the tiles and the
// staged centre tags (no bond tags).
size_t ghost_smem_bytes(int mx, int c, bool energy, bool mol, int ne) {
  const int na = centre_slots(c);
  const int nt = na <= 2 ? 64 : 96;
  const int nf = mol ? 7 : 5;
  return sizeof(float) * (energy ? 5 : 3) * static_cast<size_t>(2 * mx + 2) * c +
         sizeof(float) * (nf + 1) * nt * 2 * kWarps + sizeof(float) * tag_floats(nt, ne, 0) * kWarps;
}

template <int NA, bool UNIFORM, bool ENERGY, bool COULOMB = false, bool EXCL = false>
int launch_ghost(const Fields& f, const Mol& mol, float* out, float* groups, const Ghost& g, int blocks, int m,
                 int c, const float* box, const PairConsts& k, cudaStream_t stream) {
  const size_t smem = ghost_smem_bytes(g.mx, c, ENERGY, COULOMB || EXCL, mol.ne);
  auto kernel = streaming_ghost_kernel<NA, UNIFORM, ENERGY, COULOMB, EXCL>;
  static size_t smem_allowed = 48 * 1024;  // raised once per variant, not per launch
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(f, mol, out, groups, g, m, c, box, k);
  return static_cast<int>(cudaGetLastError());
}

template <int NA>
int dispatch_ghost(const Fields& f, const Mol& mol, int coulomb, int excl, int uniform, int energy, float* out,
                   float* groups, const Ghost& g, int blocks, int m, int c, const float* box, const PairConsts& k,
                   cudaStream_t s) {
#define EMDEE_K5S(UN, EN, CO, EX) launch_ghost<NA, UN, EN, CO, EX>(f, mol, out, groups, g, blocks, m, c, box, k, s)
  if (coulomb || excl) {
    if (energy) {
      if (coulomb && excl) return EMDEE_K5S(false, true, true, true);
      if (coulomb) return EMDEE_K5S(false, true, true, false);
      return EMDEE_K5S(false, true, false, true);
    }
    if (coulomb && excl) return EMDEE_K5S(false, false, true, true);
    if (coulomb) return EMDEE_K5S(false, false, true, false);
    return EMDEE_K5S(false, false, false, true);
  }
  if (uniform && energy) return EMDEE_K5S(true, true, false, false);
  if (uniform) return EMDEE_K5S(true, false, false, false);
  if (energy) return EMDEE_K5S(false, true, false, false);
  return EMDEE_K5S(false, false, false, false);
#undef EMDEE_K5S
}

template <int NA, bool UNIFORM, bool ENERGY, bool COULOMB = false, bool EXCL = false, bool BOND = false>
int launch(const Fields& f, const Mol& mol, float* fx, float* fy, float* fz, int fstride, float* e, float* w,
           float* groups, int m, int c, const float* box, const PairConsts& k, cudaStream_t stream) {
  static_assert(sizeof(Tile<tile_entries<NA>(), (COULOMB || EXCL) ? 7 : 5>) ==
                    sizeof(float) * (((COULOMB || EXCL) ? 7 : 5) + 1) * tile_entries<NA>(),
                "smem_bytes counts the tiles as packed floats");
  const size_t smem = smem_bytes(m, c, ENERGY, COULOMB || EXCL, mol.ne, mol.neb);
  auto kernel = streaming_kernel<NA, UNIFORM, ENERGY, COULOMB, EXCL, BOND>;
  static size_t smem_allowed = 48 * 1024;  // raised once per variant, not per launch
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  kernel<<<m * m, kThreads, smem, stream>>>(f, mol, fx, fy, fz, fstride, e, w, groups, m, c, box, k);
  return static_cast<int>(cudaGetLastError());
}

template <int NA>
int dispatch(const Fields& f, float* fx, float* fy, float* fz, int fstride, float* e, float* w,
             float* groups, int m, int c, const float* box, const PairConsts& k, int uniform,
             int energy, cudaStream_t s) {
  const Mol mol{};
  if (uniform && energy) return launch<NA, true, true>(f, mol, fx, fy, fz, fstride, e, w, groups, m, c, box, k, s);
  if (uniform) return launch<NA, true, false>(f, mol, fx, fy, fz, fstride, e, w, groups, m, c, box, k, s);
  if (energy) return launch<NA, false, true>(f, mol, fx, fy, fz, fstride, e, w, groups, m, c, box, k, s);
  return launch<NA, false, false>(f, mol, fx, fy, fz, fstride, e, w, groups, m, c, box, k, s);
}

// The molecular variants: per-atom parameters, the flag sets of K2c.
template <int NA, bool ENERGY>
int dispatch_mol_e(int coulomb, int excl, int bond, const Fields& f, const Mol& mol, float* fo, float* e, float* w,
                 float* groups, int m, int c, const float* box, const PairConsts& k, cudaStream_t s) {
#define EMDEE_K5C(CO, EX, BO) \
  launch<NA, false, ENERGY, CO, EX, BO>(f, mol, fo, fo + 1, fo + 2, 3, e, w, groups, m, c, box, k, s)
  if (coulomb && bond) return EMDEE_K5C(true, true, true);
  if (coulomb && excl) return EMDEE_K5C(true, true, false);
  if (coulomb) return EMDEE_K5C(true, false, false);
  if (bond) return EMDEE_K5C(false, true, true);
  return EMDEE_K5C(false, true, false);
#undef EMDEE_K5C
}

template <int NA>
int dispatch_mol(int coulomb, int excl, int bond, int energy, const Fields& f, const Mol& mol, float* fo,
                 float* e, float* w, float* groups, int m, int c, const float* box, const PairConsts& k,
                 cudaStream_t s) {
  if (energy) return dispatch_mol_e<NA, true>(coulomb, excl, bond, f, mol, fo, e, w, groups, m, c, box, k, s);
  return dispatch_mol_e<NA, false>(coulomb, excl, bond, f, mol, fo, e, w, groups, m, c, box, k, s);
}

}  // namespace

#if EMDEE_IN_PART(0)
// The pair pass: centre sums (+ own-row reactions) into fx, fy, fz [, e, w]
// and the four reaction rows of every pencil into `groups` (4, n_r, M³·C).
extern "C" int emdee_streaming_forces(
    const float* px, const float* py, const float* pz, int pstride, const float* hs,
    const float* tse, const uint8_t* valid, float* fx, float* fy, float* fz, int fstride,
    float* e, float* w, float* groups, int m, int c, const float* box, float rc2, float rs2,
    float invd2, float a_m, float pa1, float pa2, float pb1, float pb2, float sig2_u,
    float eps4_u, int uniform, int energy, void* stream) {
  const size_t smem = smem_bytes(m, c, energy, false, 0, 0);
  if (m < 3 || c < 1 || c > kMaxCapacity || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const PairConsts k{rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, sig2_u, eps4_u};
  const Fields f{px, py, pz, pstride, hs, tse, valid};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (centre_slots(c)) {
    case 1: return dispatch<1>(f, fx, fy, fz, fstride, e, w, groups, m, c, box, k, uniform, energy, s);
    case 2: return dispatch<2>(f, fx, fy, fz, fstride, e, w, groups, m, c, box, k, uniform, energy, s);
    default: return dispatch<3>(f, fx, fy, fz, fstride, e, w, groups, m, c, box, k, uniform, energy, s);
  }
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
#endif

#if EMDEE_IN_PART(1)
// The molecular pair pass (K5c): stacked positions and forces (M³, C, 3),
// per-atom (σ/2, 2√ε), optional per-slot energies and virials; q (M³, C)
// charges and the DSF constants' device pointers with `coulomb`; aid (M³,
// C) int32 atom ids and the tags (M³, C, ne) with `excl` (mcs only with
// `coulomb`); the bond weights (M³, C, neb) with `bond` (kr02 only with
// `energy`).  The reaction rows go to `groups` as in the LJ entry, and
// `emdee_streaming_fold` (fstride 3) adds them.
extern "C" int emdee_streaming_forces_mol(
    const float* pos, const float* hs, const float* tse, const uint8_t* valid, const float* q,
    const int* aid, const float* ids, const float* mlj, const float* mcs, const float* kb,
    const float* kr0, const float* kr02, int ne, int neb, const float* alpha, const float* rc,
    const float* rc2_c, const float* e_shift, const float* f_shift, const float* kc, float* f, float* e,
    float* w, float* groups, int m, int c, const float* box, float rc2, float rs2, float invd2, float a_m,
    float pa1, float pa2, float pb1, float pb2, int coulomb, int excl, int bond, int energy, void* stream) {
  if (!excl) ne = 0;
  if (!bond) neb = 0;
  const size_t smem = smem_bytes(m, c, energy, true, ne, neb);
  if (m < 3 || c < 1 || c > kMaxCapacity || smem > 232448 || (!coulomb && !excl) || (bond && !excl) ||
      (excl && (ne < 1 || ne > kMaxTags)) || (bond && (neb < 1 || neb > ne)))
    return static_cast<int>(cudaErrorInvalidValue);
  const PairConsts k{rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, 0.f, 0.f};
  const Fields fl{pos, pos + 1, pos + 2, 3, hs, tse, valid};
  const Mol mol{q, aid, ids, mlj, mcs, kb, kr0, kr02, ne, neb, alpha, rc, rc2_c, e_shift, f_shift, kc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (centre_slots(c)) {
    case 1: return dispatch_mol<1>(coulomb, excl, bond, energy, fl, mol, f, e, w, groups, m, c, box, k, s);
    case 2: return dispatch_mol<2>(coulomb, excl, bond, energy, fl, mol, f, e, w, groups, m, c, box, k, s);
    default: return dispatch_mol<3>(coulomb, excl, bond, energy, fl, mol, f, e, w, groups, m, c, box, k, s);
  }
}
#endif

#if EMDEE_IN_PART(2)
// The GHOST pair pass (K5s): the ghost grids of `shards` local shards, px
// … tse each (shards, mz+2, my+2, mx+2, C) float32 with NaN positions in
// empty slots (hs, tse unused with uniform parameters); with `coulomb` the
// charges q, with `excl` the int32 atom ids aid (−2 on empty slots) in the
// same layout and the centre tags ids, mlj, mcs (shards, mz, my, mx, C, ne)
// (mcs only with `coulomb`), the DSF constants' device pointers with
// `coulomb`.  Writes the centre sums to out (3 or 5, shards·mz·my·mx·C) and
// the reaction rows to groups (5, 3 or 5, shards·mz·my, (mx+2)·C);
// `emdee_streaming_ghost_assemble` adds them up.
extern "C" int emdee_streaming_ghost(
    const float* px, const float* py, const float* pz, const float* hs, const float* tse, const float* q,
    const int* aid, const float* ids, const float* mlj, const float* mcs, int ne, const float* alpha,
    const float* rc, const float* rc2_c, const float* e_shift, const float* f_shift, const float* kc, float* out,
    float* groups, int mz, int my, int mx, int shards, int sy_n, int sx_n, int bz, int by, int bx, int m, int c,
    const float* box, float rc2, float rs2, float invd2, float a_m, float pa1, float pa2, float pb1, float pb2,
    float sig2_u, float eps4_u, int uniform, int coulomb, int excl, int energy, void* stream) {
  if (!excl) ne = 0;
  const bool mol = coulomb || excl;
  const size_t smem = ghost_smem_bytes(mx, c, energy, mol, ne);
  if (m < 3 || c < 1 || c > kMaxCapacity || mz < 1 || my < 1 || mx < 1 || shards < 1 || sy_n < 1 || sx_n < 1 ||
      shards % (sy_n * sx_n) != 0 || smem > 232448 || (mol && uniform) || (excl && (ne < 1 || ne > kMaxTags)))
    return static_cast<int>(cudaErrorInvalidValue);
  const PairConsts k{rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, sig2_u, eps4_u};
  const Fields f{px, py, pz, 1, hs, tse, nullptr};
  const Mol mol_ops{q, aid, ids, mlj, mcs, nullptr, nullptr, nullptr, ne, 0, alpha, rc, rc2_c, e_shift, f_shift, kc};
  const Ghost g{mz, my, mx, sy_n, sx_n, bz, by, bx};
  const int blocks = shards * mz * my;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (centre_slots(c)) {
    case 1: return dispatch_ghost<1>(f, mol_ops, coulomb, excl, uniform, energy, out, groups, g, blocks, m, c, box, k, s);
    case 2: return dispatch_ghost<2>(f, mol_ops, coulomb, excl, uniform, energy, out, groups, g, blocks, m, c, box, k, s);
    default: return dispatch_ghost<3>(f, mol_ops, coulomb, excl, uniform, energy, out, groups, g, blocks, m, c, box, k, s);
  }
}

// The GHOST assembly: adds the five reaction slices to the centre sums in
// `out` in place and writes the ghost slots' sums to react (3 or 5,
// shards, mz+2, my+2, mx+2, C).
extern "C" int emdee_streaming_ghost_assemble(float* out, const float* groups, float* react, int mz, int my, int mx,
                                              int shards, int c, int energy, void* stream) {
  if (mz < 1 || my < 1 || mx < 1 || shards < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Ghost g{mz, my, mx, 1, 1, 0, 0, 0};
  const long n_ghost = static_cast<long>(shards) * (mz + 2) * (my + 2) * (mx + 2) * c;
  const int threads = 256;
  const long blocks = (n_ghost + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (energy)
    ghost_assemble_kernel<5><<<blocks, threads, 0, s>>>(out, groups, react, g, c, shards * mz * my);
  else
    ghost_assemble_kernel<3><<<blocks, threads, 0, s>>>(out, groups, react, g, c, shards * mz * my);
  return static_cast<int>(cudaGetLastError());
}
#endif
