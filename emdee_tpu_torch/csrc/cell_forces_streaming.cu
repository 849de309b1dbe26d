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
// Design.  Warps own a centre cell's phases, in the pencil's order:
// phase 0 is the self cell, phase 1 + k the half-shell offset k of kOff*
// (dx = −1, 0, +1 of the row groups (0, 1), (1, −1), (1, 0), (1, 1), then dx
// = +1 of the own row (0, 0)).  In a phase the warp evaluates every pair of
// its centre cell with the neighbour cell, each unique pair once.  It
// compacts the live slots of its cell once into a shared tile (ballot
// ranks, slot order) and, in each phase, the neighbour cell's into a
// second; it culls the pair to the atoms within the cutoff of the other
// cell's bounding box (below; the centres kept go to a third tile, so the
// first stays whole for the next phase), and runs the ring: a lane holds
// a live centre slot; the neighbour's live slots travel round a ring of W =
// max(live centres, live neighbours) lanes as packets (position, parameters
// and the reaction sums), one lane per step by shuffle, so after W steps
// every lane has met every packet and each packet is back on its own lane
// with −Σᵢ f_ij summed in a fixed order.  Capacities above 32 take a second
// centre slot per lane and a second packet chunk, above 64 a third.
// The tiles hold x, y, z (and σ/2, 2√ε with per-atom parameters): 3 KB a
// warp with uniform parameters at C ≤ 64, 4.5 KB per atom.
//
// C > 96 (up to the resident family's 1024; the reference's streaming
// kernel has no limit): every kernel of this file (K5, K5c, K5s, K5s-mol)
// has a chunked variant (NA = kChunked).  A cell is compacted into
// 96-entry chunks in slot order (`compact_chunks`), and a cell pair runs
// as its chunk pairs, centre chunk p outer and neighbour chunk q inner,
// each through the three-slot ring of `pair_tiles` with the cull per chunk
// pair (`pair_chunks`), so the registers stay those of three slots a lane.
// The centre and reaction rows stay (n_r, C) in shared memory and gather a
// slot's sums over its chunk pairs in that fixed order: no float atomics,
// bitwise reruns.  A warp's chunks take (2K + 2)·(NF + 1)·96 floats (K =
// ⌈C/96⌉), so a block holds as many warps as its shared memory allows, at
// most the kernel's usual count; only a C whose one warp (and, for the
// pencil, its rows) does not fit is refused.  C ≤ 96 runs the three-slot
// variants, whose sums the chunked code does not touch.
//
// No block barrier, no float atomics.  A warp walks all 14 phases of one
// cell (a trial on this card against one phase a warp, K5c's form, is in
// PERF.md): its centre sums gather in its shared row over the phases and
// leave once, to centre slice 0 of a scratch (14, n_r, M³·C); offset k's
// reactions go to reaction slice k (slice 1 + k) at the neighbour's own
// slots, every slot of the neighbour cell (zeros where no pair reached
// it).  For a fixed offset the map from centre cell to neighbour cell is a
// bijection, so every slot of every slice is written by exactly one warp,
// once.  A second launch (`lj_fold_kernel`) adds, for each slot, the centre
// sums, then the own row's reactions (offset 12), then each row group's
// three reaction slices as one term: the association of the pencil kernel,
// which summed the phases in a shared centre row, added its own row's
// reactions on writing the outputs and left each row group's three dx
// phases summed in one reaction row for its fold.  Reruns are bitwise equal
// (the engine's determinism contract); built without the cull
// (-DEMDEE_K5_NO_CULL, tools/ab_streaming.py only) each phase's sums are
// formed by the same ring (`pair_tiles`) on the same tile contents as the
// pencil's, so the outputs equal the pencil kernel's bit for bit.  The scratch is
// stored and read with the streaming cache hint (`__stcs`, `__ldcs`), so
// that it does not evict from L2 the cells that the warps read.
//
// The cull (K5c's, at rc²).  The warp reduces the bounding box of the
// neighbour's live entries (by the warp's integer min and max reductions,
// `tile_box`), shifted by the phase's periodic shift, and keeps only the
// centre entries whose distance to that box is below the cutoff; then it
// keeps only the neighbour entries within the cutoff of the kept centres'
// box.  Both tiles stay in slot order, so the cull changes only which
// lanes meet in the ring, and roundoff.  The test is conservative (the
// slack of `emdee::near_box`), so no pair whose computed r² lies below rc²
// is dropped (`streaming_kernel.cull_pair` mirrors it for the CPU tests);
// the boxes come from the atoms, so an atom that overhangs its cell
// between rebins needs no assumption.  At the 1M melt (cell 2.86σ, rc
// 2.5σ) it keeps ~0.82 of a cell against a face, ~0.52 against an edge and
// ~0.27 against a corner.  The self phase is not culled.
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
// skipped; an empty slot's outputs are exact zeros (its slices are written
// as zeros).
//
// Numerics: the Horner form of the switched −r·dE/dr in r² with an exact
// IEEE 1/r² (no fast math), pairs at r² ≥ rc² skipped, as in cell_forces.cu.
//
// COULOMB, EXCL, BOND (K5c: the streaming kernel's molecular branches,
// `_make_streaming_kernel` :1185-1250 with `names` + q, aid and the centre
// tags and bond weights of `_unpack_centers` :347; entry
// `pallas_cell_forces_streaming` :1417-1500), through
// `emdee_streaming_forces_mol`: per-atom parameters, the stacked state, and
// a kernel of its own (`streaming_owned_kernel`).  The pencil layout gives
// too few blocks at these boxes (144 blocks of 8 warps at the 98,304-atom
// box, one ~141 KB block an SM at 985,527 atoms) and a barrier after each
// phase, and only ~9% of a ring's candidates lie inside the cutoff.
//
// Warp-owned centre cells, in K5's phase order.  A warp owns one phase of
// one centre cell, warp phase · M³ + cell, so that the warps resident at
// once walk one offset over neighbouring cells.  (A trial on this card split
// a cell's 14 phases over 1, 2, 7 and 14 warps: one phase a warp ran fastest
// at both water sizes.)  The warp sums its centres in a row of its shared memory and
// writes them once, to centre slice `phase` of a scratch (27, n_r, M³·C);
// the reactions of offset k go to slice 14 + k at the neighbour's own
// slots, every slot of the neighbour cell (zeros where no pair reached
// it).  For a fixed offset the map from centre cell to neighbour cell is a
// bijection, so every slot of every slice is written by exactly one warp,
// once.  A second launch (`owned_fold_kernel`) adds the 14 centre slices
// and then the 13 reaction slices in that fixed order: no block barrier,
// no float atomics, bitwise reruns.  Blocks of 4 warps; a warp's shared
// memory is its two tiles, its staged tags and its centre and reaction
// rows, ~12.7 KB at C = 80 (E = E_b = 2), so registers (at most 128 a
// thread, `__launch_bounds__`) and shared memory both allow 16 warps an SM.
// Every warp evaluates one cell pair.  Scratch, forces only: 27 slices × 3
// × 138,240 slots = 44.8 MB at the 98,304-atom box, 27 × 3 × 1,546,688 =
// 501 MB at 985,527 atoms; the fold reads it once (~0.013 and ~0.15 ms at
// 3.35 TB/s).  The scratch is stored and read with the streaming cache hint
// (`__stcs`, `__ldcs`), so that it does not evict from L2 the cells that
// the warps read.
//
// The cull, as K5's at the larger of the two cutoffs.  The test is
// conservative: each axis' gap is lowered by a slack of
// 2⁻¹⁹ of the magnitudes in play (≤ 1e-3 Å at these boxes, against a
// rounding error of ~1e-5 Å in a displacement), so no pair whose computed
// r² lies below cut2 is dropped (`streaming_kernel.cull_keep` mirrors it for
// the CPU tests).  The boxes come from the atoms, so an atom that overhangs
// its cell between rebins needs no assumption.  At the 98,304-atom box
// (cell 8.29 Å, cutoff 7 Å) it keeps ~0.84 of a cell against a face, ~0.56
// against an edge and ~0.31 against a corner.  The self phase is not culled.
//
// The tiles also carry each live slot's charge and int32 atom id, and the
// packets take them round the ring (a ring lane past the live packets
// carries atom id −2, which no tag holds).  The centre's E ≤ 8 tags (atom
// id, 1 − s_LJ, 1 − s_C) and E_b bond weights (k, k·r0, k·r0²) are staged
// per warp in shared memory, tag-major so that the lanes read consecutive
// words.  Each lane stages and reads only its own centre entries, so the
// staging needs no barrier.  A pair matches the centre's tags against the
// packet's atom id only: the tables are symmetric (a pair sits in both
// atoms' rows with the same weights), so the scale is the one the full
// shell gives from either side, and a bond is evaluated once, its reaction
// on the packet.  The pair math is K2c's (`emdee::mol_terms`, lj_pair.cuh):
// DSF in the exact erfcf/expf form with its constants read from 0-d device
// tensors, the bond only inside the LJ cutoff, pairs skipped beyond the
// larger of the two cutoffs.  Per-slot ½E and ½W go half to the centre and
// half to the reaction, as K5 does.  The plain version is K2c's,
// `cell_dense_forces(coulomb=, excl=)`.
//
// GHOST (K5s: the streaming kernel on each shard of the grid-sharded
// engine, `streaming_halfshell_call` with `wrap_reaction=False` as
// emdee_tpu/distributed/grid_sharded.py `_local_forces_streaming` :658-702
// and `_local_energy_pallas` :704-744 call it), through
// `emdee_streaming_ghost` (LJ), keeps the pencil design: one block of 8
// warps per interior pencil (z, y) of each local shard, centres and
// neighbours read from the shards' stacked (mz+2, my+2, mx+2, C) ghost
// grids, whose positions carry NaN in empty slots; nothing wraps.  The
// block walks the 14 phases in K5's order, a barrier after each; in a
// phase warp w takes the centre cells x ≡ w (mod 8) of the pencil and runs
// `cell_pair` without the cull, its centre sums into the pencil's shared
// centre row and its reactions into the group's shared reaction row (within
// a phase the map x → x+dx is a bijection, so no two warps touch one
// reaction lane).  Each periodic shift comes from the neighbour's GLOBAL
// cell index on raw
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
// bit.  Its sums on (1,1,1) agree with K5's to roundoff (the cull reorders
// K5's rings).  Plain version: emdee_tpu_torch/neighbors/streaming_kernel.py
// `streaming_ghost_forces_plain`.
//
// GHOST with COULOMB/EXCL (K5s-mol), through `emdee_streaming_ghost_mol`:
// K5c's warp-owned kernel (`streaming_owned_kernel` with GHOST) on the
// ghost grids, which also carry charges and int32 atom ids; the centre
// tags are per own slot; no bond tags (the grid keeps its bonds as term
// rows).  A warp owns one phase of one own cell, warp = phase · cells +
// cell over the local shards' own cells, and culls each neighbour pair as
// K5c does, with the shift from the neighbour's global cell index (a shard
// face that is no periodic seam has none).  Its centre sums go to centre
// slice `phase` (n_r, own slots) and offset k's reactions to reaction
// slice k (n_r, ghost slots) at the neighbour's ghost-grid slots, every
// slot of the neighbour cell: for a fixed offset the map from own cell to
// ghost cell is one to one, so every written slot is written by one warp,
// once.  A second launch (`owned_ghost_assemble_kernel`) adds, for each
// slot of the ghost grids, the 14 centre slices (interior slots) and then
// the reaction slices whose offset's image holds that slot, in a fixed
// order, to the centre sums or the reaction ghost grid: the return
// contract of the pencil's assembly, so `_fold3` and the engine are
// unchanged.  Scratch at the 985,527-atom box on (2,2,2): 14 × 3 ×
// 1,546,688 + 13 × 3 × 2,376,000 floats, 630 MB (1.05 GB with energies).
// The pencil kernel ran these flags before, with 13 centre cells over 8
// warps, a barrier after each phase and no cull.

// Bound on this card: at the 1,000,188-atom melt (M = 37, C = 32) ~27 M
// pairs lie inside the cutoff: ~1.4 GFLOP, ~0.02 ms at 67 TFLOP/s; the
// function's own bytes (25 B a slot in, 12 out) ~0.018 ms at 3.35 TB/s.
// The design adds the scratch: 14 slices × 3 × 1,620,896 floats, 272 MB
// forces only (454 MB with energies), written once and read back by the
// fold, ~0.16 ms (0.27).  The ring loop's instruction rate and latency set
// the rest (PERF.md): the cull leaves ~150 ring steps a cell against ~308
// without it.  At the 98,304-atom water box (M = 12, C = 80) K5c's unique
// pairs inside the cutoff each pay an erfc, an exp, a square root and 3E
// tag operations; chip_smoke.py counts them and gives the bound.

// emdee-build-parts: 8
// csrc/build.py compiles this file as eight objects at once, to cut the
// build's wall time: EMDEE_PART 0 holds K5's entries and its variants, 1 K5c's
// entries and force variants, 2 the GHOST entries, the K5s pencil's variants
// and K5s-mol's force variants, 3 K5c's energy variants, 4 K5s-mol's energy
// variants, and the chunked variants (C > 96) of the warp-owned kernel —
// the costliest to compile — 5 K5c's without and 6 with energies, 7
// K5s-mol's (each part instantiates only its kernel variants); without
// EMDEE_PART the file holds them all.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

constexpr int kWarps = 8;  // K5s: warps a pencil block
constexpr int kThreads = 32 * kWarps;
constexpr int kGroups = 4;  // the half shell's row groups besides the own row
constexpr int kMaxCapacity = 1024;  // as the resident family (cell_forces.cu)
// Above three centre slots a lane (C > 96) the variants take NA = kChunked:
// a cell is compacted into kChunk-entry chunks, and a cell pair runs as its
// chunk pairs, each through the three-slot ring.
constexpr int kChunk = 96;
constexpr int kChunked = 4;
constexpr int kSmemBytes = 232448;  // shared memory a block can use on Hopper
constexpr unsigned kFull = 0xffffffffu;
// The row groups (dz, dy) in fold order; the own row (0, 0) comes last.
__constant__ int kGroupDz[kGroups] = {0, 1, 1, 1};
__constant__ int kGroupDy[kGroups] = {1, -1, 0, 1};

}  // namespace

namespace emdee {

// A kernel's input fields (named, not file-local: K5c's energy variants
// are built in another object than its entry).
struct Fields {
  const float* px;
  const float* py;
  const float* pz;
  int pstride;
  const float* hs;
  const float* tse;
  const uint8_t* valid;
};

// GHOST geometry, as cell_forces.cu's: local cells (mz, my, mx) per shard,
// the local shards' grid (sy_n, sx_n after the leading z count), and the
// global coordinates (bz, by, bx) of the first local shard.  One card's
// grid is the geometry (m, m, m, 1, 1, 0, 0, 0) of one shard.
struct Ghost {
  int mz, my, mx, sy_n, sx_n, bz, by, bx;
};

// A warp-owned kernel (K5c, K5s-mol): every variant takes these arguments.
using OwnedKernel = void (*)(Fields, Mol, float*, Ghost, int, int, int, const float*, PairConsts);

// A warp-owned variant and the dynamic shared memory it is allowed so far.
struct OwnedVariant {
  OwnedKernel kernel;
  size_t* smem_allowed;
};

// K5c's and K5s-mol's variants without and with energies, each in its own
// build part, and their chunked variants (C > 96), in three more.
OwnedVariant k5c_force_variant(int c, int coulomb, int excl, int bond);
OwnedVariant k5c_energy_variant(int c, int coulomb, int excl, int bond);
OwnedVariant k5s_mol_force_variant(int c, int coulomb, int excl);
OwnedVariant k5s_mol_energy_variant(int c, int coulomb, int excl);
OwnedVariant k5c_chunked_force_variant(int coulomb, int excl, int bond);
OwnedVariant k5c_chunked_energy_variant(int coulomb, int excl, int bond);
OwnedVariant k5s_mol_chunked_variant(int energy, int coulomb, int excl);

}  // namespace emdee

namespace {

using emdee::Fields;
using emdee::Ghost;

// Entries of a warp's cell tile: 64 up to two centre slots a lane (the LJ
// kernel's tile since K5), 96 with three (and a chunk's with kChunked).
template <int NA>
__host__ __device__ constexpr int tile_entries() {
  return NA <= 2 ? 64 : 96;
}

// The chunks a cell of capacity C takes at kChunked.
__host__ __device__ constexpr int chunks_of(int c) { return (c + kChunk - 1) / kChunk; }

// A warp's compacted copy of one cell: the live slots' fields in slot
// order at entries 0 … n−1 — x, y, z, then σ/2, 2√ε (NF ≥ 5; K5 with
// uniform parameters keeps only the positions, NF = 3) and, with the
// molecular terms (NF = 7), the charge and the atom id's bits — and each
// entry's slot.
template <int NT, int NF>
struct Tile {
  float f[NF][NT];
  int slot[NT];
};

// Floats of a warp's staged centre tags: per entry, three values for each
// exclusion tag and each bond tag.
__host__ __device__ constexpr int tag_floats(int nt, int ne, int neb) { return 3 * (ne + neb) * nt; }

__device__ __forceinline__ int wrap(int v, int m, const float* __restrict__ box, float& shift) {
  shift = 0.f;
  if (v < 0) { shift = -*box; return v + m; }
  if (v >= m) { shift = *box; return v - m; }
  return v;
}

// Entry e of tile `t`: the fields of input slot s, slot j of its cell.
template <int NT, int NF, bool UNIFORM>
__device__ __forceinline__ void put_entry(const Fields& f, const Mol& mol, long s, int j, Tile<NT, NF>& t, int e) {
  t.f[0][e] = f.px[s * f.pstride];
  t.f[1][e] = f.py[s * f.pstride];
  t.f[2][e] = f.pz[s * f.pstride];
  if constexpr (!UNIFORM && NF >= 5) {
    t.f[3][e] = f.hs[s];
    t.f[4][e] = f.tse[s];
  }
  if constexpr (NF > 5) {
    t.f[5][e] = mol.q ? mol.q[s] : 0.f;
    t.f[6][e] = __int_as_float(mol.aid ? mol.aid[s] : -2);
  }
  t.slot[e] = j;
}

// Whether input slot s holds an atom: the valid mask, or (GHOST, no valid
// mask) an x that is not NaN, as an empty ghost slot holds.
__device__ __forceinline__ bool slot_live(const Fields& f, long s) {
  return f.valid ? f.valid[s] != 0 : !isnan(f.px[s * f.pstride]);
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
    const bool live = j < c && slot_live(f, s);
    const unsigned mask = __ballot_sync(kFull, live);
    if (live) put_entry<NT, NF, UNIFORM>(f, mol, s, j, t, n + __popc(mask & ((1u << lane) - 1u)));
    n += __popc(mask);
  }
  return n;
}

// `compact` at C > 96: the live slots into the chunks t[0], t[1], … in
// slot order (entry e at t[e / 96], index e % 96), 32 slots at a time;
// returns their count.  The caller brackets it with warp barriers.
template <int NF, bool UNIFORM>
__device__ __forceinline__ int compact_chunks(const Fields& f, const Mol& mol, long cell, int c,
                                              Tile<kChunk, NF>* t) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int j0 = 0; j0 < c; j0 += 32) {
    const int j = j0 + lane;
    const long s = cell * c + j;
    const bool live = j < c && slot_live(f, s);
    const unsigned mask = __ballot_sync(kFull, live);
    if (live) {
      const int e = n + __popc(mask & ((1u << lane) - 1u));
      put_entry<kChunk, NF, UNIFORM>(f, mol, s, j, t[e / kChunk], e % kChunk);
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

// The bounding box of tile `t`'s first `n` entries, on every lane, by the
// warp's integer min and max reductions: each float taken to an int of the
// same order (its bits, the magnitude bits flipped when negative).
template <int NA, int NT, int NF>
__device__ __forceinline__ void tile_box(const Tile<NT, NF>& t, int n, float lo[3], float hi[3]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    int kl = 0x7fffffff, kh = -0x7fffffff - 1;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const int e = 32 * a + lane;
      if (e < n) {
        const int b = __float_as_int(t.f[v][e]);
        const int key = b >= 0 ? b : b ^ 0x7fffffff;
        kl = min(kl, key);
        kh = max(kh, key);
      }
    }
    kl = __reduce_min_sync(kFull, kl);
    kh = __reduce_max_sync(kFull, kh);
    lo[v] = __int_as_float(kl >= 0 ? kl : kl ^ 0x7fffffff);
    hi[v] = __int_as_float(kh >= 0 ? kh : kh ^ 0x7fffffff);
  }
}

// Keep the entries of tile `src` (n live) within the cutoff of the box [lo
// + o, hi + o], compacted in slot order into `dst` (which may be `src`);
// returns their count.
template <int NA, int NT, int NF>
__device__ __forceinline__ int cull(const Tile<NT, NF>& src, int n, Tile<NT, NF>& dst, const float lo[3],
                                    const float hi[3], const float o[3], float cut2) {
  const int lane = threadIdx.x & 31;
  float val[NA][NF];
  int slot[NA];
  bool keep[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int e = 32 * a + lane;
    keep[a] = false;
    if (e < n) {
#pragma unroll
      for (int v = 0; v < NF; ++v) val[a][v] = src.f[v][e];
      slot[a] = src.slot[e];
      const float p[3] = {val[a][0], val[a][1], val[a][2]};
      keep[a] = emdee::near_box(p, lo, hi, o, cut2);
    }
  }
  __syncwarp();  // every entry is read before any moves
  int kept = 0;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const unsigned mask = __ballot_sync(kFull, keep[a]);
    if (keep[a]) {
      const int e = kept + __popc(mask & ((1u << lane) - 1u));
#pragma unroll
      for (int v = 0; v < NF; ++v) dst.f[v][e] = val[a][v];
      dst.slot[e] = slot[a];
    }
    kept += __popc(mask);
  }
  __syncwarp();
  return kept;
}

// All pairs of a centre cell's compacted tile `src` (n_cen live entries)
// with a neighbour cell's `tn` (n_nb; shifted by (shx, shy, shz)) for one
// warp (and, with EXCL, its tag tile, read at the centre's own cell
// `tag_cell`).  Centre sums go to cen_acc[k·mc + x·C + i]; with REACT, the
// reaction sums go to row[k·mr + nx·C + j].  With CULL (K5, K5c), the pair
// first drops the entries beyond the cutoff of the other cell's bounding
// box: the centres kept go to `work` (which may be `src`), the neighbours
// kept stay in `tn`.  Without REACT (the self cell) tn is src, and the
// self pair is skipped (SKIP_SELF; the off-diagonal chunk pairs of a self
// cell at C > 96 pair two chunks of one cell without it).  The tiles hold
// NF fields (`Tile`).
template <int NA, bool UNIFORM, bool ENERGY, bool REACT, bool COULOMB, bool EXCL, bool BOND, bool CULL, int NT,
          int NF, bool SKIP_SELF = !REACT>
__device__ __forceinline__ void pair_tiles(const Mol& mol, const Dsf& dsf, float cut2, long tag_cell, int c, int x,
                                           int nx, float shx, float shy, float shz, int mc, int mr, float* cen_acc,
                                           float* row, const Tile<NT, NF>& src, int n_cen, Tile<NT, NF>& work,
                                           Tile<NT, NF>& tn, int n_nb, float* tags, const PairConsts& k) {
  constexpr bool MOL = COULOMB || EXCL;
  // The rows of σ/2 and 2√ε (row 0 in a tile that holds neither: UNIFORM reads none).
  constexpr int kHs = NF >= 5 ? 3 : 0, kTse = NF >= 5 ? 4 : 0;
  const int lane = threadIdx.x & 31;
  if (n_cen == 0 || n_nb == 0) return;
  const Tile<NT, NF>* cen_tile = &src;
  if constexpr (CULL && REACT) {
    // d = (x_i − x_j) − shift: the neighbour sits at x_j + shift, a centre at x_i − shift from it.
    const float sh[3] = {shx, shy, shz}, back[3] = {-shx, -shy, -shz};
    float lo[3], hi[3];
    tile_box<NA>(tn, n_nb, lo, hi);
    n_cen = cull<NA>(src, n_cen, work, lo, hi, sh, cut2);
    if (n_cen == 0) return;
    tile_box<NA>(work, n_cen, lo, hi);
    n_nb = cull<NA>(tn, n_nb, tn, lo, hi, back, cut2);
    if (n_nb == 0) return;
    cen_tile = &work;
  }
  const Tile<NT, NF>& tc = *cen_tile;
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
    hsi[a] = (!UNIFORM && vi[a]) ? tc.f[kHs][e] : 0.f;
    tsei[a] = (!UNIFORM && vi[a]) ? tc.f[kTse][e] : 0.f;
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
    float nhs = (!UNIFORM && vj) ? tn.f[kHs][e] : 0.f;
    float ntse = (!UNIFORM && vj) ? tn.f[kTse][e] : 0.f;
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
        if (SKIP_SELF && a == b && step == 0) continue;
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

// All pairs of centre cell `cen` with neighbour cell `nb` for one warp,
// through its two tiles: both cells compacted (ballot ranks, slot order),
// then `pair_tiles` with the cull in place.
template <int NA, bool UNIFORM, bool ENERGY, bool REACT, bool COULOMB, bool EXCL, bool BOND, bool CULL = false>
__device__ __forceinline__ void cell_pair(const Fields& f, const Mol& mol, const Dsf& dsf, float cut2, long cen,
                                          long nb, long tag_cell, int c, int x, int nx, float shx, float shy,
                                          float shz, int mc, int mr, float* cen_acc, float* row,
                                          Tile<tile_entries<NA>(), (COULOMB || EXCL) ? 7 : 5>* tiles,
                                          float* tags, const PairConsts& k) {
  constexpr int NT = tile_entries<NA>(), NF = (COULOMB || EXCL) ? 7 : 5;
  auto& tc = tiles[0];
  auto& tn = REACT ? tiles[1] : tiles[0];  // the self pass pairs a cell with itself
  __syncwarp();  // the previous cell pair's reads of the tiles are done
  const int n_cen = compact<NA, NT, NF, UNIFORM>(f, mol, cen, c, tc);
  const int n_nb = REACT ? compact<NA, NT, NF, UNIFORM>(f, mol, nb, c, tn) : n_cen;
  __syncwarp();
  pair_tiles<NA, UNIFORM, ENERGY, REACT, COULOMB, EXCL, BOND, CULL>(mol, dsf, cut2, tag_cell, c, x, nx, shx, shy,
                                                                    shz, mc, mr, cen_acc, row, tc, n_cen, tc, tn,
                                                                    n_nb, tags, k);
}

// `pair_tiles` at C > 96: all pairs of a centre cell's chunks `cen` (n_cen
// live entries) with a neighbour cell's chunks `nbc` (n_nb), a centre
// chunk p at a time and, within it, a neighbour chunk q at a time, each
// chunk pair through the three-slot ring in that fixed order; its centre
// and reaction sums are added to the shared rows, so a slot's sums gather
// over its chunk pairs in that order.  With the cull (REACT), chunk q is
// first copied to `nw`, since the cull compacts its neighbours in place,
// and the centres kept go to `work`.  The self cell (!REACT, nbc = cen)
// skips the self pair in its diagonal chunk pairs only.
template <bool UNIFORM, bool ENERGY, bool REACT, bool COULOMB, bool EXCL, bool BOND, bool CULL, int NF>
__device__ __forceinline__ void pair_chunks(const Mol& mol, const Dsf& dsf, float cut2, long tag_cell, int c, int x,
                                            int nx, float shx, float shy, float shz, int mc, int mr, float* cen_acc,
                                            float* row, Tile<kChunk, NF>* cen, int n_cen, Tile<kChunk, NF>* nbc,
                                            int n_nb, Tile<kChunk, NF>& work, Tile<kChunk, NF>& nw, float* tags,
                                            const PairConsts& k) {
  const int lane = threadIdx.x & 31;
  for (int p = 0; p * kChunk < n_cen; ++p) {
    const int np = min(n_cen - p * kChunk, kChunk);
    for (int q = 0; q * kChunk < n_nb; ++q) {
      const int nq = min(n_nb - q * kChunk, kChunk);
      __syncwarp();  // the previous chunk pair's reads and sums are done
      if constexpr (!REACT) {
        if (p == q) {
          pair_tiles<3, UNIFORM, ENERGY, false, COULOMB, EXCL, BOND, false>(
              mol, dsf, cut2, tag_cell, c, x, nx, shx, shy, shz, mc, mr, cen_acc, row, cen[p], np, cen[p], cen[p],
              np, tags, k);
          continue;
        }
      }
      Tile<kChunk, NF>* tn = nbc + q;
      if constexpr (CULL && REACT) {
        for (int e = lane; e < nq; e += 32) {
#pragma unroll
          for (int v = 0; v < NF; ++v) nw.f[v][e] = nbc[q].f[v][e];
          nw.slot[e] = nbc[q].slot[e];
        }
        __syncwarp();
        tn = &nw;
      }
      pair_tiles<3, UNIFORM, ENERGY, REACT, COULOMB, EXCL, BOND, CULL, kChunk, NF, false>(
          mol, dsf, cut2, tag_cell, c, x, nx, shx, shy, shz, mc, mr, cen_acc, row, cen[p], np, work, *tn, nq, tags,
          k);
    }
  }
}

// `cell_pair` at C > 96: both cells compacted into chunks, the centre's at
// ch[0 … K), the neighbour's at ch[K … 2K) (K = ⌈C/96⌉; the self cell uses
// the first only), then `pair_chunks` with the work tiles ch[2K] and
// ch[2K + 1].
template <bool UNIFORM, bool ENERGY, bool REACT, bool COULOMB, bool EXCL, bool BOND, bool CULL = false, int NF>
__device__ __forceinline__ void cell_pair_chunks(const Fields& f, const Mol& mol, const Dsf& dsf, float cut2,
                                                 long cen, long nb, long tag_cell, int c, int x, int nx, float shx,
                                                 float shy, float shz, int mc, int mr, float* cen_acc, float* row,
                                                 Tile<kChunk, NF>* ch, float* tags, const PairConsts& k) {
  const int nch = chunks_of(c);
  Tile<kChunk, NF>* tc = ch;
  Tile<kChunk, NF>* tn = REACT ? ch + nch : ch;
  __syncwarp();  // the previous cell pair's reads of the tiles are done
  const int n_cen = compact_chunks<NF, UNIFORM>(f, mol, cen, c, tc);
  const int n_nb = REACT ? compact_chunks<NF, UNIFORM>(f, mol, nb, c, tn) : n_cen;
  __syncwarp();
  pair_chunks<UNIFORM, ENERGY, REACT, COULOMB, EXCL, BOND, CULL, NF>(mol, dsf, cut2, tag_cell, c, x, nx, shx, shy,
                                                                      shz, mc, mr, cen_acc, row, tc, n_cen, tn, n_nb,
                                                                      ch[2 * nch], ch[2 * nch + 1], tags, k);
}

// K5c: kOwnedWarps warps a block, each owning one (part, centre cell).
constexpr int kOwnedWarps = 4;
constexpr int kOwnedThreads = 32 * kOwnedWarps;
constexpr int kPhases = 14;  // the self cell and the 13 half-shell offsets
constexpr int kOffsets = 13;
// The half-shell offsets in phase order: dx = −1, 0, +1 of the row groups
// (0, 1), (1, −1), (1, 0), (1, 1), then dx = +1 of the own row.
__constant__ int kOffDz[kOffsets] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0};
__constant__ int kOffDy[kOffsets] = {1, 1, 1, -1, -1, -1, 0, 0, 0, 1, 1, 1, 0};
__constant__ int kOffDx[kOffsets] = {-1, 0, 1, -1, 0, 1, -1, 0, 1, -1, 0, 1, 1};

// Floats of one K5c warp's shared memory: its two tiles (7 fields and the
// slot), its staged tags, and its centre and reaction rows (n_r, C).  At
// C > 96 (`nch` = K chunks a cell) the two cells' chunks and the two work
// tiles of `pair_chunks` in place of the two tiles.
__host__ __device__ constexpr int owned_warp_floats(int nt, int ne, int neb, int nr, int c, int nch = 0) {
  return (nch ? 2 * nch + 2 : 2) * (7 + 1) * nt + tag_floats(nt, ne, neb) + 2 * nr * c;
}

// The periodic shift of a neighbour at global cell coordinate v.
__device__ __forceinline__ float ghost_shift(int v, int m, const float* __restrict__ box) {
  return v < 0 ? -*box : (v >= m ? *box : 0.f);
}

// The warp-owned pair pass (K5c; with GHOST, K5s-mol): warp phase · cells
// + cell evaluates that phase of its centre cell, cells = shards·mz·my·mx
// own cells; its centre sums go to centre slice `phase`, (n_r, cells·C) at
// the cell's own slots, and, for phase 1 + k, the reactions to reaction
// slice k, (n_r, n_g) at the neighbour's slots, every slot of the cells it
// writes.  One card: the neighbour index wraps and n_g = cells·C.  GHOST:
// centres and neighbours are read from the shards' ghost grids, the shift
// comes from the neighbour's global cell index, and a reaction slice spans
// the ghost grids, n_g = shards·(mz+2)(my+2)(mx+2)·C; the centre tags are
// per own slot.  NA = kChunked (C > 96): each cell pair by its chunk
// pairs (`cell_pair_chunks`), blockDim.x / 32 warps a block, as many as a
// block's shared memory holds, at most kOwnedWarps; shared memory then
// holds at most eight of its warps an SM, so it asks its registers for two
// blocks an SM (255 a thread) where the others ask for four (128).
template <int NA, bool ENERGY, bool COULOMB, bool EXCL, bool BOND, bool GHOST>
__global__ void __launch_bounds__(kOwnedThreads, NA == kChunked ? 2 : 4)
    streaming_owned_kernel(Fields f, Mol mol, float* __restrict__ slices, Ghost g, int shards, int m, int c,
                           const float* __restrict__ box_ptr, PairConsts k) {
  constexpr int NR = ENERGY ? 5 : 3;
  constexpr int NT = tile_entries<NA>();
  constexpr bool CHUNKED = NA == kChunked;
  using TileT = Tile<NT, 7>;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long cells = static_cast<long>(shards) * g.mz * g.my * g.mx;
  const long item = static_cast<long>(blockIdx.x) * (CHUNKED ? blockDim.x >> 5 : kOwnedWarps) + warp;
  if (item >= cells * kPhases) return;  // no block barrier follows
  const int nch = CHUNKED ? chunks_of(c) : 0;
  float* mine = smem + warp * owned_warp_floats(NT, mol.ne, mol.neb, NR, c, nch);
  TileT* tiles = reinterpret_cast<TileT*>(mine);
  float* tags = reinterpret_cast<float*>(tiles + (CHUNKED ? 2 * nch + 2 : 2));
  float* cen = tags + tag_floats(NT, mol.ne, mol.neb);  // (NR, C) centre sums
  float* react = cen + NR * c;                          // (NR, C) the offset's reactions
  const int ph = static_cast<int>(item / cells);
  const long cell = item - ph * cells;
  const long ns = cells * c;
  const long ng = GHOST ? static_cast<long>(shards) * (g.mz + 2) * (g.my + 2) * (g.mx + 2) * c : ns;
  Dsf dsf{};
  float cut2 = k.rc2;
  if (COULOMB) {
    dsf = emdee::load_dsf(mol);
    cut2 = fmaxf(cut2, dsf.rc2);
  }
  // The cell's local coordinates and, with GHOST, its ghost-grid index.
  const int x = static_cast<int>(cell % g.mx), y = static_cast<int>((cell / g.mx) % g.my);
  const int z = static_cast<int>((cell / (static_cast<long>(g.mx) * g.my)) % g.mz);
  const int sh = static_cast<int>(cell / (static_cast<long>(g.mx) * g.my * g.mz));
  const int gy = g.my + 2, gx = g.mx + 2;
  const long gbase = static_cast<long>(sh) * (g.mz + 2) * gy * gx;  // the shard's ghost cell 0
  const long home = GHOST ? gbase + (static_cast<long>(z + 1) * gy + y + 1) * gx + x + 1 : cell;
  for (int t = lane; t < NR * c; t += 32) cen[t] = react[t] = 0.f;  // cell_pair's first __syncwarp orders these
  if (ph == 0) {  // the self cell: every ordered pair, no reaction
    if constexpr (CHUNKED)
      cell_pair_chunks<false, ENERGY, false, COULOMB, EXCL, BOND>(f, mol, dsf, cut2, home, home, cell, c, 0, 0, 0.f,
                                                                   0.f, 0.f, c, c, cen, react, tiles, tags, k);
    else
      cell_pair<NA, false, ENERGY, false, COULOMB, EXCL, BOND, true>(f, mol, dsf, cut2, home, home, cell, c, 0, 0,
                                                                      0.f, 0.f, 0.f, c, c, cen, react, tiles, tags, k);
  } else {
    const int o = ph - 1;
    float shx, shy, shz;
    long nb;
    if (GHOST) {
      // Global cell coordinates of the centre, and the neighbour's shift from its own.
      const int cz = (g.bz + sh / (g.sx_n * g.sy_n)) * g.mz + z;
      const int cy = (g.by + (sh / g.sx_n) % g.sy_n) * g.my + y;
      const int cx = (g.bx + sh % g.sx_n) * g.mx + x;
      shx = ghost_shift(cx + kOffDx[o], m, box_ptr);
      shy = ghost_shift(cy + kOffDy[o], m, box_ptr);
      shz = ghost_shift(cz + kOffDz[o], m, box_ptr);
      nb = gbase + (static_cast<long>(z + 1 + kOffDz[o]) * gy + y + 1 + kOffDy[o]) * gx + x + 1 + kOffDx[o];
    } else {
      const int nx = wrap(x + kOffDx[o], m, box_ptr, shx);
      const int ny = wrap(y + kOffDy[o], m, box_ptr, shy);
      const int nz = wrap(z + kOffDz[o], m, box_ptr, shz);
      nb = (static_cast<long>(nz) * m + ny) * m + nx;
    }
    if constexpr (CHUNKED)
      cell_pair_chunks<false, ENERGY, true, COULOMB, EXCL, BOND, true>(f, mol, dsf, cut2, home, nb, cell, c, 0, 0,
                                                                       shx, shy, shz, c, c, cen, react, tiles, tags, k);
    else
      cell_pair<NA, false, ENERGY, true, COULOMB, EXCL, BOND, true>(f, mol, dsf, cut2, home, nb, cell, c, 0, 0, shx,
                                                                     shy, shz, c, c, cen, react, tiles, tags, k);
    __syncwarp();
    float* out = slices + static_cast<long>(kPhases) * NR * ns + static_cast<long>(o) * NR * ng + nb * c;
    for (int t = lane; t < NR * c; t += 32) __stcs(out + (t / c) * ng + t % c, react[t]);
  }
  __syncwarp();
  float* out = slices + static_cast<long>(ph) * NR * ns + cell * c;
  for (int t = lane; t < NR * c; t += 32) __stcs(out + (t / c) * ns + t % c, cen[t]);
}

// K5c's fold: f[s, k] (and e, w) = Σ slices[i][k][s] over i = 0 … n − 1 in
// that order: the 14 centre slices, then the 13 reaction slices.
template <int NR>
__global__ void owned_fold_kernel(float* __restrict__ f, float* __restrict__ e_out, float* __restrict__ w_out,
                                  const float* __restrict__ slices, int n_slices, long ns) {
  const long s = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= ns) return;
#pragma unroll
  for (int comp = 0; comp < NR; ++comp) {
    float v = __ldcs(slices + comp * ns + s);
    for (int i = 1; i < n_slices; ++i) v += __ldcs(slices + (static_cast<long>(i) * NR + comp) * ns + s);
    if (comp < 3)
      f[3 * s + comp] = v;
    else
      (comp == 3 ? e_out : w_out)[s] = v;
  }
}

// K5: kLjWarps warps a block, each owning a centre cell's phases; the
// blocks an SM its launch bounds ask the registers for (one centre slot a
// lane; two or three take more registers).
constexpr int kLjWarps = 4;
constexpr int kLjThreads = 32 * kLjWarps;
constexpr int kLjMinBlocks = 8;
// The cull; tools/ab_streaming.py alone builds K5 without it
// (-DEMDEE_K5_NO_CULL), whose sums are then the pencil kernel's bit for bit.
#ifdef EMDEE_K5_NO_CULL
constexpr bool kLjCull = false;
#else
constexpr bool kLjCull = true;
#endif

// Floats of one K5 warp's shared memory: its three tiles (NF fields and the
// slot: its cell compacted once, the centres a phase's cull keeps, the
// phase's neighbour cell) and its centre and reaction rows (n_r, C).  At
// C > 96 (`nch` = K chunks a cell) its cell's chunks and a phase's
// neighbour's, and the two work tiles of `pair_chunks`, in place of the
// three tiles.
__host__ __device__ constexpr int lj_warp_floats(int nt, int nf, int nr, int c, int nch = 0) {
  return (nch ? 2 * nch + 2 : 3) * (nf + 1) * nt + 2 * nr * c;
}

// The LJ pair pass (K5): warp w of the grid walks the 14 phases of centre
// cell w.  Its centre sums gather in its shared row over the phases and go
// to slice 0, (n_r, M³·C) at the cell's own slots; phase 1 + k's reactions
// go to slice 1 + k at the neighbour's slots, every slot of that cell.  The
// tiles hold x, y, z (and σ/2, 2√ε without UNIFORM).  NA = kChunked (C >
// 96): the cell is compacted once into chunks and each phase runs chunk
// pair by chunk pair (`pair_chunks`, the cull per chunk pair);
// blockDim.x / 32 warps a block, as many as a block's shared memory
// holds, at most kLjWarps.
template <int NA, bool UNIFORM, bool ENERGY>
__global__ void __launch_bounds__(kLjThreads, NA == 1 ? kLjMinBlocks : kLjMinBlocks / 2)
    streaming_lj_kernel(Fields f, float* __restrict__ slices, int m, int c, const float* __restrict__ box_ptr,
                        PairConsts k) {
  constexpr int NR = ENERGY ? 5 : 3;
  constexpr int NT = tile_entries<NA>();
  constexpr int NF = UNIFORM ? 3 : 5;
  constexpr bool CHUNKED = NA == kChunked;
  using TileT = Tile<NT, NF>;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long cells = static_cast<long>(m) * m * m;
  const long cell = static_cast<long>(blockIdx.x) * (CHUNKED ? blockDim.x >> 5 : kLjWarps) + warp;
  if (cell >= cells) return;  // no block barrier follows
  const int nch = CHUNKED ? chunks_of(c) : 0;
  TileT* tiles = reinterpret_cast<TileT*>(smem + warp * lj_warp_floats(NT, NF, NR, c, nch));
  TileT& own = tiles[0];   // the centre cell, compacted once (at C > 96 its K chunks)
  TileT& kept = tiles[1];  // the centres a phase's cull keeps
  TileT& nbt = CHUNKED ? tiles[nch] : tiles[2];  // the phase's neighbour cell (K chunks)
  float* cen = reinterpret_cast<float*>(tiles + (CHUNKED ? 2 * nch + 2 : 3));  // (NR, C) centre sums
  float* react = cen + NR * c;                                                  // (NR, C) a phase's reactions
  const long ns = cells * c;
  const int x = static_cast<int>(cell % m), y = static_cast<int>((cell / m) % m), z = static_cast<int>(cell / m / m);
  const Mol mol{};
  const Dsf dsf{};
  for (int t = lane; t < NR * c; t += 32) cen[t] = 0.f;
  int n_own;
  if constexpr (CHUNKED)
    n_own = compact_chunks<NF, UNIFORM>(f, mol, cell, c, tiles);
  else
    n_own = compact<NA, NT, NF, UNIFORM>(f, mol, cell, c, own);
  __syncwarp();
  // Phase 0, the self cell: every ordered pair, no reaction.
  if constexpr (CHUNKED)
    pair_chunks<UNIFORM, ENERGY, false, false, false, false, false, NF>(
        mol, dsf, k.rc2, cell, c, 0, 0, 0.f, 0.f, 0.f, c, c, cen, react, tiles, n_own, tiles, n_own,
        tiles[2 * nch], tiles[2 * nch + 1], nullptr, k);
  else
    pair_tiles<NA, UNIFORM, ENERGY, false, false, false, false, false>(
        mol, dsf, k.rc2, cell, c, 0, 0, 0.f, 0.f, 0.f, c, c, cen, react, own, n_own, own, own, n_own, nullptr, k);
  for (int o = 0; o < kOffsets; ++o) {  // phase 1 + o
    float shx, shy, shz;
    const int nx = wrap(x + kOffDx[o], m, box_ptr, shx);
    const int ny = wrap(y + kOffDy[o], m, box_ptr, shy);
    const int nz = wrap(z + kOffDz[o], m, box_ptr, shz);
    const long nb = (static_cast<long>(nz) * m + ny) * m + nx;
    for (int t = lane; t < NR * c; t += 32) react[t] = 0.f;
    __syncwarp();  // the previous phase's reads of the tiles are done
    int n_nb;
    if constexpr (CHUNKED)
      n_nb = compact_chunks<NF, UNIFORM>(f, mol, nb, c, &nbt);
    else
      n_nb = compact<NA, NT, NF, UNIFORM>(f, mol, nb, c, nbt);
    __syncwarp();
    if constexpr (CHUNKED)
      pair_chunks<UNIFORM, ENERGY, true, false, false, false, kLjCull, NF>(
          mol, dsf, k.rc2, cell, c, 0, 0, shx, shy, shz, c, c, cen, react, tiles, n_own, &nbt, n_nb,
          tiles[2 * nch], tiles[2 * nch + 1], nullptr, k);
    else
      pair_tiles<NA, UNIFORM, ENERGY, true, false, false, false, kLjCull>(
          mol, dsf, k.rc2, cell, c, 0, 0, shx, shy, shz, c, c, cen, react, own, n_own, kept, nbt, n_nb, nullptr, k);
    __syncwarp();
    float* out = slices + static_cast<long>(1 + o) * NR * ns + nb * c;
    for (int t = lane; t < NR * c; t += 32) __stcs(out + (t / c) * ns + t % c, react[t]);
  }
  __syncwarp();
  float* out = slices + cell * c;
  for (int t = lane; t < NR * c; t += 32) __stcs(out + (t / c) * ns + t % c, cen[t]);
}

// K5's fold: out_k[s] = the centre sums (slice 0); then the own row's
// reactions (offset 12, dx = +1); then each row group g = 0 … 3's three
// reaction slices, (r₃g + r₃g₊₁) + r₃g₊₂, added as one term — the
// association of the pencil kernel, which summed a pencil's phases in its
// shared centre row, added its own row on writing the outputs, and left a
// group's three dx phases summed in one reaction row for its fold.  Writes
// every slot; fx … through `fstride` (1: component arrays, 3: stacked).
template <int NR>
__global__ void lj_fold_kernel(float* fx, float* fy, float* fz, int fstride, float* e_out, float* w_out,
                               const float* __restrict__ slices, long ns) {
  const long s = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= ns) return;
  float* outs[5] = {fx, fy, fz, e_out, w_out};
  const long stride = static_cast<long>(NR) * ns;  // one slice
#pragma unroll
  for (int comp = 0; comp < NR; ++comp) {
    const float* at = slices + comp * ns + s;
    float v = __ldcs(at);
    const float* r = at + stride;  // offset 0's reactions
    v += __ldcs(r + (kOffsets - 1) * stride);
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      v += (__ldcs(r + 3 * g * stride) + __ldcs(r + (3 * g + 1) * stride)) + __ldcs(r + (3 * g + 2) * stride);
    outs[comp][comp < 3 ? s * fstride : s] = v;
  }
}

// The row groups in assembly order: slice 0 is the own row (0, 0), slices
// 1-4 the groups kGroupDz/kGroupDy.
__constant__ int kSliceDz[kGroups + 1] = {0, 0, 1, 1, 1};
__constant__ int kSliceDy[kGroups + 1] = {0, 1, -1, 0, 1};

// GHOST (K5s, LJ): one block per interior pencil (s, lz, ly) of the local
// shards, centres and neighbours read from the shards' ghost grids.  The
// centre sums go to out (NR, shards·mz·my·mx·C); each group's reaction row,
// (mx+2)·C wide, to its slice of groups (5, NR, pencils, (mx+2)·C) at the
// block's own pencil.  NA = kChunked (C > 96): each cell pair by its chunk
// pairs (`cell_pair_chunks`), blockDim.x / 32 warps a block, as many as a
// block's shared memory holds beside the rows, at most kWarps.
template <int NA, bool UNIFORM, bool ENERGY>
__global__ void __launch_bounds__(kThreads)
    streaming_ghost_kernel(Fields f, float* __restrict__ out, float* __restrict__ groups, Ghost g, int m, int c,
                           const float* __restrict__ box_ptr, PairConsts k) {
  constexpr int NR = ENERGY ? 5 : 3;
  constexpr int NT = tile_entries<NA>();
  constexpr bool CHUNKED = NA == kChunked;
  using TileT = Tile<NT, 5>;
  extern __shared__ float smem[];
  const int gy = g.my + 2, gx = g.mx + 2;
  const int mc = g.mx * c;  // a centre row
  const int mr = gx * c;    // a reaction row, x-ghost columns included
  float* cen_acc = smem;        // (NR, mx·C) centre sums of this pencil
  float* row = smem + NR * mc;  // (NR, (mx+2)·C) one group's reaction row
  const int warp = threadIdx.x >> 5;
  const int warps = CHUNKED ? blockDim.x >> 5 : kWarps;
  const int threads = CHUNKED ? blockDim.x : kThreads;
  // This warp's tiles: two, or at C > 96 its chunks and work tiles.
  TileT* tiles = reinterpret_cast<TileT*>(smem + NR * (mc + mr)) + (CHUNKED ? 2 * chunks_of(c) + 2 : 2) * warp;
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
  const Mol mol{};
  const Dsf dsf{};
  const float cut2 = k.rc2;

  for (int t = threadIdx.x; t < NR * (mc + mr); t += threads) smem[t] = 0.f;
  __syncthreads();

  // Self cell: every ordered pair, no reaction.
  for (int x = warp; x < g.mx; x += warps) {
    if constexpr (CHUNKED)
      cell_pair_chunks<UNIFORM, ENERGY, false, false, false, false>(f, mol, dsf, cut2, cen_row + x, cen_row + x,
                                                                     own_row + x, c, x, x, 0.f, 0.f, 0.f, mc, mr,
                                                                     cen_acc, row, tiles, nullptr, k);
    else
      cell_pair<NA, UNIFORM, ENERGY, false, false, false, false>(f, mol, dsf, cut2, cen_row + x, cen_row + x,
                                                                  own_row + x, c, x, x, 0.f, 0.f, 0.f, mc, mr,
                                                                  cen_acc, row, tiles, nullptr, k);
  }

  for (int gi = 0; gi <= kGroups; ++gi) {
    const bool own = gi == kGroups;  // the own row (0, 0): dx = +1 only
    const int dz = own ? 0 : kGroupDz[gi], dy = own ? 0 : kGroupDy[gi];
    const float shz = ghost_shift(cz + dz, m, box_ptr);
    const float shy = ghost_shift(cy + dy, m, box_ptr);
    const long nrow = gbase + (static_cast<long>(lz + 1 + dz) * gy + ly + 1 + dy) * gx;  // ghost column 0
    for (int dx = own ? 1 : -1; dx <= 1; ++dx) {
      for (int x = warp; x < g.mx; x += warps) {
        const float shx = ghost_shift(cx0 + x + dx, m, box_ptr);
        if constexpr (CHUNKED)
          cell_pair_chunks<UNIFORM, ENERGY, true, false, false, false>(f, mol, dsf, cut2, cen_row + x,
                                                                        nrow + x + 1 + dx, own_row + x, c, x,
                                                                        x + 1 + dx, shx, shy, shz, mc, mr, cen_acc,
                                                                        row, tiles, nullptr, k);
        else
          cell_pair<NA, UNIFORM, ENERGY, true, false, false, false>(f, mol, dsf, cut2, cen_row + x,
                                                                     nrow + x + 1 + dx, own_row + x, c, x,
                                                                     x + 1 + dx, shx, shy, shz, mc, mr, cen_acc,
                                                                     row, tiles, nullptr, k);
      }
      __syncthreads();
    }
    const int slice = own ? 0 : gi + 1;
    float* dst = groups + (static_cast<long>(slice) * NR * gridDim.x + pencil) * mr;
    for (int t = threadIdx.x; t < NR * mr; t += threads) {
      dst[static_cast<long>(t / mr) * gridDim.x * mr + t % mr] = row[t];
      row[t] = 0.f;
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < NR * mc; t += threads) out[(t / mc) * n_own + own_row * c + t % mc] = cen_acc[t];
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

// K5s-mol's assembly: one thread per slot t of the shards' ghost grids.
// An interior slot's sums are the 14 centre slices at its own slot, then
// the reaction slices k = 0 … 12 at t, in that order, to out (NR,
// shards·mz·my·mx·C); a ghost slot's reaction slices in the same order go
// to react (NR, shards, mz+2, my+2, mx+2, C), whose interior slots are
// zero.  Reaction slice k is read only where offset k's image of the own
// cells lies, the slots its warps wrote.
template <int NR>
__global__ void owned_ghost_assemble_kernel(float* __restrict__ out, const float* __restrict__ slices,
                                            float* __restrict__ react, Ghost g, int shards, int c) {
  const int gz = g.mz + 2, gy = g.my + 2, gx = g.mx + 2;
  const long ng = static_cast<long>(shards) * gz * gy * gx * c;
  const long ns = static_cast<long>(shards) * g.mz * g.my * g.mx * c;
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= ng) return;
  const int slot = t % c;
  long r = t / c;
  const int xg = r % gx;
  r /= gx;
  const int yg = r % gy;
  r /= gy;
  const int zg = r % gz;
  const int s = r / gz;
  const bool interior = zg >= 1 && zg <= g.mz && yg >= 1 && yg <= g.my && xg >= 1 && xg <= g.mx;
  const long own = ((static_cast<long>(s * g.mz + zg - 1) * g.my + yg - 1) * g.mx + xg - 1) * c + slot;
  const float* rs = slices + static_cast<long>(kPhases) * NR * ns;
#pragma unroll
  for (int comp = 0; comp < NR; ++comp) {
    float v = 0.f;
    if (interior) {
      v = __ldcs(slices + comp * ns + own);
      for (int i = 1; i < kPhases; ++i) v += __ldcs(slices + (static_cast<long>(i) * NR + comp) * ns + own);
    }
    for (int o = 0; o < kOffsets; ++o) {
      const int z = zg - 1 - kOffDz[o], y = yg - 1 - kOffDy[o], x = xg - 1 - kOffDx[o];
      if (z < 0 || z >= g.mz || y < 0 || y >= g.my || x < 0 || x >= g.mx) continue;
      v += __ldcs(rs + (static_cast<long>(o) * NR + comp) * ng + t);
    }
    if (interior) out[comp * ns + own] = v;
    react[comp * ng + t] = interior ? 0.f : v;
  }
}

int centre_slots(int c) { return c <= 32 ? 1 : (c <= 64 ? 2 : (c <= 96 ? 3 : kChunked)); }

// Warps a block at C > 96: as many as fit a block's shared memory at
// `per_warp` bytes each beside `fixed` bytes, at most `most`; 0 where not
// even one fits.
int fit_warps(size_t fixed, size_t per_warp, int most) {
  if (fixed + per_warp > static_cast<size_t>(kSmemBytes)) return 0;
  return static_cast<int>(std::min(static_cast<size_t>(most), (kSmemBytes - fixed) / per_warp));
}

// K5c: a block's shared memory, `*warps` × `owned_warp_floats` (kOwnedWarps
// up to C = 96; at C > 96 as many as fit, one warp's bytes where none does).
size_t owned_smem_bytes(int c, bool energy, int ne, int neb, int* warps) {
  const int slots = centre_slots(c);
  const int nt = slots <= 2 ? 64 : 96;
  const size_t per = sizeof(float) * static_cast<size_t>(owned_warp_floats(nt, ne, neb, energy ? 5 : 3, c,
                                                                           slots == kChunked ? chunks_of(c) : 0));
  *warps = slots == kChunked ? fit_warps(0, per, kOwnedWarps) : kOwnedWarps;
  return per * std::max(*warps, 1);
}

// GHOST (LJ): the centre sums and one (mx+2)·C reaction row, and the
// `*warps` warps' tiles (kWarps up to C = 96; at C > 96 the chunks and work
// tiles of as many warps as fit, one warp's where none does).
size_t ghost_smem_bytes(int mx, int c, bool energy, int* warps) {
  const size_t rows = sizeof(float) * (energy ? 5 : 3) * static_cast<size_t>(2 * mx + 2) * c;
  if (centre_slots(c) != kChunked) {
    *warps = kWarps;
    return rows + sizeof(float) * (5 + 1) * (centre_slots(c) <= 2 ? 64 : 96) * 2 * kWarps;
  }
  const size_t per = sizeof(float) * (5 + 1) * kChunk * static_cast<size_t>(2 * chunks_of(c) + 2);
  *warps = fit_warps(rows, per, kWarps);
  return rows + per * std::max(*warps, 1);
}

template <int NA, bool UNIFORM, bool ENERGY>
int launch_ghost(const Fields& f, float* out, float* groups, const Ghost& g, int blocks, int m, int c,
                 const float* box, const PairConsts& k, cudaStream_t stream) {
  int warps;
  const size_t smem = ghost_smem_bytes(g.mx, c, ENERGY, &warps);
  auto kernel = streaming_ghost_kernel<NA, UNIFORM, ENERGY>;
  static size_t smem_allowed = 48 * 1024;  // raised once per variant, not per launch
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  kernel<<<blocks, 32 * warps, smem, stream>>>(f, out, groups, g, m, c, box, k);
  return static_cast<int>(cudaGetLastError());
}

template <int NA>
int dispatch_ghost(const Fields& f, int uniform, int energy, float* out, float* groups, const Ghost& g, int blocks,
                   int m, int c, const float* box, const PairConsts& k, cudaStream_t s) {
  if (uniform && energy) return launch_ghost<NA, true, true>(f, out, groups, g, blocks, m, c, box, k, s);
  if (uniform) return launch_ghost<NA, true, false>(f, out, groups, g, blocks, m, c, box, k, s);
  if (energy) return launch_ghost<NA, false, true>(f, out, groups, g, blocks, m, c, box, k, s);
  return launch_ghost<NA, false, false>(f, out, groups, g, blocks, m, c, box, k, s);
}

// A warp-owned variant for one flag set (K2c's; GHOST: K5s-mol), with its
// own record of the dynamic shared memory raised so far (raised once per
// variant, not per launch).
template <int NA, bool ENERGY, bool COULOMB, bool EXCL, bool BOND, bool GHOST>
emdee::OwnedVariant owned_variant() {
  static_assert(sizeof(Tile<tile_entries<NA>(), 7>) == sizeof(float) * (7 + 1) * tile_entries<NA>(),
                "owned_smem_bytes counts the tiles as packed floats");
  static size_t smem_allowed = 48 * 1024;
  return {streaming_owned_kernel<NA, ENERGY, COULOMB, EXCL, BOND, GHOST>, &smem_allowed};
}

template <int NA, bool ENERGY, bool GHOST>
emdee::OwnedVariant owned_variant_e(int coulomb, int excl, int bond) {
  if constexpr (!GHOST) {  // the grid keeps its bonds as term rows
    if (coulomb && bond) return owned_variant<NA, ENERGY, true, true, true, false>();
    if (bond) return owned_variant<NA, ENERGY, false, true, true, false>();
  }
  if (coulomb && excl) return owned_variant<NA, ENERGY, true, true, false, GHOST>();
  if (coulomb) return owned_variant<NA, ENERGY, true, false, false, GHOST>();
  return owned_variant<NA, ENERGY, false, true, false, GHOST>();
}

template <bool ENERGY, bool GHOST>
emdee::OwnedVariant owned_variant_c(int c, int coulomb, int excl, int bond) {
  switch (centre_slots(c)) {
    case 1: return owned_variant_e<1, ENERGY, GHOST>(coulomb, excl, bond);
    case 2: return owned_variant_e<2, ENERGY, GHOST>(coulomb, excl, bond);
    case 3: return owned_variant_e<3, ENERGY, GHOST>(coulomb, excl, bond);
    default:
      if constexpr (GHOST)
        return emdee::k5s_mol_chunked_variant(ENERGY, coulomb, excl);
      else
        return ENERGY ? emdee::k5c_chunked_energy_variant(coulomb, excl, bond)
                      : emdee::k5c_chunked_force_variant(coulomb, excl, bond);
  }
}

#if EMDEE_IN_PART(0) || EMDEE_IN_PART(1) || EMDEE_IN_PART(2)
// A kernel's resources as the card reports them, launched with `threads`
// threads and `smem` dynamic shared bytes a block: out[0..3] = registers a
// thread, local (spill) bytes a thread, shared bytes a block, resident
// blocks an SM.
int kernel_attrs(const void* kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(smem + fa.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}
#endif

#if EMDEE_IN_PART(0)
// A K5 variant, its warps a block (`*warps`) and its dynamic shared memory
// (`*smem`), allowed once per variant, not per launch; refused where a
// block's shared memory holds no warp.
template <int NA, bool UNIFORM, bool ENERGY>
int lj_variant(int c, const void** kernel, size_t* smem, int* warps) {
  constexpr int NT = tile_entries<NA>(), NF = UNIFORM ? 3 : 5, NR = ENERGY ? 5 : 3;
  static_assert(sizeof(Tile<NT, NF>) == sizeof(float) * (NF + 1) * NT,
                "lj_warp_floats counts the tiles as packed floats");
  static size_t smem_allowed = 48 * 1024;
  *kernel = reinterpret_cast<const void*>(streaming_lj_kernel<NA, UNIFORM, ENERGY>);
  const size_t per =
      sizeof(float) * static_cast<size_t>(lj_warp_floats(NT, NF, NR, c, NA == kChunked ? chunks_of(c) : 0));
  *warps = NA == kChunked ? fit_warps(0, per, kLjWarps) : kLjWarps;
  *smem = per * std::max(*warps, 1);
  if (*warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (*smem > smem_allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = *smem;
  }
  return 0;
}

template <int NA>
int lj_variant_ue(int c, int uniform, int energy, const void** kernel, size_t* smem, int* warps) {
  if (uniform && energy) return lj_variant<NA, true, true>(c, kernel, smem, warps);
  if (uniform) return lj_variant<NA, true, false>(c, kernel, smem, warps);
  if (energy) return lj_variant<NA, false, true>(c, kernel, smem, warps);
  return lj_variant<NA, false, false>(c, kernel, smem, warps);
}

// The K5 variant for C and these flags (C ≤ 1024; above 96 the chunked
// variants), its warps a block and its shared memory allowed.
int lj_kernel(int c, int uniform, int energy, const void** kernel, size_t* smem, int* warps) {
  if (c < 1 || c > kMaxCapacity) return static_cast<int>(cudaErrorInvalidValue);
  switch (centre_slots(c)) {
    case 1: return lj_variant_ue<1>(c, uniform, energy, kernel, smem, warps);
    case 2: return lj_variant_ue<2>(c, uniform, energy, kernel, smem, warps);
    case 3: return lj_variant_ue<3>(c, uniform, energy, kernel, smem, warps);
    default: return lj_variant_ue<kChunked>(c, uniform, energy, kernel, smem, warps);
  }
}
#endif

#if EMDEE_IN_PART(1) || EMDEE_IN_PART(2)
// The K5c (GHOST: K5s-mol, no bond tags) variant for these flags, refused
// as the launch entries refuse it (but for the geometry), its dynamic
// shared memory (`*smem`) allowed.
int owned_kernel(int c, int ne, int neb, int coulomb, int excl, int bond, int energy, bool ghost,
                 emdee::OwnedKernel* kernel, size_t* smem, int* warps) {
  if (!excl) ne = 0;
  if (!bond) neb = 0;
  *smem = owned_smem_bytes(c, energy, ne, neb, warps);
  if (c < 1 || c > kMaxCapacity || *smem > static_cast<size_t>(kSmemBytes) || (!coulomb && !excl) || (bond && !excl) || (ghost && bond) ||
      (excl && (ne < 1 || ne > kMaxTags)) || (bond && (neb < 1 || neb > ne)))
    return static_cast<int>(cudaErrorInvalidValue);
  const emdee::OwnedVariant v =
      ghost ? (energy ? emdee::k5s_mol_energy_variant(c, coulomb, excl) : emdee::k5s_mol_force_variant(c, coulomb, excl))
            : (energy ? emdee::k5c_energy_variant(c, coulomb, excl, bond)
                      : emdee::k5c_force_variant(c, coulomb, excl, bond));
  if (*smem > *v.smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(v.kernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    *v.smem_allowed = *smem;
  }
  *kernel = v.kernel;
  return 0;
}

// A warp-owned variant's resources as the card reports them (`kernel_attrs`).
int owned_attrs(emdee::OwnedKernel kernel, size_t smem, int warps, int* out) {
  return kernel_attrs(reinterpret_cast<const void*>(kernel), 32 * warps, smem, out);
}
#endif

}  // namespace

#if EMDEE_IN_PART(1)
emdee::OwnedVariant emdee::k5c_force_variant(int c, int coulomb, int excl, int bond) {
  return owned_variant_c<false, false>(c, coulomb, excl, bond);
}
#endif

#if EMDEE_IN_PART(3)
emdee::OwnedVariant emdee::k5c_energy_variant(int c, int coulomb, int excl, int bond) {
  return owned_variant_c<true, false>(c, coulomb, excl, bond);
}
#endif

#if EMDEE_IN_PART(2)
emdee::OwnedVariant emdee::k5s_mol_force_variant(int c, int coulomb, int excl) {
  return owned_variant_c<false, true>(c, coulomb, excl, 0);
}
#endif

#if EMDEE_IN_PART(4)
emdee::OwnedVariant emdee::k5s_mol_energy_variant(int c, int coulomb, int excl) {
  return owned_variant_c<true, true>(c, coulomb, excl, 0);
}
#endif

#if EMDEE_IN_PART(5)
emdee::OwnedVariant emdee::k5c_chunked_force_variant(int coulomb, int excl, int bond) {
  return owned_variant_e<kChunked, false, false>(coulomb, excl, bond);
}
#endif

#if EMDEE_IN_PART(6)
emdee::OwnedVariant emdee::k5c_chunked_energy_variant(int coulomb, int excl, int bond) {
  return owned_variant_e<kChunked, true, false>(coulomb, excl, bond);
}
#endif

#if EMDEE_IN_PART(7)
emdee::OwnedVariant emdee::k5s_mol_chunked_variant(int energy, int coulomb, int excl) {
  return energy ? owned_variant_e<kChunked, true, true>(coulomb, excl, 0)
                : owned_variant_e<kChunked, false, true>(coulomb, excl, 0);
}
#endif

#if EMDEE_IN_PART(0)
// The LJ pair pass (K5): positions px, py, pz read at stride `pstride` (1:
// component arrays, 3: the stacked (M³, C, 3) state), per-atom (σ/2, 2√ε)
// unless `uniform`, the valid mask.  Writes the centre sums and the
// reactions to slices (14, 3 or 5, M³·C), every slot; `emdee_streaming_fold`
// adds them up.
extern "C" int emdee_streaming_forces(
    const float* px, const float* py, const float* pz, int pstride, const float* hs, const float* tse,
    const uint8_t* valid, float* slices, int m, int c, const float* box, float rc2, float rs2,
    float invd2, float a_m, float pa1, float pa2, float pb1, float pb2, float sig2_u, float eps4_u, int uniform,
    int energy, void* stream) {
  if (m < 3) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel;
  size_t smem;
  int warps;
  const int err = lj_kernel(c, uniform, energy, &kernel, &smem, &warps);
  if (err) return err;
  PairConsts k{rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, sig2_u, eps4_u};
  Fields fl{px, py, pz, pstride, hs, tse, valid};
  const long cells = static_cast<long>(m) * m * m;
  const unsigned blocks = static_cast<unsigned>((cells + warps - 1) / warps);
  void* args[] = {&fl, &slices, &m, &c, &box, &k};
  return static_cast<int>(
      cudaLaunchKernel(kernel, dim3(blocks), dim3(32 * warps), args, smem, static_cast<cudaStream_t>(stream)));
}

// K5's fold: writes fx, fy, fz (through `fstride`) [, e, w] at every slot
// from the slices of `emdee_streaming_forces`.
extern "C" int emdee_streaming_fold(float* fx, float* fy, float* fz, int fstride, float* e, float* w,
                                    const float* slices, long ns, int energy, void* stream) {
  if (ns < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long blocks = (ns + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (energy)
    lj_fold_kernel<5><<<blocks, threads, 0, s>>>(fx, fy, fz, fstride, e, w, slices, ns);
  else
    lj_fold_kernel<3><<<blocks, threads, 0, s>>>(fx, fy, fz, fstride, e, w, slices, ns);
  return static_cast<int>(cudaGetLastError());
}

// The K5 variant for C and these flags, as the card reports it: out[0..3] =
// registers a thread, local (spill) bytes a thread, shared bytes a block,
// resident blocks an SM.  Launches nothing.
extern "C" int emdee_streaming_attrs(int c, int uniform, int energy, int* out) {
  const void* kernel;
  size_t smem;
  int warps;
  const int err = lj_kernel(c, uniform, energy, &kernel, &smem, &warps);
  if (err) return err;
  return kernel_attrs(kernel, 32 * warps, smem, out);
}
#endif
#if EMDEE_IN_PART(1)
// The molecular pair pass (K5c): stacked positions (M³, C, 3), per-atom
// (σ/2, 2√ε), q (M³, C) charges and the DSF constants' device pointers
// with `coulomb`; aid (M³, C) int32 atom ids and the tags (M³, C, ne) with
// `excl` (mcs only with `coulomb`); the bond weights (M³, C, neb) with
// `bond` (kr02 only with `energy`).  Writes the centre sums and the
// reactions to slices (27, 3 or 5, M³·C), every slot, one warp a phase of
// a centre cell; `emdee_streaming_fold_mol` adds them up.
extern "C" int emdee_streaming_forces_mol(
    const float* pos, const float* hs, const float* tse, const uint8_t* valid, const float* q,
    const int* aid, const float* ids, const float* mlj, const float* mcs, const float* kb,
    const float* kr0, const float* kr02, int ne, int neb, const float* alpha, const float* rc,
    const float* rc2_c, const float* e_shift, const float* f_shift, const float* kc, float* slices,
    int m, int c, const float* box, float rc2, float rs2, float invd2, float a_m, float pa1, float pa2, float pb1,
    float pb2, int coulomb, int excl, int bond, int energy, void* stream) {
  if (m < 3) return static_cast<int>(cudaErrorInvalidValue);
  emdee::OwnedKernel kernel;
  size_t smem;
  int wpb;
  const int err = owned_kernel(c, ne, neb, coulomb, excl, bond, energy, false, &kernel, &smem, &wpb);
  if (err) return err;
  if (!excl) ne = 0;
  if (!bond) neb = 0;
  PairConsts k{rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, 0.f, 0.f};
  Fields fl{pos, pos + 1, pos + 2, 3, hs, tse, valid};
  Mol mol{q, aid, ids, mlj, mcs, kb, kr0, kr02, ne, neb, alpha, rc, rc2_c, e_shift, f_shift, kc};
  Ghost g{m, m, m, 1, 1, 0, 0, 0};
  int shards = 1;
  const long warps = static_cast<long>(m) * m * m * kPhases;
  const unsigned blocks = static_cast<unsigned>((warps + wpb - 1) / wpb);
  void* args[] = {&fl, &mol, &slices, &g, &shards, &m, &c, &box, &k};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                           dim3(32 * wpb), args, smem, static_cast<cudaStream_t>(stream)));
}

// The K5c variant these flags select, as the card reports it: out[0..3] =
// registers a thread, local (spill) bytes a thread, shared bytes a block,
// resident blocks an SM.  Launches nothing.
extern "C" int emdee_streaming_mol_attrs(int c, int ne, int neb, int coulomb, int excl, int bond, int energy,
                                         int* out) {
  emdee::OwnedKernel kernel;
  size_t smem;
  int wpb;
  int err = owned_kernel(c, ne, neb, coulomb, excl, bond, energy, false, &kernel, &smem, &wpb);
  if (err) return err;
  return owned_attrs(kernel, smem, wpb, out);
}

// K5c's fold: f (M³·C, 3) [, e, w (M³·C)] = the sum of the n_slices
// slices, in order.
extern "C" int emdee_streaming_fold_mol(float* f, float* e, float* w, const float* slices, int n_slices, long ns,
                                        int energy, void* stream) {
  if (n_slices < 1 || ns < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long blocks = (ns + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (energy)
    owned_fold_kernel<5><<<blocks, threads, 0, s>>>(f, e, w, slices, n_slices, ns);
  else
    owned_fold_kernel<3><<<blocks, threads, 0, s>>>(f, e, w, slices, n_slices, ns);
  return static_cast<int>(cudaGetLastError());
}
#endif


#if EMDEE_IN_PART(2)
// The GHOST pair pass (K5s, LJ): the ghost grids of `shards` local shards,
// px … tse each (shards, mz+2, my+2, mx+2, C) float32 with NaN positions in
// empty slots (hs, tse unused with uniform parameters).  Writes the centre
// sums to out (3 or 5, shards·mz·my·mx·C) and the reaction rows to groups
// (5, 3 or 5, shards·mz·my, (mx+2)·C); `emdee_streaming_ghost_assemble`
// adds them up.
extern "C" int emdee_streaming_ghost(
    const float* px, const float* py, const float* pz, const float* hs, const float* tse, float* out, float* groups,
    int mz, int my, int mx, int shards, int sy_n, int sx_n, int bz, int by, int bx, int m, int c, const float* box,
    float rc2, float rs2, float invd2, float a_m, float pa1, float pa2, float pb1, float pb2, float sig2_u,
    float eps4_u, int uniform, int energy, void* stream) {
  int warps;
  const size_t smem = ghost_smem_bytes(mx, c, energy, &warps);
  if (m < 3 || c < 1 || c > kMaxCapacity || mz < 1 || my < 1 || mx < 1 || shards < 1 || sy_n < 1 || sx_n < 1 ||
      shards % (sy_n * sx_n) != 0 || smem > static_cast<size_t>(kSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const PairConsts k{rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, sig2_u, eps4_u};
  const Fields f{px, py, pz, 1, hs, tse, nullptr};
  const Ghost g{mz, my, mx, sy_n, sx_n, bz, by, bx};
  const int blocks = shards * mz * my;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (centre_slots(c)) {
    case 1: return dispatch_ghost<1>(f, uniform, energy, out, groups, g, blocks, m, c, box, k, s);
    case 2: return dispatch_ghost<2>(f, uniform, energy, out, groups, g, blocks, m, c, box, k, s);
    case 3: return dispatch_ghost<3>(f, uniform, energy, out, groups, g, blocks, m, c, box, k, s);
    default: return dispatch_ghost<kChunked>(f, uniform, energy, out, groups, g, blocks, m, c, box, k, s);
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

// The GHOST molecular pair pass (K5s-mol): the ghost grids as in
// `emdee_streaming_ghost` with per-atom parameters, plus the charges q
// with `coulomb` and the int32 atom ids aid (−2 on empty slots) with
// `excl`, in the same layout; the centre tags ids, mlj, mcs (shards, mz,
// my, mx, C, ne) with `excl` (mcs only with `coulomb`); the DSF constants'
// device pointers with `coulomb`.  Writes the 14 centre slices (3 or 5,
// shards·mz·my·mx·C) and then the 13 reaction slices (3 or 5,
// shards·(mz+2)(my+2)(mx+2)·C) to `slices`, one warp a phase of an own
// cell; `emdee_streaming_ghost_assemble_mol` adds them up.
extern "C" int emdee_streaming_ghost_mol(
    const float* px, const float* py, const float* pz, const float* hs, const float* tse, const float* q,
    const int* aid, const float* ids, const float* mlj, const float* mcs, int ne, const float* alpha,
    const float* rc, const float* rc2_c, const float* e_shift, const float* f_shift, const float* kc, float* slices,
    int mz, int my, int mx, int shards, int sy_n, int sx_n, int bz, int by, int bx, int m, int c, const float* box,
    float rc2, float rs2, float invd2, float a_m, float pa1, float pa2, float pb1, float pb2, int coulomb, int excl,
    int energy, void* stream) {
  if (m < 3 || mz < 1 || my < 1 || mx < 1 || shards < 1 || sy_n < 1 || sx_n < 1 || shards % (sy_n * sx_n) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  emdee::OwnedKernel kernel;
  size_t smem;
  int wpb;
  const int err = owned_kernel(c, ne, 0, coulomb, excl, 0, energy, true, &kernel, &smem, &wpb);
  if (err) return err;
  if (!excl) ne = 0;
  PairConsts k{rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, 0.f, 0.f};
  Fields fl{px, py, pz, 1, hs, tse, nullptr};
  Mol mol{q, aid, ids, mlj, mcs, nullptr, nullptr, nullptr, ne, 0, alpha, rc, rc2_c, e_shift, f_shift, kc};
  Ghost g{mz, my, mx, sy_n, sx_n, bz, by, bx};
  const long warps = static_cast<long>(shards) * mz * my * mx * kPhases;
  const unsigned blocks = static_cast<unsigned>((warps + wpb - 1) / wpb);
  void* args[] = {&fl, &mol, &slices, &g, &shards, &m, &c, &box, &k};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                           dim3(32 * wpb), args, smem, static_cast<cudaStream_t>(stream)));
}

// The K5s-mol variant these flags select, as the card reports it (as
// `emdee_streaming_mol_attrs`).  Launches nothing.
extern "C" int emdee_streaming_ghost_mol_attrs(int c, int ne, int coulomb, int excl, int energy, int* out) {
  emdee::OwnedKernel kernel;
  size_t smem;
  int wpb;
  const int err = owned_kernel(c, ne, 0, coulomb, excl, 0, energy, true, &kernel, &smem, &wpb);
  if (err) return err;
  return owned_attrs(kernel, smem, wpb, out);
}

// K5s-mol's assembly: the centre sums of the own slots to out (3 or 5,
// shards·mz·my·mx·C) and the ghost slots' reactions to react (3 or 5,
// shards, mz+2, my+2, mx+2, C), from the slices of
// `emdee_streaming_ghost_mol`.
extern "C" int emdee_streaming_ghost_assemble_mol(float* out, const float* slices, float* react, int mz, int my,
                                                  int mx, int shards, int c, int energy, void* stream) {
  if (mz < 1 || my < 1 || mx < 1 || shards < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Ghost g{mz, my, mx, 1, 1, 0, 0, 0};
  const long n_ghost = static_cast<long>(shards) * (mz + 2) * (my + 2) * (mx + 2) * c;
  const int threads = 256;
  const long blocks = (n_ghost + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (energy)
    owned_ghost_assemble_kernel<5><<<blocks, threads, 0, s>>>(out, slices, react, g, shards, c);
  else
    owned_ghost_assemble_kernel<3><<<blocks, threads, 0, s>>>(out, slices, react, g, shards, c);
  return static_cast<int>(cudaGetLastError());
}
#endif
