"""3-D grid-sharded dense-cell engine — counterpart of
emdee_tpu/distributed/grid_sharded.py (NVE, CSVR and Langevin NVT and
Berendsen NPT, with or without the molecular terms: DSF Coulomb, exclusion
tags, bonded terms and the leftover exclusion pairs; plain and spill
configs).

The (M, M, M, C) slot grid is cut into an (nz, ny, nx) mesh of shards of
(mz, my, mx) cells (`distributed/mesh.py`); a state's per-slot leaves are
(sz, sy, sx, mz, my, mx, C, …), the shards this process holds (all of them
on a `LocalMesh`, its own on a `DistMesh`).  Every exchange between shards
goes through the mesh's `shift` (the reference's `ppermute`):

- **Force pass**: each shard's (mz+2, my+2, mx+2, C) ghost grid is built by
  successive z, y and x exchanges of one boundary layer, so that edges and
  corners arrive in two hops (`_ghost3`).  Two kernel families, as the
  reference picks between its resident and streaming kernels
  (`resolve_grid_backend`):
  - the resident family: the force kernel's GHOST mode
    (`cell_kernel.ghost_forces`, K2-G) walks the full 27-cell shell from the
    ghost grid, taking each periodic shift from the neighbour's global cell
    index on raw coordinates: the forces of any decomposition equal the
    one-card kernel's bit for bit.  The full shell needs no reaction rows,
    no fold and no second exchange;
  - the streaming family: the streaming kernel's GHOST mode
    (`streaming_kernel.streaming_ghost_forces`, K5s) walks the half shell,
    writes each shard's reactions on ghost slots to a reaction ghost grid,
    and `_fold3` returns its x, then y, then z layers to the shards that own
    them (the reference's second exchange).  The fold adds boundary
    reactions in another order than one card does, so decompositions agree
    to roundoff, not bit for bit.
  With the molecular terms the ghost grids also carry charges and atom ids,
  and the kernels' molecular branches (K2c-G, K5s-mol) match each own
  slot's tags; bonded terms and leftover pairs are rows that each shard
  evaluates for its own atoms (`_grid_terms`), so they need no reverse
  exchange either.
- **Rebin**: the shift rebin's three passes (z, y, x), each over the
  shards' own rows and the two halo planes that one exchange along the pass
  axis brings, with each row's global coordinate
  (`rebin_window_kernel.rebin_halo_pass`, K6); a spill config's passes
  add boundary spill and hold-backs (K7-G, `spill_grid_rebin`): where
  every shard lies in this process, all three passes in one launch that
  reads a row's neighbours across a shard face in place; across ranks, a
  pass a launch over two halo layers each side (`spill_halo_pass`).  Atom
  migration between shards is that exchange, or that read in place;
  charges ride it.
- **Reductions**: energies, the kinetic energy of CSVR, the pressure of
  the barostat and the sticky flag are reduced over the shards (`psum`,
  `pmax`), and, with term rows, the atom → global slot map once a rebin
  (an int32 `psum`).

Nothing in a rollout waits for the device; the flag stays there until the
caller reads it.  The box is the state's 0-d device tensor (a dynamic NPT
box) or config.box.  A (1, 1, 1) mesh is the one-card engine's geometry;
its leapfrog here, like the reference's grid engine, carries no Kahan
compensation.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from emdee_tpu_torch.distributed.mesh import GridMesh, validate_grid_config
from emdee_tpu_torch.neighbors.cell_dense import (
    STREAMING_THRESHOLD_BYTES,
    BerendsenBarostatConfig,
    CellDenseConfig,
    CellDenseState,
    CSVRConfig,
    LangevinConfig,
    _box,
    _box_of,
    _f32,
    _spill_params,
    _stale,
    gather_dense_atoms,
)
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel

def _grid_leaves(state: CellDenseState, config: CellDenseConfig) -> CellDenseState:
    """(M³, C, …) leaves → (M, M, M, C, …) grid layout (axes z, y, x)."""
    m = config.cells_per_dim

    def to_grid(a):
        if isinstance(a, torch.Tensor) and a.dim() >= 2 and a.shape[0] == config.num_cells:
            return a.reshape((m, m, m) + tuple(a.shape[1:]))
        return a

    return CellDenseState(*(to_grid(a) for a in state))


def _flat_leaves(state: CellDenseState, config: CellDenseConfig) -> CellDenseState:
    """(M, M, M, C, …) grid leaves → (M³, C, …)."""
    m = config.cells_per_dim

    def to_flat(a):
        if isinstance(a, torch.Tensor) and a.dim() >= 4 and tuple(a.shape[:3]) == (m, m, m):
            return a.reshape((config.num_cells,) + tuple(a.shape[3:]))
        return a

    return CellDenseState(*(to_flat(a) for a in state))


def _is_slot_leaf(a) -> bool:
    return isinstance(a, torch.Tensor) and a.dim() >= 3


def distribute_grid(state: CellDenseState, config: CellDenseConfig, mesh: GridMesh) -> CellDenseState:
    """One-card CellDenseState → the grid-sharded state of this process's
    shards on the mesh's device: per-slot leaves (sz, sy, sx, mz, my, mx,
    C, …), scalars replicated."""
    locs = validate_grid_config(config, mesh)
    nz, ny, nx = mesh.shape
    lo, n = mesh.base, mesh.local_shape

    def shard(a):
        if not isinstance(a, torch.Tensor):
            return a
        if not _is_slot_leaf(a):
            return a.to(mesh.device)
        rest = tuple(a.shape[3:])
        blocks = a.reshape((nz, locs[0], ny, locs[1], nx, locs[2]) + rest)
        blocks = blocks.permute((0, 2, 4, 1, 3, 5) + tuple(range(6, 6 + len(rest))))
        own = blocks[lo[0] : lo[0] + n[0], lo[1] : lo[1] + n[1], lo[2] : lo[2] + n[2]]
        return own.contiguous().to(mesh.device)

    return CellDenseState(*(shard(a) for a in _grid_leaves(state, config)))


def gather_grid_state(state: CellDenseState, config: CellDenseConfig, mesh: GridMesh) -> CellDenseState:
    """Grid-sharded state → the one-card CellDenseState ((M³, C, …)
    leaves) on the mesh's device; on a `DistMesh` every rank takes part
    (an all-gather) and gets the whole state."""
    m = config.cells_per_dim
    nz, ny, nx = mesh.shape

    def unshard(a):
        if not _is_slot_leaf(a):
            return a
        a = mesh.all_gather(a.reshape((-1,) + tuple(a.shape[3:]))).reshape((nz, ny, nx) + tuple(a.shape[3:]))
        rest = tuple(a.shape[6:])
        grid = a.permute((0, 3, 1, 4, 2, 5) + tuple(range(6, 6 + len(rest))))
        return grid.reshape((m, m, m) + rest)

    return _flat_leaves(CellDenseState(*(unshard(a) for a in state)), config)


def gather_grid_atoms(state: CellDenseState, config: CellDenseConfig, num_atoms: int, mesh: GridMesh):
    """Grid-sharded state → (N, 3) positions and velocities by atom id
    (numpy, host)."""
    return gather_dense_atoms(gather_grid_state(state, config, mesh), num_atoms)


def reconfigure_grid_state(state: CellDenseState, config: CellDenseConfig, mesh: GridMesh):
    """NPT geometry re-derive for a grid-sharded run (the reference's
    `reconfigure_grid_state`): when the dynamic box has drifted past the
    static geometry's guard (the sticky flag trips at box < M·(rc + skin)),
    gather the state (on a `DistMesh` every rank takes part), re-derive the
    cell grid at the current box with `reconfigure_dense_state` (M rounded
    down to a multiple of every mesh axis, at least 2·max(mesh) cells), and
    distribute it over the same mesh.  Returns (sharded state', config');
    build new closures from config'."""
    from emdee_tpu_torch.neighbors.cell_dense import reconfigure_dense_state

    flat = gather_grid_state(state, config, mesh)
    new_flat, new_config = reconfigure_dense_state(
        flat, config, cells_multiple_of=math.lcm(*mesh.shape), min_cells_per_dim=2 * max(mesh.shape),
    )
    validate_grid_config(new_config, mesh)
    return distribute_grid(new_flat, new_config, mesh), new_config


def _ghost3(g: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """(F, sz, sy, sx, mz, my, mx, C) → (F, sz, sy, sx, mz+2, my+2, mx+2, C):
    the z, then y, then x boundary layers of the neighbour shards, so that
    edges and corners arrive in two hops."""
    for axis in range(3):
        dim, n = 4 + axis, g.shape[4 + axis]
        lo = mesh.shift(g.narrow(dim, n - 1, 1), axis, -1)  # the −axis neighbour's top layer
        hi = mesh.shift(g.narrow(dim, 0, 1), axis, +1)
        g = torch.cat([lo, g, hi], dim=dim)
    return g


def _fold3(r: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """(F, sz, sy, sx, mz+2, my+2, mx+2, C) reaction ghost grids → a view
    (F, sz, sy, sx, mz, my, mx, C) of their interior: the x, then y, then z
    ghost layers sent back to the shards that own them (`mesh.shift`
    opposite to `_ghost3`'s) and added to their boundary layers in place,
    so that edge and corner reactions arrive in two or three hops — the
    reference's `_fold3`.  `r` is the caller's scratch: it is overwritten."""
    for axis in (2, 1, 0):
        dim, n = 4 + axis, r.shape[4 + axis]
        lo = mesh.shift(r.narrow(dim, 0, 1), axis, +1)  # the +axis neighbour's −1 layer: my top layer
        hi = mesh.shift(r.narrow(dim, n - 1, 1), axis, -1)  # the −axis neighbour's +1 layer: my bottom layer
        r = r.narrow(dim, 1, n - 2)
        r.narrow(dim, 0, 1).add_(hi)
        r.narrow(dim, n - 3, 1).add_(lo)
    return r


def _grid_terms(config: CellDenseConfig, mesh: GridMesh, model: LennardJonesModel, coulomb, bonded,
                excl_leftover, atom_params, atom_charges):
    """The bonded terms and the exclusion pairs beyond the tag band on the
    grid: (bind, forces, energy), or None when there are none.

    Owner computes, without a reverse exchange (the GHOST force pass has
    none): every shard evaluates each term that has an atom it owns, from
    its (mz+2, my+2, mx+2, C) extended grid — a term spans ≪ one cell, so
    all its atoms lie within ±1 cell of any one of them — and keeps the rows
    of its own atoms only, added in global term order by the fixed-order add
    of `core/scatter.py`.  A term across a shard face is evaluated on each
    side; in return each atom's rows arrive in the same order, with the
    same values, on any decomposition, so every decomposition gives the same
    forces bit for bit.  Term energies count on the shard that owns the
    term's owner atom (bonds and leftover pairs: the first, angles and
    torsions: the second), as the reference counts them (grid_sharded.py
    `_ext_of` :420-452, `_term_energy_virial` :551-591).

    bind(aid, valid) → (binding, bad), once per rebin: one int `psum` of
    the (N+1,) atom → global slot map, then each table's extended-grid
    indices, ownership masks and the fixed-order plan of its rows; `bad` is
    True when an atom of a term is more than one cell from an owned atom of
    the same term (a broken topology), OR'd into the sticky flag.
    forces(pos_ext, binding, box) → (shards·mz·my·mx·C, 3) term forces of
    the own slots; energy(pos_ext, binding, box) → (pe, vir) of this
    process's shards.  pos_ext: (shards·(mz+2)(my+2)(mx+2)·C + 1, 3), the
    ghost positions with a zero pad row."""
    from emdee_tpu_torch.core.scatter import add_plan, fixed_add
    from emdee_tpu_torch.neighbors.cell_dense import _numpy
    from emdee_tpu_torch.neighbors.cell_dense_molecular import _FAMILIES, _row_targets
    from emdee_tpu_torch.potentials.bonded import BondedSystem, bonded_force_rows
    from emdee_tpu_torch.potentials.coulomb import coulomb_interaction
    from emdee_tpu_torch.potentials.lennard_jones import pair_interaction

    tables = [] if bonded is None else [(f, getattr(bonded, f)) for f in _FAMILIES if getattr(bonded, f) is not None]
    has_leftover = excl_leftover is not None and len(excl_leftover[0]) > 0
    if not tables and not has_leftover:
        return None
    dev = mesh.device
    m, c, n_at = config.cells_per_dim, config.capacity, config.num_atoms
    mz, my, mx = validate_grid_config(config, mesh)
    lead = mesh.local_shape
    shards = math.prod(lead)
    n_ext = (mz + 2) * (my + 2) * (mx + 2) * c
    n_own = mz * my * mx * c
    loc = torch.tensor([mz, my, mx], device=dev)
    # The local shards' global shard coordinates (shards, 3), z-major.
    sc = torch.stack(torch.meshgrid(*(mesh.axis_index(a) for a in range(3)), indexing="ij"), -1).reshape(-1, 3)
    # The global slot id (cell·C + slot) of every local slot, in the state's layout.
    gcell = [(mesh.axis_index(a)[:, None] * (mz, my, mx)[a] + torch.arange((mz, my, mx)[a], device=dev)) for a in range(3)]
    gz = gcell[0].reshape(lead[0], 1, 1, mz, 1, 1, 1)
    gy = gcell[1].reshape(1, lead[1], 1, 1, my, 1, 1)
    gx = gcell[2].reshape(1, 1, lead[2], 1, 1, mx, 1)
    gslot = (((gz * m + gy) * m + gx) * c + torch.arange(c, device=dev)).expand(tuple(lead) + (mz, my, mx, c))
    gslot = gslot.reshape(-1).to(torch.int32)
    s_idx = torch.arange(shards, device=dev)[:, None, None]
    owner_col = {"bonds": 0, "angles": 1, "torsions": 1, "impropers": 1}

    if has_leftover:
        if atom_params is None:
            raise ValueError("excl_leftover needs atom-ordered LJ params (atom_params)")
        lo_pairs = torch.from_numpy(np.asarray(_numpy(excl_leftover[0]), np.int64)).to(dev)
        pi, pj = lo_pairs[:, 0], lo_pairs[:, 1]
        tile = lambda a: a.repeat(shards)  # noqa: E731
        hs_a = torch.as_tensor(_numpy(atom_params.half_sigma), dtype=torch.float32, device=dev)
        tse_a = torch.as_tensor(_numpy(atom_params.twice_sqrt_eps), dtype=torch.float32, device=dev)
        lo_hs_i, lo_tse_i, lo_hs_j, lo_tse_j = tile(hs_a[pi]), tile(tse_a[pi]), tile(hs_a[pj]), tile(tse_a[pj])
        lo_wlj = tile(torch.from_numpy(1.0 - np.asarray(_numpy(excl_leftover[1]), np.float32)).to(dev))
        lo_has_q = coulomb is not None and atom_charges is not None
        if lo_has_q:
            q_a = torch.as_tensor(np.asarray(_numpy(atom_charges), np.float32), device=dev)
            lo_qi, lo_qj = tile(q_a[pi]), tile(q_a[pj])
            cs = excl_leftover[2] if excl_leftover[2] is not None else excl_leftover[1]
            lo_wc = tile(torch.from_numpy(1.0 - np.asarray(_numpy(cs), np.float32)).to(dev))

    def locate(amap, atoms, valid):
        """Term atoms (T, k) → extended-grid indices (shards·T, k), row
        targets (shards·T, k) (own slot, else the dump row shards·n_own),
        ownership (shards, T, k), and the bad flag."""
        gs = amap[torch.clamp(atoms, max=n_at)].to(torch.int64)
        slot, cell = gs % c, gs // c
        g = torch.stack([cell // (m * m), (cell // m) % m, cell % m], -1)  # (T, k, 3) z, y, x
        owned = ((g[None] // loc) == sc[:, None, None, :]).all(-1) & valid[None, :, None]  # (S, T, k)
        rel = owned.any(-1)
        d = g[:, :, None, :] - g[:, None, :, :]
        far = (((d + m // 2) % m - m // 2).abs() > 1).any(-1)  # (T, k, k)
        bad = (owned[..., None] & far[None]).any()
        e = (g[None] - (sc[:, None, None, :] * loc - 1)) % m  # ext coordinate: the −1 ghost layer is 0
        inside = (e <= loc + 1).all(-1)
        ext = ((e[..., 0] * (my + 2) + e[..., 1]) * (mx + 2) + e[..., 2]) * c + slot + s_idx * n_ext
        ext = torch.where(rel[..., None] & inside, ext, shards * n_ext)
        lc = g[None] - sc[:, None, None, :] * loc
        tgt = ((lc[..., 0] * my + lc[..., 1]) * mx + lc[..., 2]) * c + slot + s_idx * n_own
        tgt = torch.where(owned, tgt, shards * n_own)
        k = atoms.shape[1]
        return ext.reshape(-1, k), tgt.reshape(-1, k), owned, bad

    def bind(aid, valid):
        ids = torch.where(valid, aid, n_at + 1).reshape(-1).to(torch.int64)
        amap = torch.zeros(n_at + 2, dtype=torch.int32, device=dev).index_put((ids,), gslot)[: n_at + 1]
        amap = mesh.psum(amap)
        bad = torch.zeros((), dtype=torch.bool, device=dev)
        rows_sys, tgt_sys, e_sys = {}, {}, {}
        for name, t in tables:
            ext, tgt, owned, b = locate(amap, t.atoms, t.valid)
            bad = bad | b
            rep = {f: torch.cat([getattr(t, f)] * shards) for f in t._fields if f not in ("atoms", "valid")}
            rows_sys[name] = t._replace(atoms=ext, valid=owned.any(-1).reshape(-1), **rep)
            tgt_sys[name] = t._replace(atoms=tgt)
            e_sys[name] = rows_sys[name]._replace(valid=owned[..., owner_col[name]].reshape(-1))
        blank = dict.fromkeys(_FAMILIES)
        rows_sys = BondedSystem(**{**blank, **rows_sys}) if tables else None
        e_sys = BondedSystem(**{**blank, **e_sys}) if tables else None
        targets = [] if not tables else [_row_targets(BondedSystem(**{**blank, **tgt_sys}), shards * n_own + 1)]
        lo = None
        if has_leftover:
            ext, tgt, owned, b = locate(amap, lo_pairs, torch.ones(len(lo_pairs), dtype=torch.bool, device=dev))
            bad = bad | b
            lo = (ext, owned.any(-1).reshape(-1), owned[..., 0].reshape(-1))
            targets.append(tgt.t().reshape(-1))
        plan = add_plan(torch.cat(targets), shards * n_own + 1)
        return (rows_sys, e_sys, lo, plan), bad

    def leftover_terms(pos_ext, lo, box):
        ext, rel, _ = lo
        dv = pos_ext[ext[:, 0]] - pos_ext[ext[:, 1]]
        dv = dv - torch.round(dv / box) * box
        r2 = torch.where(rel, torch.sum(dv * dv, dim=-1), 1.0)
        e, mre = pair_interaction(r2, model, lo_hs_i, lo_tse_i, lo_hs_j, lo_tse_j)
        e, mre = lo_wlj * e, lo_wlj * mre
        if lo_has_q:
            e_c, mre_c = coulomb_interaction(r2, coulomb, lo_qi, lo_qj)
            e, mre = e + lo_wc * e_c, mre + lo_wc * mre_c
        return dv, r2, e, mre

    def forces(pos_ext, binding, box):
        rows_sys, _, lo, plan = binding
        rows = [] if rows_sys is None else [bonded_force_rows(pos_ext, box, rows_sys)[1]]
        if lo is not None:
            dv, r2, _, mre = leftover_terms(pos_ext, lo, box)
            f_ij = torch.where(lo[1], mre / r2, 0.0)[:, None] * dv
            rows.append(torch.cat([-f_ij, f_ij]))
        out = torch.zeros((shards * n_own + 1, 3), dtype=pos_ext.dtype, device=dev)
        return fixed_add(out, plan, torch.cat(rows))[:-1]

    def energy(pos_ext, binding, box):
        _, e_sys, lo, _ = binding
        pe = torch.zeros((), dtype=pos_ext.dtype, device=dev)
        vir = torch.zeros_like(pe)
        if e_sys is not None:
            pe, vir = e_sys.energy(pos_ext, box), e_sys.virial(pos_ext, box)
        if lo is not None:
            _, _, e, mre = leftover_terms(pos_ext, lo, box)
            pe = pe - torch.sum(torch.where(lo[2], e, 0.0))
            vir = vir - torch.sum(torch.where(lo[2], mre, 0.0))
        return pe, vir

    return bind, forces, energy


GRID_BACKENDS = ("auto", "cuda", "cuda_streaming", "pallas_streaming", "torch", "torch_streaming")


def grid_vmem_estimate(config: CellDenseConfig, mesh: GridMesh, uniform_params=None, with_coulomb: bool = False,
                       with_excl: bool = False) -> int:
    """The reference's per-shard VMEM estimate of its resident kernel
    (grid_sharded.py:237-249): (n_gf + 3) ghost fields of (mz+2)(my+2)(mx+2)·C
    float32 and the pair tiles 8·C·mx·C·4 B, with n_gf = 3 positions, 2 LJ
    parameters without `uniform_params`, and one field each for the charges
    and the atom ids."""
    mz, my, mx = validate_grid_config(config, mesh)
    c = config.capacity
    gb = (mz + 2) * (my + 2) * (mx + 2) * c * 4
    n_gf = 3 + (0 if uniform_params is not None else 2) + int(with_coulomb) + int(with_excl)
    return (n_gf + 3) * gb + 8 * c * mx * c * 4


def resolve_grid_backend(config: CellDenseConfig, mesh: GridMesh, backend: str = "auto", *, uniform_params=None,
                         with_coulomb: bool = False, with_excl: bool = False) -> str:
    """The grid engine's kernel family on the mesh's device: 'cuda' (K2-G),
    'cuda_streaming' (K5s and the fold), or their plain versions 'torch'
    and 'torch_streaming' ('torch_streaming' is the reference's
    'pallas_streaming_interpret': the same half shell, reaction ghosts and
    fold, on any device).  'auto' follows the reference's per-shard rule:
    the streaming family on a CUDA device once `grid_vmem_estimate` passes
    13 MB, else 'cuda'; 'torch' on the CPU.  'pallas_streaming' is
    'cuda_streaming'; 'cuda' and 'cuda_streaming' raise for a mesh that is
    not on a CUDA device.  Nothing here touches the card."""
    if backend not in GRID_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: use one of {', '.join(GRID_BACKENDS)}")
    on_card = mesh.device.type == "cuda"
    if backend == "pallas_streaming":
        backend = "cuda_streaming"
    if backend == "auto":
        if not on_card:
            return "torch"
        est = grid_vmem_estimate(config, mesh, uniform_params, with_coulomb, with_excl)
        return "cuda_streaming" if est > STREAMING_THRESHOLD_BYTES else "cuda"
    if backend in ("cuda", "cuda_streaming") and not on_card:
        raise ValueError(f"backend={backend!r} needs a mesh on a CUDA device, got {mesh.device}")
    return backend


def make_grid_sharded_sim(
    config: CellDenseConfig,
    model: LennardJonesModel,
    dt: float,
    mesh: GridMesh,
    backend: str = "auto",
    uniform_params=None,
    coulomb=None,
    excl_tables=None,
    thermostat=None,
    barostat=None,
    bonded=None,
    excl_leftover=None,
    atom_params=None,
    atom_charges=None,
):
    """(rollout, energy) closures on a grid-sharded state (`distribute_grid`).

    backend: 'auto', 'cuda', 'cuda_streaming' (alias 'pallas_streaming'),
    'torch' or 'torch_streaming', resolved once by `resolve_grid_backend`:
    the resident family (K2-G, the rebins on K6) or the streaming family
    (K5s and the fold, the rebins on K6) on the card, their plain versions
    ('torch', 'torch_streaming') on any device; 'auto' picks by the
    reference's per-shard VMEM rule on the card and 'torch' on the CPU.
    uniform_params: optional (half_sigma, twice_sqrt_eps) floats shared by
    every atom (`detect_uniform_params`); the ghost grids then carry
    positions only (not with the molecular terms, which read the per-atom
    parameters).

    thermostat: None (leapfrog NVE, no Kahan compensation, as the
    reference's grid engine), `CSVRConfig` (the synced kick-drift-kick with
    one global rescale a step: the kinetic energy summed over the shards,
    one draw from the rollout's `rng`) or `LangevinConfig` (BAOAB; the noise
    is the global (M, M, M, C, 3) field of standard normals drawn from the
    rollout's `rng`, as the one-card engine draws it, cut to this process's
    shards, so any mesh and any number of ranks gets the same noise).  The
    `rng` is a `torch.Generator` on the mesh's device, seeded alike on
    every rank.  barostat: `BerendsenBarostatConfig` — at every block
    boundary the pressure (2K + W)/(3V) from the force pass's energy mode
    and the term rows' virial, summed over the shards, rescales positions
    and the state's dynamic box (a 0-d device tensor, from config.box if
    the state has none) by μ = clip(μ³, 0.9, 1.1)^(1/3), on the synced
    step; the sticky flag trips when the box falls below M·(rc + skin)
    (`reconfigure_grid_state` re-derives the geometry).

    The molecular terms (K2c-G, K5s-mol), as the reference's grid engine
    takes them: coulomb, a `DSFCoulomb` model (the state must carry
    charges, which ride every rebin) — DSF on every pair; excl_tables, the
    atom-indexed (ids, mlj, mcs) tag tables of `build_exclusion_tables` (E ≤
    8 on the kernels; mcs None with coulomb: the LJ scales), from which each
    shard's centre tags are rebuilt after every rebin; bonded, a
    `BondedSystem` in atom order, and excl_leftover, the (pairs, lj_scales,
    coulomb_scales) beyond the tag band (with atom_params, and atom_charges
    with coulomb), as term rows that each shard evaluates for its own atoms
    (`_grid_terms`).  The grid keeps its bonds as rows: no bond rides the
    tags.

    A spill config (config.spill, with a positive margin ε = h − rc − skin
    at the static cell side h, the reference's rule) rebins through K7-G
    (`rebin_window_kernel.spill_grid_rebin`: one launch a rebin where every
    shard lies in this process, else three passes over halo planes two
    layers deep); both force families run on it unchanged."""
    from emdee_tpu_torch.dynamics.bussi import _csvr_alpha2, csvr_draws
    from emdee_tpu_torch.neighbors import cell_kernel
    from emdee_tpu_torch.neighbors.cell_dense import _numpy
    from emdee_tpu_torch.neighbors.rebin_window_kernel import (
        global_coords,
        halo_planes,
        rebin_halo_pass,
        spill_grid_rebin,
    )
    from emdee_tpu_torch.neighbors.streaming_kernel import streaming_ghost_forces

    if thermostat is not None and not isinstance(thermostat, (CSVRConfig, LangevinConfig)):
        raise ValueError(f"unknown thermostat {thermostat!r}")
    if barostat is not None and not isinstance(barostat, BerendsenBarostatConfig):
        raise ValueError(f"unknown barostat {barostat!r}")

    mz, my, mx = validate_grid_config(config, mesh)
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    lead = mesh.local_shape
    dev = mesh.device
    dt_f = _f32(dt)
    half_dt = _f32(np.float32(0.5) * np.float32(dt))
    ndof = 3.0 * config.num_atoms - 3.0
    has_q, has_excl = coulomb is not None, excl_tables is not None
    uniform = uniform_params is not None and not (has_q or has_excl)
    family = resolve_grid_backend(config, mesh, backend, uniform_params=uniform_params, with_coulomb=has_q,
                                  with_excl=has_excl)
    streaming = family.endswith("streaming")
    kernels = "cuda" if family.startswith("cuda") else "torch"  # the kernel wrappers' backend
    synced = thermostat is not None or barostat is not None
    terms = _grid_terms(config, mesh, model, coulomb, bonded, excl_leftover, atom_params, atom_charges)
    if has_excl:
        ids_t, mlj_t, mcs_t = excl_tables
        if has_q and mcs_t is None:
            mcs_t = mlj_t  # never "skip Coulomb exclusions": the LJ scales stand in
        cols = [t for t in (ids_t, mlj_t, mcs_t) if t is not None]
        packed = torch.from_numpy(np.concatenate([np.asarray(_numpy(t), np.float32) for t in cols], -1)).to(dev)
        n_tab, e_n = packed.shape[0] - 1, int(_numpy(ids_t).shape[-1])

    b_axes = [global_coords(mesh, (mz, my, mx), axis) for axis in range(3)]
    spill = _spill_params(config) if config.spill and float(config.cell_side) - config.cutoff - config.skin > 0 else None
    # The ghost grids' mark of empty position slots.
    nan = torch.full((), float("nan"), dtype=torch.float32, device=dev)

    def bindings(aid, valid):
        """The per-rebin molecular bindings of a slot layout: (the atom ids
        as the ghost grids carry them, the centre tags, the term binding),
        and the term binding's bad flag (None without terms)."""
        aidf = tags = tb = bad = None
        if has_excl:
            aidf = torch.where(valid, aid, -2).view(torch.float32)
            g = packed[torch.clamp(aid, max=n_tab).to(torch.int64)]
            parts = [t.contiguous() for t in torch.split(g, e_n, dim=-1)]
            tags = (parts[0], parts[1], parts[2] if len(parts) > 2 else None)
        if terms is not None:
            tb, bad = terms[0](aid, valid)
        return (aidf, tags, tb), bad

    def pair_pass(gh, box_t, compute_energy, tags):
        """(forces, e, w) of the own slots from the ghost grids: K2-G's full
        shell, or K5s's half shell and the fold of its reaction ghosts."""
        kw = dict(uniform_params=uniform_params if uniform else None, compute_energy=compute_energy,
                  backend=kernels, coulomb=coulomb, excl=tags, box=box_t)
        if not streaming:
            return cell_kernel.ghost_forces(gh, lead, mesh.base, config, model, **kw)
        f, react, e, w = streaming_ghost_forces(gh, lead, mesh.base, config, model, **kw)
        back = _fold3(react, mesh)
        if compute_energy:
            return f + back[:3], e + back[3], w + back[4]
        return f + back, None, None

    def forces_of(pos3, valid, hs, tse, q, bound, box_t, compute_energy=False, with_terms=True):
        """(forces (3, …), e, w, term (pe, vir) or None) of the local
        shards; pos3 (3, sz, sy, sx, mz, my, mx, C)."""
        aidf, tags, tb = bound
        parts = [torch.where(valid, pos3, nan)]
        if not uniform:
            parts += [hs[None], tse[None]]
        if has_q:
            parts.append(q[None])
        if has_excl:
            parts.append(aidf[None])
        gh = _ghost3(torch.cat(parts), mesh)
        f, e, w = pair_pass(gh, box_t, compute_energy, tags)
        if tb is None or not with_terms:
            return f, e, w, None
        pos_ext = torch.cat([gh[:3].reshape(3, -1).t(), gh.new_zeros((1, 3))])
        f = f + terms[1](pos_ext, tb, box_t).reshape(tuple(lead) + (mz, my, mx, c, 3)).movedim(-1, 0)
        return f, e, w, (terms[2](pos_ext, tb, box_t) if compute_energy else None)

    def rebin(pos3, vel3, inv_m, hs, tse, aid, valid, q, overflow, box_t, f3=None):
        """The per-shard shift rebin: three passes (z, y, x) over the
        shards' own rows, each with the halo planes that `mesh.shift`
        brings (K6, one layer each side), or for a spill config K7-G
        (`spill_grid_rebin`: one launch where every shard is local, else
        three passes over halo planes two layers deep); the first pass
        reads the transported fields where they lie and parks (by atom id)
        and wraps them.  Returns the routed (pos3, vel3, inv_m, hs, tse,
        aid, valid, q, overflow, f3)."""
        parts = ([pos3, vel3, inv_m[None], hs[None], tse[None]] + ([] if q is None else [q[None]])
                 + ([] if f3 is None else [f3]))
        x = [p[i] for p in parts for i in range(p.shape[0])] + [torch.where(valid, aid, ns)]
        flag = None
        if spill is not None:
            x, flag = spill_grid_rebin(x, mesh, b_axes, box_t, m, c, ns, spill, backend=kernels)
        else:
            for axis in range(3):
                lo, hi = halo_planes(x, mesh, axis)
                x, flag = rebin_halo_pass(x, lo, hi, b_axes[axis], box_t, axis, m, c, ns, raw=axis == 0, flag=flag,
                                          backend=kernels)
        overflow = overflow | (flag != 0)
        aid = x[-1]
        valid = aid < ns
        xf = x[:-1].view(torch.float32)  # empty slots: the fill, 0 beyond the positions
        pos3 = torch.where(valid, xf[0:3], 0.0)
        k = 9 if q is None else 10
        return (pos3, xf[3:6], xf[6], xf[7], xf[8], aid, valid, None if q is None else xf[9], overflow,
                None if f3 is None else xf[k:k + 3])

    def stale(pos3, ref3, valid, box_t):
        d = pos3 - ref3
        return _stale(d[0], d[1], d[2], valid, config, box_t)

    def unpack(st: CellDenseState):
        if has_q and st.charges is None:
            raise ValueError("coulomb model given but state has no charges")
        return (st.positions.movedim(-1, 0).contiguous(), st.velocities.movedim(-1, 0).contiguous(),
                st.inv_masses, st.half_sigma, st.twice_sqrt_eps, st.atom_id, st.valid, st.charges)

    def kinetic(vel3, inv_m, valid):
        return 0.5 * torch.sum(torch.where(valid, vel3**2 / torch.clamp(inv_m, min=1e-30), 0.0))

    def lengths_of(num_steps, rebin_every):
        blocks, rem = divmod(num_steps, rebin_every)
        return [rebin_every] * blocks + ([rem] if rem else [])

    def local_noise(rng):
        """The global (M, M, M, C, 3) standard normals, drawn from `rng` as
        the one-card engine draws its (M³, C, 3) noise, cut to this
        process's shards: (3, sz, sy, sx, mz, my, mx, C)."""
        nz, ny, nx = mesh.shape
        lo, n = mesh.base, mesh.local_shape
        z = torch.randn((m, m, m, c, 3), generator=rng, dtype=torch.float32, device=dev)
        z = z.reshape(nz, mz, ny, my, nx, mx, c, 3).permute(7, 0, 2, 4, 1, 3, 5, 6)
        return z[:, lo[0] : lo[0] + n[0], lo[1] : lo[1] + n[1], lo[2] : lo[2] + n[2]]

    if isinstance(thermostat, LangevinConfig):
        kT = thermostat.kB * thermostat.temperature
        c1 = float(np.exp(-thermostat.friction * dt))
        c2 = float(np.sqrt((1.0 - c1 * c1) * kT))

    def synced_step(pos3, vel3, f, inv_m, valid, hs, tse, q, bound, box_t, rng):
        """One synced step: velocity-Verlet kick-drift-kick with the CSVR
        rescale after it, or BAOAB Langevin (kick, half drift, exact OU
        solve, half drift, kick).  Returns (positions, velocities, forces)."""
        if isinstance(thermostat, LangevinConfig):
            v = vel3 + half_dt * f * inv_m
            x = pos3 + half_dt * v
            v = c1 * v + c2 * torch.sqrt(inv_m) * local_noise(rng)
            x = torch.where(valid, x + half_dt * v, pos3)
            f = forces_of(x, valid, hs, tse, q, bound, box_t)[0]
            return x, torch.where(valid, v + half_dt * f * inv_m, 0.0), f
        v_half = vel3 + half_dt * f * inv_m
        x = torch.where(valid, pos3 + dt_f * v_half, pos3)
        f = forces_of(x, valid, hs, tse, q, bound, box_t)[0]
        v = v_half + half_dt * f * inv_m
        if isinstance(thermostat, CSVRConfig):
            kin = mesh.psum(kinetic(v, inv_m, valid))
            r1, sum_r2 = csvr_draws(rng, ndof, v)
            alpha2 = _csvr_alpha2(r1, sum_r2, torch.clamp(kin, min=1e-30), ndof,
                                  thermostat.kB * thermostat.temperature, dt_f, thermostat.tau)
            v = torch.sqrt(torch.clamp(alpha2, min=0.0)) * v
        return x, v, f

    def rescale_box(pos3, ref3, vel3, inv_m, valid, hs, tse, q, bound, box_t, length, overflow):
        """Berendsen μ-rescale at a block boundary from the pressure of the
        force pass's energy mode and the term rows, summed over the shards;
        the forces carry over unrescaled (the weak-coupling approximation)."""
        _, _, w, te = forces_of(pos3, valid, hs, tse, q, bound, box_t, compute_energy=True)
        vir = torch.sum(torch.where(valid, w, 0.0))
        if te is not None:
            vir = vir + te[1]
        pvk = mesh.psum(torch.stack([vir, kinetic(vel3, inv_m, valid)]))
        p_inst = (2.0 * pvk[1] + pvk[0]) / (3.0 * box_t**3)
        mu3 = 1.0 - (length * dt / barostat.tau) * barostat.kappa * (barostat.pressure - p_inst)
        mu = torch.clamp(mu3, 0.9, 1.1) ** (1.0 / 3.0)
        box_t = box_t * mu
        overflow = overflow | (box_t < config.cells_per_dim * (config.cutoff + config.skin))
        return pos3 * mu, ref3 * mu, box_t, overflow

    def rollout(state: CellDenseState, num_steps: int, rebin_every: int = 10,
                rng: Optional[torch.Generator] = None) -> CellDenseState:
        """Blocked rollout: rebin every `rebin_every` steps (the molecular
        bindings rebuilt after each; with the barostat, the box rescaled
        before each), then run that many steps; the flag is OR'd over the
        shards at the end.  A thermostatted rollout needs `rng`, a
        `torch.Generator` on the mesh's device."""
        if thermostat is not None and rng is None:
            raise ValueError("a thermostatted rollout needs an rng: a torch.Generator on the mesh's device")
        if num_steps == 0:
            return state
        pos3, vel3, inv_m, hs, tse, aid, valid, q = unpack(state)
        ref3, overflow = state.ref_positions.movedim(-1, 0), state.overflow
        box_t = _box(_box_of(state, config), pos3)
        bound, bad = bindings(aid, valid)
        overflow = overflow if bad is None else overflow | bad
        f = forces_of(pos3, valid, hs, tse, q, bound, box_t)[0]
        if not synced:
            # Leapfrog: velocities ride half a step ahead, so no force field
            # crosses a rebin; a closing half un-kick re-syncs.
            vel3 = torch.where(valid, vel3 + half_dt * f * inv_m, 0.0)
        for length in lengths_of(num_steps, rebin_every):
            if barostat is not None:
                pos3, ref3, box_t, overflow = rescale_box(pos3, ref3, vel3, inv_m, valid, hs, tse, q, bound, box_t,
                                                          length, overflow)
            pos3, vel3, inv_m, hs, tse, aid, valid, q, overflow, f = rebin(
                pos3, vel3, inv_m, hs, tse, aid, valid, q, overflow, box_t, f if synced else None)
            ref3 = pos3
            bound, bad = bindings(aid, valid)
            overflow = overflow if bad is None else overflow | bad
            for _ in range(length):
                if synced:
                    pos3, vel3, f = synced_step(pos3, vel3, f, inv_m, valid, hs, tse, q, bound, box_t, rng)
                else:
                    pos3 = torch.where(valid, pos3 + dt_f * vel3, pos3)
                    f = forces_of(pos3, valid, hs, tse, q, bound, box_t)[0]
                    vel3 = torch.where(valid, vel3 + dt_f * f * inv_m, 0.0)
            overflow = overflow | stale(pos3, ref3, valid, box_t)
        if not synced:
            f = forces_of(pos3, valid, hs, tse, q, bound, box_t)[0]
            vel3 = torch.where(valid, vel3 - half_dt * f * inv_m, 0.0)
        return state._replace(
            positions=pos3.movedim(0, -1).contiguous(), velocities=vel3.movedim(0, -1).contiguous(),
            inv_masses=inv_m, half_sigma=hs, twice_sqrt_eps=tse, atom_id=aid, valid=valid,
            ref_positions=ref3.movedim(0, -1).contiguous(), step=state.step + num_steps,
            overflow=mesh.pmax(overflow), charges=q,
            box=box_t if barostat is not None or state.box is not None else None,
        )

    def energy(state: CellDenseState):
        """(potential energy, virial, kinetic energy) as 0-d tensors, summed
        over every shard: the pair terms' per-slot halves and the term rows'
        energies."""
        pos3, vel3, inv_m, hs, tse, aid, valid, q = unpack(state)
        _, e, w, te = forces_of(pos3, valid, hs, tse, q, bindings(aid, valid)[0], _box(_box_of(state, config), pos3),
                                compute_energy=True)
        pe = torch.sum(torch.where(valid, e, 0.0))
        vir = torch.sum(torch.where(valid, w, 0.0))
        if te is not None:
            pe, vir = pe + te[0], vir + te[1]
        out = mesh.psum(torch.stack([pe, vir, kinetic(vel3, inv_m, valid)]))
        return out[0], out[1], out[2]

    def forces(state: CellDenseState, compute_energy: bool = False, with_terms: bool = True):
        """(forces (sz, sy, sx, mz, my, mx, C, 3), e, w) of a grid-sharded
        state: the rollout's force pass (pairs and, with `with_terms`, the
        term rows), for checks."""
        pos3, _, _, hs, tse, aid, valid, q = unpack(state)
        f, e, w, _ = forces_of(pos3, valid, hs, tse, q, bindings(aid, valid)[0], _box(_box_of(state, config), pos3),
                               compute_energy, with_terms)
        return f.movedim(0, -1), e, w

    rollout.forces = forces
    rollout.family = family
    return rollout, energy


__all__ = [
    "GRID_BACKENDS",
    "distribute_grid",
    "gather_grid_atoms",
    "gather_grid_state",
    "grid_vmem_estimate",
    "make_grid_sharded_sim",
    "reconfigure_grid_state",
    "resolve_grid_backend",
]
