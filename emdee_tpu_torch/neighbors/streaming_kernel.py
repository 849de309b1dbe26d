"""Streaming half-shell force pass (K5, and K5c with the molecular terms):
the CUDA kernel and its plain version — counterpart of
`pallas_cell_forces_streaming` and `pallas_cell_forces_streaming_split`
(emdee_tpu/neighbors/pallas_cell_kernel.py).

The TPU engine switches to its streaming kernel when the resident kernel's
VMEM estimate passes 13 MB (`cell_dense.resolve_dense_backend`), which puts
the 1,000,188-atom melt and the 98,304-atom water box here.
`cell_forces_streaming` takes the stacked state (per-atom or uniform
parameters, optional per-slot ½E and ½W) and, with `coulomb=`/`excl=`, the
molecular terms (K5c: DSF Coulomb over the state's charges, exclusion tags,
tag-borne bonds); `cell_forces_streaming_split` takes (M³, C) component
arrays with uniform parameters, forces only.  For CUDA tensors (backend
'auto' or 'cuda') each call makes two launches of
`csrc/cell_forces_streaming.cu`: the half-shell pair pass and the fold.  In
the pair pass warps own centre cells: K5's warp walks the self cell and the
13 half-shell offsets of its cell (K5c's warp one of them), culls each
neighbour pair to the atoms within the cutoff of the other cell's bounding
box (`cull_pair` mirrors it), and writes its centre sums and each offset's
reactions to scratch slices (`scratch_bytes`), which the fold adds in a
fixed order — K5's in the association of the pencil kernel it replaced.
Every kernel of the family takes C up to 1024, as the resident family (the
reference's streaming kernel has no limit): above C = 96, three centre
slots a lane, its variant compacts a cell into 96-entry chunks and runs a
cell pair chunk pair by chunk pair through the same ring, a block holding
as many warps as its shared memory allows (`smem_bytes`).
For CPU tensors, or backend 'torch', they run the plain version: the half
shell of `cell_dense._dense_forces`, the same as the resident kernel's
(with the molecular terms, `cell_dense_forces(coulomb=, excl=)`, K2c's).

`streaming_ghost_forces` (K5s) is the grid-sharded engine's per-shard pass
of the same kernel (the reference's `_local_forces_streaming`, for shards
beyond VMEM residency): two launches, the half-shell pair pass over each
local shard's ghost grid (LJ: one block of 8 warps a pencil, the design K5
had before it moved to warp-owned cells) and the assembly of its reaction
rows into the
interior forces and a reaction ghost grid, which the engine returns to the
owning shards (`grid_sharded._fold3`).  With the molecular terms (K5s-mol)
the pair pass is K5c's warp-owned pass with its cull on the ghost grids (a
warp owns one phase of one own cell, the shift from the neighbour's global
cell index, `ghost_phase` mirrors it), and the assembly adds its 27 scratch
slices in a fixed order.  Its plain version,
`streaming_ghost_forces_plain`, has the structure of the reference's
`_local_forces_xla`: each half-shell reaction written to the ghost cell at
+o.  Because the fold adds a shard's boundary reactions in another order,
decompositions agree to roundoff, not bit for bit.
"""

from __future__ import annotations

import torch

from emdee_tpu_torch.csrc import build
from emdee_tpu_torch.neighbors.cell_dense import (
    CellDenseConfig,
    CellDenseState,
    _box_of,
    box_ptr,
    cell_dense_forces,
    resolve_backend,
)
from emdee_tpu_torch.neighbors.cell_kernel import (  # noqa: F401 (CULL_SLACK, cull_keep: re-exported)
    CULL_SLACK,
    _check,
    _dsf_operands,
    _pair_consts,
    _tag_operands,
    cull_keep,
    ghost_tiles,
    mol_operands,
    resources,
    split_operands,
    split_plain,
    stacked_operands,
    tag_counts,
)
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel

# Kernel launches since import (or since a caller reset it to 0): two per
# force evaluation, the pair pass and the fold (K5s: the assembly).
LAUNCHES = 0

MAX_CAPACITY = 1024  # as the resident family (csrc/cell_forces.cu)
# Up to C = 96 a lane holds three centre slots; above it a cell is compacted
# into 96-entry chunks and a cell pair runs as its chunk pairs (kChunk).
_CHUNK = 96
_SMEM_BYTES = 232_448  # shared memory a block can use on Hopper
_WARPS = 8  # K5s (LJ): warps a pencil block
_ROW_GROUPS = 4  # K5s (LJ): reaction row groups besides the own row
_OWNED_WARPS = 4  # K5c: warps a block, each owning a phase of a centre cell
_PHASES, _OFFSETS = 14, 13  # the self cell and the half-shell offsets
_SLICES = _PHASES + _OFFSETS  # K5c's scratch: the centre sums of each phase, the reactions of each offset
# K5: warps a block, each walking the 14 phases of a centre cell, and the
# blocks an SM its launch bounds ask the registers for at C ≤ 32 (the C
# source's kLjWarps, kLjMinBlocks); its scratch: one centre slice and the
# 13 reaction slices.
K5_WARPS, K5_MIN_BLOCKS = 4, 8
K5_SLICES = 1 + _OFFSETS
# The half-shell offsets (dz, dy, dx) in phase order (kOffDz/Dy/Dx of the C source).
PHASE_OFFSETS = ((0, 1, -1), (0, 1, 0), (0, 1, 1), (1, -1, -1), (1, -1, 0), (1, -1, 1), (1, 0, -1), (1, 0, 0),
                 (1, 0, 1), (1, 1, -1), (1, 1, 0), (1, 1, 1), (0, 0, 1))


def _chunks(c: int) -> int:
    """The 96-entry chunks of a cell at C > 96 (the C source's chunks_of)."""
    return -(-c // _CHUNK)


def _fit(per_warp: int, most: int, fixed: int = 0):
    """A block at C > 96, as the C entries size it (`fit_warps`): (its
    shared bytes, its warps) — as many warps of `per_warp` bytes beside
    `fixed` as fit a block's shared memory, at most `most`; one warp's
    bytes and 0 warps where none fits."""
    warps = 0 if fixed + per_warp > _SMEM_BYTES else min(most, (_SMEM_BYTES - fixed) // per_warp)
    return fixed + per_warp * max(warps, 1), warps


def _k5_block(c: int, energy: bool, uniform: bool):
    """K5's block: (shared bytes, warps).  For each warp, up to C = 96 three
    compacted cell tiles (its cell, the centres a phase's cull keeps, the
    phase's neighbour; 64 entries up to C = 64, else 96; x, y, z, with
    per-atom parameters σ/2 and 2√ε, and the slot), above it its cell's and
    the neighbour's chunks and two work tiles; and its centre and reaction
    rows, (2, n_r, C) float32.  4 warps up to C = 96, else as many as fit."""
    fields, rows = (4 if uniform else 6), 2 * (5 if energy else 3) * c
    if c <= 3 * 32:
        return 4 * K5_WARPS * (3 * fields * (64 if c <= 64 else 96) + rows), K5_WARPS
    return _fit(4 * ((2 * _chunks(c) + 2) * fields * _CHUNK + rows), K5_WARPS)


def smem_bytes(config: CellDenseConfig, energy: bool, mol: bool = False, ne: int = 0, neb: int = 0,
               uniform: bool = False) -> int:
    """A block's shared memory, as the C entries count it, whatever M: K5's
    (`_k5_block`); K5c's (`mol`): for each of its 4 warps (at C > 96, as
    many as fit), two tiles (x, y, z, σ/2, 2√ε, q, the atom id and the
    slot; at C > 96 both cells' chunks and two work tiles), the staged
    centre tags (3 values a tag and a bond tag) and its centre and reaction
    rows.  Above Hopper's 232,448 B where not one warp fits."""
    c = config.capacity
    if mol:
        return _owned_block(c, energy, ne, neb)[0]
    return _k5_block(c, energy, uniform)[0]


def scratch_bytes(config: CellDenseConfig, energy: bool) -> int:
    """K5's scratch, as `cell_forces_streaming` allocates it: K5_SLICES
    slices of (n_r, M³·C) float32, written once by the pair pass and read
    once by the fold."""
    return 4 * K5_SLICES * (5 if energy else 3) * config.num_slots


def _owned_block(c: int, energy: bool, ne: int, neb: int):
    """A warp-owned block (K5c, K5s-mol), whatever M: (shared bytes,
    warps)."""
    rows = 2 * (5 if energy else 3) * c
    if c <= 3 * 32:
        entries = 64 if c <= 64 else 96
        return 4 * _OWNED_WARPS * (2 * 8 * entries + 3 * (ne + neb) * entries + rows), _OWNED_WARPS
    return _fit(4 * ((2 * _chunks(c) + 2) * 8 * _CHUNK + 3 * (ne + neb) * _CHUNK + rows), _OWNED_WARPS)


def cull_pair(cen, nb, shift, cut2: float):
    """K5c's cull of one cell pair (for the tests): the centre points cen
    (n, 3) kept within the cutoff of the neighbour points' box shifted by
    `shift` (displacements are (x_i − x_j) − shift), then the neighbour
    points nb (k, 3) kept within the cutoff of the kept centres' box shifted
    back.  Returns (centre mask, neighbour mask)."""
    keep_c = cull_keep(cen, nb.min(0).values, nb.max(0).values, shift, cut2)
    if not bool(keep_c.any()):
        return keep_c, torch.zeros(nb.shape[0], dtype=torch.bool)
    kept = cen[keep_c]
    return keep_c, cull_keep(nb, kept.min(0).values, kept.max(0).values, -torch.as_tensor(shift), cut2)


def _check_geometry(config: CellDenseConfig, energy: bool, mol: bool = False, ne: int = 0, neb: int = 0) -> None:
    """Refuse what the one-card C entries (K5, K5c) would refuse, before any
    launch: M ≥ 3, C ≤ MAX_CAPACITY, and the block's shared memory
    (`smem_bytes`, which does not grow with M) within what Hopper gives a
    block — above C = 96, one warp's chunks and rows."""
    m, c = config.cells_per_dim, config.capacity
    smem = smem_bytes(config, energy, mol, ne, neb)
    if m < 3 or c > MAX_CAPACITY or smem > _SMEM_BYTES:
        raise ValueError(
            f"the streaming kernel takes M ≥ 3, C ≤ {MAX_CAPACITY} and a block's shared memory within "
            f"{_SMEM_BYTES} B; got M={m}, C={c} ({smem} B)"
        )


def ghost_smem_bytes(mx: int, c: int, energy: bool, mol: bool = False, ne: int = 0) -> int:
    """K5s's shared memory a block, as its C entries count it.  LJ: the
    pencil's centre sums, (n_r, mx·C), and one reaction row, (n_r,
    (mx+2)·C), float32, and the 8 warps' two tiles as `smem_bytes` (at C >
    96 the chunks and work tiles of as many warps as fit beside the rows).
    K5s-mol (`mol`): K5c's warp-owned block with E tags and no bond tags,
    whatever mx."""
    if mol:
        return _owned_block(c, energy, ne, 0)[0]
    rows = 4 * (5 if energy else 3) * (2 * mx + 2) * c
    if c <= 3 * 32:
        return rows + 4 * _WARPS * 2 * 6 * (64 if c <= 64 else 96)
    return _fit(4 * 6 * _CHUNK * (2 * _chunks(c) + 2), _WARPS, rows)[0]


def ghost_mol_scratch_bytes(shards: int, local, c: int, energy: bool) -> int:
    """K5s-mol's scratch, as `streaming_ghost_forces` allocates it: 14 centre
    slices over the own slots of `shards` local shards of `local` = (mz, my,
    mx) cells and 13 reaction slices over their ghost grids, (n_r, slots)
    float32 each."""
    mz, my, mx = local
    own, ghost = shards * mz * my * mx * c, shards * (mz + 2) * (my + 2) * (mx + 2) * c
    return 4 * (5 if energy else 3) * (_PHASES * own + _OFFSETS * ghost)


def ghost_phase(cell: int, phase: int, shards, base, local, m: int, box: float):
    """K5s-mol's geometry of one warp (for the tests): own cell `cell`
    (index over the local shards (sz, sy, sx) of `local` = (mz, my, mx)
    cells, shard-major) at phase 1 + k (offset k of PHASE_OFFSETS): the
    centre's and the neighbour's cell indices in the stacked ghost grids,
    and the periodic shift (x, y, z) that the kernel takes off (x_i − x_j),
    from the neighbour's GLOBAL cell index (the shards' global coordinates
    start at `base`)."""
    mz, my, mx = local
    sy, sx = shards[1], shards[2]
    x, y, z, s = cell % mx, (cell // mx) % my, (cell // (mx * my)) % mz, cell // (mx * my * mz)
    dz, dy, dx = PHASE_OFFSETS[phase - 1]
    glob = ((base[2] + s % sx) * mx + x + dx, (base[1] + (s // sx) % sy) * my + y + dy,
            (base[0] + s // (sx * sy)) * mz + z + dz)
    shift = [-box if v < 0 else (box if v >= m else 0.0) for v in glob]
    gy, gx = my + 2, mx + 2
    ghost = lambda dz, dy, dx: s * (mz + 2) * gy * gx + ((z + 1 + dz) * gy + y + 1 + dy) * gx + x + 1 + dx  # noqa: E731
    return ghost(0, 0, 0), ghost(dz, dy, dx), shift


def _check_ghost_geometry(config: CellDenseConfig, mx: int, energy: bool, mol: bool, ne: int) -> None:
    """Refuse what K5s's C entries would refuse, before any launch: M ≥ 3,
    C ≤ MAX_CAPACITY and a block's shared memory (`ghost_smem_bytes`) within
    what Hopper gives a block (above C = 96, one warp's chunks beside the
    pencil's rows)."""
    m, c = config.cells_per_dim, config.capacity
    smem = ghost_smem_bytes(mx, c, energy, mol, ne)
    if m < 3 or c > MAX_CAPACITY or smem > _SMEM_BYTES:
        raise ValueError(
            f"the streaming kernel's ghost mode takes M ≥ 3, C ≤ {MAX_CAPACITY} and a block's shared memory "
            f"within {_SMEM_BYTES} B; got M={m}, C={c}, mx={mx} ({smem} B)"
        )


def _launch(px, py, pz, pstride, hs, tse, valid, fx, fy, fz, fstride, e, w,
            config: CellDenseConfig, box, uniform_params, energy: bool) -> None:
    """K5's pair pass into its scratch slices, then the fold into fx … w;
    `box` is a number or a 0-d float32 tensor on the device, read there
    either way (`cell_dense.box_ptr`)."""
    global LAUNCHES
    _check_geometry(config, energy)
    slices = torch.empty(scratch_bytes(config, energy) // 4, dtype=torch.float32, device=px.device)
    stream = torch.cuda.current_stream(px.device).cuda_stream
    lib = build.load()
    err = lib.emdee_streaming_forces(
        _ptr(px), _ptr(py), _ptr(pz), pstride, _ptr(hs), _ptr(tse), _ptr(valid), slices.data_ptr(),
        config.cells_per_dim, config.capacity, box_ptr(box, px), *_pair_consts(config, uniform_params),
        int(uniform_params is not None), int(energy), stream,
    )
    build.check(err, "cell_forces_streaming kernel")
    LAUNCHES += 1
    err = lib.emdee_streaming_fold(_ptr(fx), _ptr(fy), _ptr(fz), fstride, _ptr(e), _ptr(w), slices.data_ptr(),
                                   config.num_slots, int(energy), stream)
    build.check(err, "cell_forces_streaming fold")
    LAUNCHES += 1


def cell_forces_streaming(
    state: CellDenseState,
    model: LennardJonesModel,
    config: CellDenseConfig,
    *,
    compute_energy: bool = False,
    uniform_params=None,
    backend: str = "auto",
    coulomb=None,
    excl=None,
):
    """Forces (M³, C, 3) and, with `compute_energy`, per-slot half-split
    energies and virials (M³, C) — else None, None.

    uniform_params: optional (half_sigma, twice_sqrt_eps) floats shared by
    every atom; the kernel then reads no per-atom parameter fields.  The box
    is the state's (`state.box`, read on the device, else config.box).

    coulomb (a `DSFCoulomb` model, the state carrying charges) and excl
    (slot-space tags (ids, mlj, mcs[, (kb, kr0, kr02)]), contiguous, E ≤
    `cell_kernel.MAX_TAGS`) select the molecular kernel (K5c), which reads
    the per-atom parameters; its plain version is K2c's,
    `cell_dense_forces(state, model, config, coulomb, excl)`."""
    if resolve_backend(backend, state.positions) == "torch":
        return cell_dense_forces(state, model, config, coulomb, excl, compute_energy=compute_energy)
    if coulomb is not None or excl is not None:
        return _launch_mol(state, config, coulomb, excl, compute_energy)
    operands, outputs = stacked_operands(state, config, uniform_params, compute_energy)
    _launch(*operands, config, _box_of(state, config), uniform_params, compute_energy)
    return outputs


def _launch_mol(state: CellDenseState, config: CellDenseConfig, coulomb, excl, compute_energy: bool):
    """K5c's pair pass and its fold on a CUDA state."""
    global LAUNCHES
    operands, (forces, e, w) = stacked_operands(state, config, None, compute_energy)
    pos, hs, tse, valid = operands[0], operands[4], operands[5], operands[6]
    q, aid, ids, mlj, mcs, kb, kr0, kr02, ne, neb, *consts = mol_operands(state, config, coulomb, excl)
    _check_geometry(config, compute_energy, True, ne, neb)
    slices = torch.empty((_SLICES, 5 if compute_energy else 3, config.num_slots), dtype=torch.float32,
                         device=pos.device)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    lib = build.load()
    err = lib.emdee_streaming_forces_mol(
        pos.data_ptr(), _ptr(hs), _ptr(tse), valid.data_ptr(), _ptr(q), _ptr(aid), _ptr(ids), _ptr(mlj), _ptr(mcs),
        _ptr(kb), _ptr(kr0), _ptr(kr02), ne, neb, *map(_ptr, consts), slices.data_ptr(), config.cells_per_dim,
        config.capacity, box_ptr(_box_of(state, config), pos), *_pair_consts(config, None)[:8],
        int(coulomb is not None), int(excl is not None), int(kb is not None), int(compute_energy), stream,
    )
    build.check(err, "cell_forces_streaming kernel (molecular)")
    LAUNCHES += 1
    err = lib.emdee_streaming_fold_mol(forces.data_ptr(), _ptr(e), _ptr(w), slices.data_ptr(), _SLICES,
                                       config.num_slots, int(compute_energy), stream)
    build.check(err, "cell_forces_streaming fold (molecular)")
    LAUNCHES += 1
    return forces, e, w


def _ptr(t):
    return None if t is None else t.data_ptr()


def k5_resources(config: CellDenseConfig, uniform: bool, compute_energy: bool) -> dict:
    """The K5 variant for C and these flags, as the card reports it
    (`cell_kernel.resources`)."""
    return resources("emdee_streaming_attrs", "cell_forces_streaming", config.capacity, int(uniform),
                     int(compute_energy), warps=_k5_block(config.capacity, compute_energy, uniform)[1])


def k5c_resources(config: CellDenseConfig, coulomb, excl, compute_energy: bool) -> dict:
    """The K5c variant that these flags and tags (`excl`, as
    `cell_forces_streaming` takes them) select at C, as the card reports it
    (`cell_kernel.resources`)."""
    ne, neb, bond = tag_counts(excl)
    return resources("emdee_streaming_mol_attrs", "cell_forces_streaming (molecular)", config.capacity, ne, neb,
                     int(coulomb is not None), int(excl is not None), int(bond is not None), int(compute_energy),
                     warps=_owned_block(config.capacity, compute_energy, ne, neb)[1])


def k5s_mol_resources(config: CellDenseConfig, coulomb, excl, compute_energy: bool) -> dict:
    """The K5s-mol variant that these flags and centre tags (`excl`, as
    `streaming_ghost_forces` takes them) select at C, as the card reports
    it (`cell_kernel.resources`)."""
    ne = tag_counts(excl)[0]
    return resources("emdee_streaming_ghost_mol_attrs", "cell_forces_streaming (ghost grid, molecular)",
                     config.capacity, ne, int(coulomb is not None), int(excl is not None), int(compute_energy),
                     warps=_owned_block(config.capacity, compute_energy, ne, 0)[1])


def cell_forces_streaming_split(
    px, py, pz, valid,
    config: CellDenseConfig,
    *,
    uniform_params,
    box=None,
    backend: str = "auto",
):
    """Forces (fx, fy, fz), each (M³, C), from component positions with
    uniform LJ parameters — the component-carry rollout's force call.  box:
    a number, a 0-d float32 tensor on the device, or None for config.box."""
    box = config.box if box is None else box
    if resolve_backend(backend, px) == "torch":
        return split_plain(px, py, pz, valid, config, uniform_params, box)
    operands, outputs = split_operands(px, py, pz, valid, config)
    _launch(*operands, config, box, uniform_params, False)
    return outputs


# The half shell (dz, dy, dx) > (0, 0, 0), in the reference's order.
_HALF_SHELL = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                    if (dz, dy, dx) > (0, 0, 0))


def streaming_ghost_forces(ghost, shards, base, config: CellDenseConfig, model: LennardJonesModel, *, box=None,
                           uniform_params=None, compute_energy: bool = False, backend: str = "auto", coulomb=None,
                           excl=None):
    """The grid-sharded engine's per-shard streaming pass (K5s), before the
    fold: (forces (3, sz, sy, sx, mz, my, mx, C), the reaction ghost grid
    (3 or 5, sz, sy, sx, mz+2, my+2, mx+2, C), e, w), with per-slot
    half-split energies and virials (sz, sy, sx, mz, my, mx, C) and their
    reaction rows (components 3 and 4 of the ghost grid) with
    `compute_energy`, else e, w None.  A ghost slot of the reaction grid
    holds the reactions of this shard's pairs on the atom in that slot; the
    interior slots of the grid are zero.  `grid_sharded._fold3` returns the
    ghost layers to their owners.

    ghost, shards, base, uniform_params, coulomb and excl as
    `cell_kernel.ghost_forces` takes them; box: a number or a 0-d float32
    tensor on the device, or None for config.box.  For CUDA tensors
    (backend 'auto' or 'cuda') two launches of `csrc/cell_forces_streaming.cu`
    (GHOST): the pair pass and the assembly; for CPU tensors or backend
    'torch' the plain version."""
    if resolve_backend(backend, ghost) == "torch":
        return streaming_ghost_forces_plain(ghost, config, model, uniform_params, compute_energy, coulomb, excl, box)
    global LAUNCHES
    mol = coulomb is not None or excl is not None
    if mol and uniform_params is not None:
        raise ValueError("the molecular ghost pass reads per-atom parameters: pass uniform_params=None")
    sz, sy, sx = shards
    gz, gy, gx, c = ghost.shape[-4:]
    mz, my, mx = gz - 2, gy - 2, gx - 2
    nfield = (3 if uniform_params is not None else 5) + (coulomb is not None) + (excl is not None)
    dev = ghost.device
    _check(ghost, "ghost", torch.float32, (nfield, sz, sy, sx, gz, gy, gx, config.capacity), dev)
    local = (sz, sy, sx, mz, my, mx, c)
    ids = mlj = mcs = None
    ne = 0
    if excl is not None:
        ids, mlj, mcs, ne = _tag_operands(excl, coulomb is not None, local, dev)
    _check_ghost_geometry(config, mx, compute_energy, mol, ne)
    nr = 5 if compute_energy else 3
    n_sh = sz * sy * sx
    out = torch.empty((nr, n_sh * mz * my * mx * c), dtype=torch.float32, device=dev)
    react = torch.empty((nr,) + tuple(ghost.shape[1:]), dtype=torch.float32, device=dev)
    params = (None, None) if uniform_params is not None else (ghost[3].data_ptr(), ghost[4].data_ptr())
    geometry = (mz, my, mx, n_sh, sy, sx, *base, config.cells_per_dim, c,
                box_ptr(config.box if box is None else box, ghost))
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = build.load()
    xyz = (ghost[0].data_ptr(), ghost[1].data_ptr(), ghost[2].data_ptr())
    if mol:
        scratch = torch.empty(ghost_mol_scratch_bytes(n_sh, (mz, my, mx), c, compute_energy) // 4,
                              dtype=torch.float32, device=dev)
        q = ghost[5] if coulomb is not None else None
        aid = ghost[-1] if excl is not None else None
        consts = (None,) * 6 if coulomb is None else _dsf_operands(coulomb, dev)
        err = lib.emdee_streaming_ghost_mol(
            *xyz, *params, _ptr(q), _ptr(aid), _ptr(ids), _ptr(mlj), _ptr(mcs), ne, *map(_ptr, consts),
            scratch.data_ptr(), *geometry, *_pair_consts(config, None)[:8], int(coulomb is not None),
            int(excl is not None), int(compute_energy), stream,
        )
        build.check(err, "cell_forces_streaming kernel (ghost grid, molecular)")
        LAUNCHES += 1
        err = lib.emdee_streaming_ghost_assemble_mol(out.data_ptr(), scratch.data_ptr(), react.data_ptr(), mz, my, mx,
                                                     n_sh, c, int(compute_energy), stream)
        build.check(err, "cell_forces_streaming assembly (ghost grid, molecular)")
    else:
        groups = torch.empty((_ROW_GROUPS + 1, nr, n_sh * mz * my, gx * c), dtype=torch.float32, device=dev)
        err = lib.emdee_streaming_ghost(
            *xyz, *params, out.data_ptr(), groups.data_ptr(), *geometry, *_pair_consts(config, uniform_params),
            int(uniform_params is not None), int(compute_energy), stream,
        )
        build.check(err, "cell_forces_streaming kernel (ghost grid)")
        LAUNCHES += 1
        err = lib.emdee_streaming_ghost_assemble(out.data_ptr(), groups.data_ptr(), react.data_ptr(), mz, my, mx,
                                                 n_sh, c, int(compute_energy), stream)
        build.check(err, "cell_forces_streaming assembly (ghost grid)")
    LAUNCHES += 1
    f = out[:3].reshape((3,) + local)
    if compute_energy:
        return f, react, out[3].reshape(local), out[4].reshape(local)
    return f, react, None, None


def streaming_ghost_forces_plain(ghost, config: CellDenseConfig, model: LennardJonesModel, uniform_params,
                                 compute_energy: bool, coulomb=None, excl=None, box=None):
    """The plain version of `streaming_ghost_forces`: the half shell over
    the ghost grids, the structure of the reference's `_local_forces_xla`
    (grid_sharded.py:770-894).  The self cell adds every ordered pair to
    its centres; each half-shell offset o adds its pairs to the own centres
    and their Newton reactions to the ghost cell at +o of the reaction grid
    (no reaction tile at −o); last, the reactions that landed on own slots
    join the forces, as the kernel's assembly adds them, and only the ghost
    slots of the grid stay.  Displacements are d − L·round(d/L) of the raw
    ghost coordinates; with `excl`, the own centre's tags are matched
    against the neighbour's atom id."""
    t = ghost_tiles(ghost, config, model, uniform_params, compute_energy, coulomb, excl, box)
    mol, side, opt = t.mol, t.side, t.opt
    gz, gy, gx, c = ghost.shape[-4:]
    mz, my, mx = gz - 2, gy - 2, gx - 2
    nr = 5 if compute_energy else 3
    react = ghost.new_zeros((t.cells // (mz * my * mx), gz, gy, gx, c, nr))
    forces, energies, virials = t.forces, t.energies, t.virials
    for dz, dy, dx in _HALF_SHELL:
        nbr = lambda a: t.block(a, (dx, dy, dz))  # noqa: E731, B023
        dv = t.disp(t.pos[:, :, None, :], nbr(t.pos_g)[:, None, :, :])
        ok = t.valid[:, :, None] & nbr(t.valid_g)[:, None, :]
        r2s = torch.where(ok, t.r2_of(dv), 1.0)
        fwd = None if mol is None else side(opt(lambda a: nbr(a)[:, None, :], mol.q),  # noqa: B023
                                            opt(lambda a: nbr(a)[:, None, :], mol.aid))  # noqa: B023
        e, mre = t.pair_terms(r2s, ok, t.hs[:, :, None], t.tse[:, :, None], nbr(t.hs_g)[:, None, :],
                              nbr(t.tse_g)[:, None, :], t.cen_own, fwd)
        gdv = torch.where(ok, mre / r2s, 0.0)[..., None] * dv
        forces = forces + torch.sum(gdv, dim=2)
        parts = [-torch.sum(gdv, dim=1)]  # (cells, C, 3): the reactions on the neighbour's slots
        if compute_energy:
            energies = energies + 0.5 * torch.sum(e, dim=2)
            virials = virials + 0.5 * torch.sum(mre, dim=2)
            parts += [0.5 * torch.sum(e, dim=1)[..., None], 0.5 * torch.sum(mre, dim=1)[..., None]]
        rows = torch.cat(parts, dim=-1).reshape((-1, mz, my, mx, c, nr))
        react[:, 1 + dz : 1 + dz + mz, 1 + dy : 1 + dy + my, 1 + dx : 1 + dx + mx] += rows
    # The reactions on own slots join the centre sums, as the kernel's assembly adds them.
    inner = react[:, 1 : mz + 1, 1 : my + 1, 1 : mx + 1].reshape((-1, c, nr))
    forces = (forces + inner[..., :3]).reshape(t.shape + (3,)).movedim(-1, 0)
    if compute_energy:
        energies, virials = energies + inner[..., 3], virials + inner[..., 4]
    react[:, 1 : mz + 1, 1 : my + 1, 1 : mx + 1] = 0.0
    react = react.movedim(-1, 0).reshape((nr,) + tuple(ghost.shape[1:]))
    if compute_energy:
        return forces, react, energies.reshape(t.shape), virials.reshape(t.shape)
    return forces, react, None, None
