"""Dense-cell force pass: the CUDA kernel and its plain version —
counterpart of emdee_tpu/neighbors/pallas_cell_kernel.py.

`cell_forces` (counterpart of `pallas_cell_forces`) takes the stacked
state: per-atom or uniform parameters, optional per-slot energies and
virials, and with `coulomb=`/`excl=` the molecular terms (K2c: DSF
Coulomb over the state's charges, exclusion tags, tag-borne bonds).
`cell_forces_split` (counterpart of `pallas_cell_forces_split`) takes
(M³, C) component arrays, uniform parameters, forces only.  Both
launch one kernel of `csrc/cell_forces.cu` for CUDA tensors, with
backend 'auto' or 'cuda', and run the plain version
(`cell_dense.cell_dense_forces`) for CPU tensors or backend 'torch'.
The LJ pass (K2a, K2b, K3's grid side through `launch_strag`, and the
grid's per-shard pass K2-G through `ghost_forces`) and K2c (and the grid's
molecular pass K2c-G) run on one design: a warp takes 32 live centres of
a cell and stages each neighbour cell's slots within the cutoff of its
centres' bounding box (`k2c_cull` mirrors the predicate); the LJ pass runs
the pair term on the staged slots straight away, K2c lists each lane's
pairs inside the cutoff first and runs its costlier term over the lists.
Both add every centre's pairs in the full-shell order — neighbour cells in
(dz, dy, dx) order, z outermost, each cell's slots in slot order — so the
GHOST modes K2-G and K2c-G, which walk the ghost grids with a per-warp
neighbour table (`ghost_lj_table`), equal the one-card passes bit for bit
on any decomposition.

The TPU kernel's ghost grid, far sentinels, MXU segment sums and reaction
folds (`_ghost`, `_prep_inputs`, `_fold_ghosts`, `_const_tiles`,
`_sentinel_far`) exist because of VMEM and the MXU and have no counterpart
here: the CUDA kernel walks the full shell, takes ±box off a wrapped
neighbor's raw difference itself and masks empty slots.  The streaming
family (`streaming_kernel.py`) shares this module's operand checks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from emdee_tpu_torch.csrc import build
from emdee_tpu_torch.neighbors.cell_dense import (
    CellDenseConfig,
    CellDenseState,
    _box_of,
    _dense_forces,
    box_ptr,
    cell_dense_forces,
    resolve_backend,
)
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel, pair_interaction

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0
# The most exclusion tags per slot that the molecular kernels hold (kMaxTags
# of csrc/lj_pair.cuh, in shared memory).
MAX_TAGS = 8
_MOL_WARPS = 4  # K2c, K2c-G: warps a block, each owning 32 live centres of a cell
# K2a/K2b/K3 (`cell_lj_kernel`): warps a block, and the resident blocks an
# SM that its launch bounds ask for (so its registers allow).
LJ_WARPS, LJ_MIN_BLOCKS = 4, 8
_SM_SMEM_BYTES = 233_472  # shared memory of an SM on Hopper (1,024 reserved a block)
_SM_WARPS = 64  # resident warps an SM
_SMEM_BYTES = 232_448  # shared memory a block can use on Hopper
CULL_SLACK = 2.0**-19  # the cull's slack, as csrc/lj_pair.cuh `kCullSlack`


def cull_keep(p, lo, hi, shift, cut2: float):
    """The cull's predicate (`near_box` of csrc/lj_pair.cuh), as K2c, K5c
    and K5s-mol evaluate it in float32 (for the tests): whether each point p
    (..., 3) lies within the cutoff of the box [lo + shift, hi + shift]
    (each (3,)), every axis' gap lowered by CULL_SLACK of the magnitudes in
    play, so that no pair inside cut2 is dropped."""
    f32 = torch.float32
    p, lo, hi, shift = (torch.as_tensor(t, dtype=f32) for t in (p, lo, hi, shift))
    gap = torch.clamp(torch.maximum((lo + shift) - p, p - (hi + shift)), min=0.0)
    slack = torch.tensor(CULL_SLACK, dtype=f32) * (p.abs() + lo.abs() + hi.abs() + 2.0 * shift.abs())
    g = torch.clamp(gap - slack, min=0.0)
    g2 = g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2]
    return g2 < torch.tensor(cut2, dtype=f32)


def k2c_cull(cen, nb, shift, cut2: float):
    """K2c's cull of one neighbour cell for one warp, which the LJ pass
    (K2a/K2b/K3) applies at rc² (for the tests): the neighbour points nb
    (k, 3) kept within the cutoff of the box of the warp's centres cen
    (n, 3), shifted back by the cell's periodic shift (displacements are
    (x_i − x_j) − shift)."""
    return cull_keep(nb, cen.min(0).values, cen.max(0).values, -torch.as_tensor(shift), cut2)


_STAGE = 256  # K2c: the most neighbour slots a warp stages at once


def mol_smem_bytes(c: int, ne: int, neb: int, ghost: bool = False) -> int:
    """K2c's (`ghost`: K2c-G's) shared memory a block, as its C entries
    count it: for each of its 4 warps, the staged neighbour tile (C rounded
    up to a warp, at most 256: x, y, z, σ/2, 2√ε, q, atom id, slot), each
    lane's list (a byte an entry), the centres' tags (three values a tag and
    a bond tag, 32 lanes) and the rank-to-slot map; K2c-G adds the 27
    neighbours' periodic shifts and first slots."""
    nt = min(32 * -(-c // 32), _STAGE)
    return 4 * _MOL_WARPS * (8 * nt + 8 * nt + 3 * (ne + neb) * 32 + 32 + (4 * 27 if ghost else 0))


def lj_smem_bytes() -> int:
    """The LJ pass's shared memory a block, as its C entry counts it
    (`kLjSmemBytes`): for each of its warps, the staged chunk (x, y, z,
    σ/2, 2√ε and slot of up to 32 entries), the 27 neighbours' periodic
    shifts and first slots, and the rank-to-slot map.  The same at every C,
    M and Kn: a cell is staged 32 slots at a time, the aux atoms too."""
    return 4 * LJ_WARPS * (6 * 32 + 4 * 27 + 32)


def lj_launch_shape(config: CellDenseConfig) -> dict:
    """The LJ pass's launch at `config`, reckoned on the host: its warps (a
    warp 32 live centres of a cell), blocks, shared bytes a block, the
    resident blocks an SM that shared memory and the warp slots allow (the
    registers allow LJ_MIN_BLOCKS by the launch bounds), and the waves of
    warps over the card's 132 SMs at LJ_MIN_BLOCKS blocks an SM."""
    warps = config.cells_per_dim**3 * -(-config.capacity // 32)
    smem = lj_smem_bytes()
    return {"warps": warps, "blocks": -(-warps // LJ_WARPS), "smem_bytes": smem,
            "blocks_per_sm_smem": _SM_SMEM_BYTES // (smem + 1024), "blocks_per_sm_warps": _SM_WARPS // LJ_WARPS,
            "waves": warps / (132 * LJ_WARPS * LJ_MIN_BLOCKS)}




def _pair_consts(config: CellDenseConfig, uniform_params) -> Tuple[float, ...]:
    """rc², rs², 1/(rc²−rs²), the Horner constants of the switched −r·dE/dr,
    and the uniform σ², 4ε — formed in float64 as the TPU kernel forms
    them, and rounded to float32 at the C boundary."""
    rs2 = float(config.switch) ** 2
    rc2 = float(config.cutoff) ** 2
    invd2 = 1.0 / (rc2 - rs2)
    a_m = 60.0 * invd2 * rs2
    sig2_u = eps4_u = 0.0
    if uniform_params is not None:
        hs_u, tse_u = uniform_params
        sig2_u = float((2.0 * hs_u) ** 2)
        eps4_u = float(tse_u * tse_u)
    return (rc2, rs2, invd2, a_m, a_m + 60.0, 60.0 + 2.0 * a_m, a_m - 30.0,
            2.0 * a_m, sig2_u, eps4_u)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(px, py, pz, pstride, hs, tse, valid, fx, fy, fz, fstride, e, w,
            config: CellDenseConfig, box, uniform_params, energy: bool):
    """One kernel launch; `box` is a number or a 0-d float32 tensor on the
    device, read there either way (`cell_dense.box_ptr`)."""
    global LAUNCHES
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(px.device).cuda_stream
    err = build.load().emdee_cell_forces(
        ptr(px), ptr(py), ptr(pz), pstride, ptr(hs), ptr(tse), ptr(valid),
        ptr(fx), ptr(fy), ptr(fz), fstride, ptr(e), ptr(w),
        config.cells_per_dim, config.capacity, box_ptr(box, px),
        *_pair_consts(config, uniform_params),
        int(uniform_params is not None), int(energy), stream,
    )
    build.check(err, "cell_forces kernel")
    LAUNCHES += 1


def launch_strag(px, py, pz, valid, ax, ay, az, table, out,
                 config: CellDenseConfig, uniform_params) -> None:
    """One launch of the LJ pass's STRAG variant on CUDA tensors (the grid
    side of the straggler pass, K3): the split pass of `cell_forces_split`
    plus, for every center slot, the ≤ Kn aux atoms that `table` (M², Kn)
    lists for its pencil row, added after its grid pairs in list order.
    Writes out[0..2] (M³, C); the caller
    (`straggler_kernel.straggler_forces`) checks the inputs."""
    global LAUNCHES
    stream = torch.cuda.current_stream(px.device).cuda_stream
    err = build.load().emdee_cell_forces_strag(
        px.data_ptr(), py.data_ptr(), pz.data_ptr(), valid.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        ax.data_ptr(), ay.data_ptr(), az.data_ptr(), table.data_ptr(), table.shape[1],
        config.cells_per_dim, config.capacity, box_ptr(config.box, px),
        *_pair_consts(config, uniform_params), stream,
    )
    build.check(err, "cell_forces kernel (straggler tile)")
    LAUNCHES += 1


def cell_forces(
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
    (slot-space tags (ids, mlj, mcs[, (kb, kr0, kr02)]), contiguous, as
    `cell_dense_molecular.make_exclusion_aux_fn` builds them) select the
    molecular kernel (K2c), which reads the per-atom parameters; the plain
    version is `cell_dense_forces(state, model, config, coulomb, excl)`."""
    if resolve_backend(backend, state.positions) == "torch":
        return cell_dense_forces(state, model, config, coulomb, excl, compute_energy=compute_energy)
    if coulomb is not None or excl is not None:
        return _launch_mol(state, config, coulomb, excl, compute_energy)
    operands, outputs = stacked_operands(state, config, uniform_params, compute_energy)
    _launch(*operands, config, _box_of(state, config), uniform_params, compute_energy)
    return outputs


def mol_operands(state: CellDenseState, config: CellDenseConfig, coulomb, excl):
    """Check the molecular operands of a stacked state for K2c or K5c:
    returns (q, aid, ids, mlj, mcs, kb, kr0, kr02, ne, neb, *DSF constants)
    for the C entries, each tensor None where the flags leave it out."""
    nc, c = config.num_cells, config.capacity
    dev = state.positions.device
    q = aid = ids = mlj = mcs = bond = None
    consts = (None,) * 6
    ne = neb = 0
    if coulomb is not None:
        if state.charges is None:
            raise ValueError("coulomb model given but state has no charges")
        q = state.charges
        _check(q, "charges", torch.float32, (nc, c), dev)
        consts = _dsf_operands(coulomb, dev)
    if excl is not None:
        aid = state.atom_id
        _check(aid, "atom_id", torch.int32, (nc, c), dev)
        ids, mlj, mcs, ne = _tag_operands(excl, coulomb is not None, (nc, c), dev)
        bond = excl[3] if len(excl) > 3 else None
        if bond is not None:
            neb = bond[0].shape[-1]
            for name, t in zip(("kb", "kr0", "kr02"), bond):
                _check(t, f"bond {name}", torch.float32, (nc, c, neb), dev)
    kb, kr0, kr02 = bond or (None, None, None)
    return (q, aid, ids, mlj, mcs, kb, kr0, kr02, ne, neb) + tuple(consts)


def _dsf_operands(coulomb, dev):
    """The DSF model's six constants, each checked to be a 0-d float32
    tensor on `dev` (the kernels read them there)."""
    consts = (coulomb.alpha, coulomb.rc, coulomb.rc2, coulomb.e_shift, coulomb.f_shift, coulomb.kc)
    for name, t in zip(("alpha", "rc", "rc2", "e_shift", "f_shift", "kc"), consts):
        _check(t, f"coulomb.{name}", torch.float32, (), dev)
    return consts


def _tag_operands(excl, coulomb: bool, slots, dev):
    """Check a kernel's centre tags (ids, mlj, mcs), each (…slots, E)
    float32 with E ≤ MAX_TAGS; missing Coulomb scales with `coulomb` are
    the LJ scales.  Returns (ids, mlj, mcs, E)."""
    ids, mlj, mcs = excl[:3]
    if coulomb and mcs is None:
        mcs = mlj
    ne = ids.shape[-1]
    if ne > MAX_TAGS:
        raise ValueError(
            f"{ne} exclusion tags per slot; the molecular kernels hold at most {MAX_TAGS}: build the tags "
            f"with exclusion_band={MAX_TAGS} or less and correct the rest in slot space "
            "(make_molecular_dense_sim does so on the kernel backends)")
    for name, t in (("ids", ids), ("mlj", mlj), ("mcs", mcs)):
        if t is not None:
            _check(t, f"excl {name}", torch.float32, tuple(slots) + (ne,), dev)
    return ids, mlj, mcs, ne


def _launch_mol(state: CellDenseState, config: CellDenseConfig, coulomb, excl, compute_energy: bool):
    """One launch of the molecular kernel (K2c) on a CUDA state."""
    global LAUNCHES
    operands, (forces, e, w) = stacked_operands(state, config, None, compute_energy)
    pos, hs, tse, valid = operands[0], operands[4], operands[5], operands[6]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    q, aid, ids, mlj, mcs, kb, kr0, kr02, ne, neb, *consts = mol_operands(state, config, coulomb, excl)
    err = build.load().emdee_cell_forces_mol(
        pos.data_ptr(), ptr(hs), ptr(tse), valid.data_ptr(), ptr(q), ptr(aid), ptr(ids), ptr(mlj),
        ptr(mcs), ptr(kb), ptr(kr0), ptr(kr02), ne, neb, *map(ptr, consts), forces.data_ptr(), ptr(e),
        ptr(w), config.cells_per_dim, config.capacity, box_ptr(_box_of(state, config), pos),
        *_pair_consts(config, None)[:8], int(coulomb is not None), int(excl is not None), int(kb is not None),
        int(compute_energy), torch.cuda.current_stream(pos.device).cuda_stream,
    )
    build.check(err, "cell_forces kernel (molecular)")
    LAUNCHES += 1
    return forces, e, w


def resources(entry: str, what: str, *args, warps: int = _MOL_WARPS) -> dict:
    """A kernel variant's resources, as the card reports them through the C
    query `entry` (`cudaFuncGetAttributes`,
    `cudaOccupancyMaxActiveBlocksPerMultiprocessor`): registers and local
    (spill) bytes a thread, shared bytes and warps a block, resident blocks
    an SM.  Launches nothing."""
    import ctypes

    out = (ctypes.c_int * 4)()
    err = getattr(build.load(), entry)(*args, ctypes.addressof(out))
    build.check(err, f"{what} resource query")
    return {"registers": out[0], "local_bytes": out[1], "smem_bytes": out[2], "warps_per_block": warps,
            "blocks_per_sm": out[3]}


def tag_counts(excl):
    """(E, E_b, bond weights or None) of slot tags as the kernels take them."""
    ne = 0 if excl is None else excl[0].shape[-1]
    bond = None if excl is None or len(excl) < 4 else excl[3]
    return ne, 0 if bond is None else bond[0].shape[-1], bond


def k2c_resources(config: CellDenseConfig, coulomb, excl, compute_energy: bool, ghost: bool = False) -> dict:
    """The K2c variant that these flags and tags (`excl`, as `cell_forces`
    takes them; with `ghost`, K2c-G's, as `ghost_forces` takes them, no
    bond tags) select at C, as the card reports it (`resources`)."""
    ne, neb, bond = tag_counts(excl)
    flags = (int(coulomb is not None), int(excl is not None))
    if ghost:
        return resources("emdee_cell_forces_ghost_mol_attrs", "cell_forces (ghost grid, molecular)",
                         config.capacity, ne, *flags, int(compute_energy))
    return resources("emdee_cell_forces_mol_attrs", "cell_forces (molecular)", config.capacity, ne, neb, *flags,
                     int(bond is not None), int(compute_energy))


def lj_resources(uniform: bool, energy: bool, strag: bool = False, ghost: bool = False) -> dict:
    """The LJ pass's variant (K2a: uniform; K2b: per-atom, with or without
    energies; K3's grid side: `strag`; K2-G, the grid's: `ghost`) as the
    card reports it (`resources`)."""
    return resources("emdee_cell_forces_attrs", "cell_forces", int(uniform), int(energy), int(strag), int(ghost),
                     warps=LJ_WARPS)


def stacked_operands(state: CellDenseState, config: CellDenseConfig, uniform_params, compute_energy: bool):
    """Check a stacked state for a force kernel and allocate its outputs:
    returns (launch operands px … w, (forces (M³, C, 3), e, w))."""
    nc, c = config.num_cells, config.capacity
    dev = state.positions.device
    pos = state.positions
    _check(pos, "positions", torch.float32, (nc, c, 3), dev)
    _check(state.valid, "valid", torch.bool, (nc, c), dev)
    hs = tse = None
    if uniform_params is None:
        hs, tse = state.half_sigma, state.twice_sqrt_eps
        _check(hs, "half_sigma", torch.float32, (nc, c), dev)
        _check(tse, "twice_sqrt_eps", torch.float32, (nc, c), dev)
    forces = torch.empty((nc, c, 3), dtype=torch.float32, device=dev)
    e = w = None
    if compute_energy:
        e = torch.empty((nc, c), dtype=torch.float32, device=dev)
        w = torch.empty((nc, c), dtype=torch.float32, device=dev)
    px = pos.view(-1)
    fv = forces.view(-1)
    operands = (px, px[1:], px[2:], 3, hs, tse, state.valid, fv, fv[1:], fv[2:], 3, e, w)
    return operands, (forces, e, w)


def cell_forces_split(
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


def split_plain(px, py, pz, valid, config: CellDenseConfig, uniform_params, box):
    """The plain version of the split entries: the half-shell `_dense_forces`
    with the uniform parameters filled in."""
    hs = torch.full_like(px, uniform_params[0])
    tse = torch.full_like(px, uniform_params[1])
    model = LennardJonesModel.create(config.cutoff, config.switch, device=px.device)
    f, _, _ = _dense_forces(torch.stack([px, py, pz], dim=-1), hs, tse, valid, model, config, box, False)
    return f[..., 0], f[..., 1], f[..., 2]


def split_operands(px, py, pz, valid, config: CellDenseConfig):
    """Check component arrays for a force kernel and allocate its outputs:
    returns (launch operands px … w, (fx, fy, fz))."""
    shape = (config.num_cells, config.capacity)
    dev = px.device
    for name, t in (("px", px), ("py", py), ("pz", pz)):
        _check(t, name, torch.float32, shape, dev)
    _check(valid, "valid", torch.bool, shape, dev)
    fx, fy, fz = (torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(3))
    return (px, py, pz, 1, None, None, valid, fx, fy, fz, 1, None, None), (fx, fy, fz)


def ghost_lj_table(cell: int, shards, base, local, m: int, box: float):
    """K2-G's and K2c-G's per-warp table for own cell `cell` (for the
    tests; the C source's `tnb`, `tsh`): the own cell's index in the stacked
    ghost grids,
    and for each neighbour code (dz + 1)·9 + (dy + 1)·3 + dx + 1 the
    neighbour's ghost cell index (its first slot is that times C) and the
    shift (x, y, z) the kernel takes off (x_i − x_j), ±box where the
    neighbour's GLOBAL cell index leaves [0, M).  `cell` indexes the own
    cells of the local shards (sz, sy, sx) of `local` = (mz, my, mx) cells,
    shard-major; the shards' global coordinates start at `base` (z, y, x)."""
    mz, my, mx = local
    sy, sx = shards[1], shards[2]
    lx, ly, lz, s = cell % mx, (cell // mx) % my, (cell // (mx * my)) % mz, cell // (mx * my * mz)
    cx = (base[2] + s % sx) * mx + lx
    cy = (base[1] + (s // sx) % sy) * my + ly
    cz = (base[0] + s // (sx * sy)) * mz + lz
    gy, gx = my + 2, mx + 2
    home = s * (mz + 2) * gy * gx + ((lz + 1) * gy + ly + 1) * gx + lx + 1
    first, shift = [], []
    for code in range(27):
        dz, dy, dx = code // 9 - 1, (code // 3) % 3 - 1, code % 3 - 1
        first.append(home + (dz * gy + dy) * gx + dx)
        shift.append([-box if w < 0 else (box if w >= m else 0.0) for w in (cx + dx, cy + dy, cz + dz)])
    return home, first, shift


def ghost_forces(ghost, shards, base, config: CellDenseConfig, model: LennardJonesModel, *,
                 uniform_params=None, compute_energy: bool = False, backend: str = "auto", coulomb=None,
                 excl=None, box=None):
    """The grid-sharded engine's per-shard force pass (the LJ pass's GHOST
    mode, K2-G; with the molecular terms K2c-G): forces (3, sz, sy, sx,
    mz, my, mx, C) of every own slot of the
    local shards and, with `compute_energy`, per-slot half-split energies and
    virials (sz, sy, sx, mz, my, mx, C) — else None, None.

    ghost: (F, sz, sy, sx, mz+2, my+2, mx+2, C) float32, each local shard's
    ghost grid: positions x, y, z with NaN in empty slots, then, without
    uniform parameters, σ/2 and 2√ε; with `coulomb`, the charges; with
    `excl`, the int32 atom ids (−2 on empty slots) as a float32 bit view.
    shards: (sz, sy, sx), the local shards' grid; base: the global shard
    coordinates (z, y, x) of its first shard, so that the kernel takes each
    periodic shift from a neighbour's global cell index.  box: a number or
    a 0-d float32 tensor on the device (the NPT engine's dynamic box), or
    None for config.box.

    coulomb (a `DSFCoulomb` model) and excl (the own slots' centre tags
    (ids, mlj, mcs), each (sz, sy, sx, mz, my, mx, C, E) contiguous, E ≤
    MAX_TAGS; no bond tags) select the molecular branches (K2c-G), which
    read the per-atom parameters."""
    if resolve_backend(backend, ghost) == "torch":
        return ghost_forces_plain(ghost, config, model, uniform_params, compute_energy, coulomb, excl, box)
    global LAUNCHES
    mol = coulomb is not None or excl is not None
    if mol and uniform_params is not None:
        raise ValueError("the molecular ghost pass reads per-atom parameters: pass uniform_params=None")
    sz, sy, sx = shards
    gz, gy, gx, c = ghost.shape[-4:]
    nfield = (3 if uniform_params is not None else 5) + (coulomb is not None) + (excl is not None)
    dev = ghost.device
    _check(ghost, "ghost", torch.float32, (nfield, sz, sy, sx, gz, gy, gx, config.capacity), dev)
    local = (sz, sy, sx, gz - 2, gy - 2, gx - 2, c)
    f = torch.empty((3,) + local, dtype=torch.float32, device=dev)
    e = w = None
    if compute_energy:
        e = torch.empty(local, dtype=torch.float32, device=dev)
        w = torch.empty(local, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    params = (ghost[3], ghost[4]) if uniform_params is None else (None, None)
    geometry = (gz - 2, gy - 2, gx - 2, sz * sy * sx, sy, sx, *base, config.cells_per_dim, c,
                box_ptr(config.box if box is None else box, ghost))
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if not mol:
        err = lib.emdee_cell_forces_ghost(
            ghost[0].data_ptr(), ghost[1].data_ptr(), ghost[2].data_ptr(), *map(ptr, params),
            f[0].data_ptr(), f[1].data_ptr(), f[2].data_ptr(), ptr(e), ptr(w), *geometry,
            *_pair_consts(config, uniform_params), int(uniform_params is not None), int(compute_energy), stream,
        )
        build.check(err, "cell_forces kernel (ghost grid)")
        LAUNCHES += 1
        return f, e, w
    q = ghost[5] if coulomb is not None else None
    aid = ghost[-1] if excl is not None else None
    consts = (None,) * 6 if coulomb is None else _dsf_operands(coulomb, dev)
    ids = mlj = mcs = None
    ne = 0
    if excl is not None:
        ids, mlj, mcs, ne = _tag_operands(excl, coulomb is not None, local, dev)
    err = lib.emdee_cell_forces_ghost_mol(
        ghost[0].data_ptr(), ghost[1].data_ptr(), ghost[2].data_ptr(), *map(ptr, params), ptr(q), ptr(aid),
        ptr(ids), ptr(mlj), ptr(mcs), ne, *map(ptr, consts), f[0].data_ptr(), f[1].data_ptr(), f[2].data_ptr(),
        ptr(e), ptr(w), *geometry, *_pair_consts(config, None)[:8], int(coulomb is not None),
        int(excl is not None), int(compute_energy), stream,
    )
    build.check(err, "cell_forces kernel (ghost grid, molecular)")
    LAUNCHES += 1
    return f, e, w


def ghost_tiles(ghost, config: CellDenseConfig, model: LennardJonesModel, uniform_params, compute_energy: bool,
                coulomb=None, excl=None, box=None):
    """The operands the plain ghost passes share (`ghost_forces_plain`,
    `streaming_kernel.streaming_ghost_forces_plain`), as a namespace: the
    ghost grids' fields flattened over the local shards (pos_g, hs_g, tse_g,
    valid_g, and `mol`), the own cells' (pos, hs, tse, valid, cen_own),
    `block(a, o, sign)` (the cell c + sign·o of every own cell, (cells, C,
    …)), `disp`, `r2_of`, `pair_terms`, `side` and the self-cell tile's sums
    (forces, energies, virials; the energy sums None without
    `compute_energy`).  The box: `box` (a number or a 0-d tensor) or
    config.box."""
    from types import SimpleNamespace

    from emdee_tpu_torch.neighbors.cell_dense import Molecular, _box, _molecular_terms

    t = SimpleNamespace(lead=tuple(ghost.shape[1:-4]))
    gz, gy, gx, c = ghost.shape[-4:]
    mz, my, mx = gz - 2, gy - 2, gx - 2
    t.shape = t.lead + (mz, my, mx, c)
    g = ghost.reshape((ghost.shape[0], -1) + tuple(ghost.shape[-4:]))
    t.valid_g = ~torch.isnan(g[0])
    t.pos_g = torch.where(t.valid_g[..., None], g[:3].movedim(0, -1), 0.0)
    if uniform_params is None:
        t.hs_g, t.tse_g = g[3], g[4]
    else:
        t.hs_g, t.tse_g = torch.full_like(g[0], uniform_params[0]), torch.full_like(g[0], uniform_params[1])
    box_t = _box(config.box if box is None else box, ghost)
    mol = None
    if coulomb is not None or excl is not None:
        q_g = g[5] if coulomb is not None else None
        aid_g = g[-1].contiguous().view(torch.int32).to(torch.float32) if excl is not None else None
        tags = None
        if excl is not None:
            ids, mlj, mcs = excl[:3]
            if coulomb is not None and mcs is None:
                mcs = mlj
            flat = lambda a: None if a is None else a.reshape((-1, c, a.shape[-1]))  # noqa: E731
            tags = (flat(ids), flat(mlj), flat(mcs), None)
        mol = Molecular(q_g, coulomb, aid_g, tags)
    t.mol = mol

    def block(a, o, sign=1):
        """Cell c + sign·o of every own cell c, as (cells, C, …); o = (ox, oy, oz)."""
        dx, dy, dz = (sign * int(v) for v in o)
        sub = a[:, 1 + dz : 1 + dz + mz, 1 + dy : 1 + dy + my, 1 + dx : 1 + dx + mx]
        return sub.reshape((-1, c) + tuple(a.shape[5:]))

    def disp(a, b):
        d = a - b
        return d - torch.round(d / box_t) * box_t

    def r2_of(dv):
        return dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1] + dv[..., 2] * dv[..., 2]

    def pair_terms(r2s, ok, hs_i, tse_i, hs_j, tse_j, cen=None, nbr=None):
        e, mre = pair_interaction(r2s, model, hs_i, tse_i, hs_j, tse_j)
        if mol is not None:
            e, mre = _molecular_terms(r2s, e, mre, model, mol, cen, nbr)
        return torch.where(ok, e, 0.0), torch.where(ok, mre, 0.0)

    def side(q, aid, tags=None):
        """The molecular operands of one side of a tile, as `_molecular_terms` takes them."""
        if mol is None:
            return None
        return {"q": q, "aid": aid, "excl": tags}

    opt = lambda f, a: None if a is None else f(a)  # noqa: E731
    zero = (0, 0, 0)
    t.pos, t.hs, t.tse, t.valid = (block(a, zero) for a in (t.pos_g, t.hs_g, t.tse_g, t.valid_g))
    t.cells = t.pos.shape[0]
    if mol is not None:
        t.q_own, t.aid_own = opt(lambda a: block(a, zero), mol.q), opt(lambda a: block(a, zero), mol.aid)
        tags_own = None if mol.excl is None else tuple(opt(lambda a: a[:, :, None, :], a) for a in mol.excl)
        t.cen_own = side(opt(lambda a: a[:, :, None], t.q_own), None, tags_own)
    else:
        t.q_own = t.aid_own = t.cen_own = None
    t.block, t.disp, t.r2_of, t.pair_terms, t.side, t.opt = block, disp, r2_of, pair_terms, side, opt

    # ---- self-cell tile, as in `_dense_forces` ----
    pos, valid = t.pos, t.valid
    dv = disp(pos[:, :, None, :], pos[:, None, :, :])
    eye = torch.eye(c, dtype=torch.bool, device=pos.device)
    ok = valid[:, :, None] & valid[:, None, :] & ~eye[None]
    r2s = torch.where(ok, r2_of(dv), 1.0)
    e, mre = pair_terms(r2s, ok, t.hs[:, :, None], t.tse[:, :, None], t.hs[:, None, :], t.tse[:, None, :], t.cen_own,
                        side(opt(lambda a: a[:, None, :], t.q_own), opt(lambda a: a[:, None, :], t.aid_own)))
    t.forces = torch.sum((mre / r2s)[..., None] * dv, dim=2)
    t.energies = 0.5 * torch.sum(e, dim=2) if compute_energy else None
    t.virials = 0.5 * torch.sum(mre, dim=2) if compute_energy else None
    return t


def ghost_forces_plain(ghost, config: CellDenseConfig, model: LennardJonesModel, uniform_params,
                       compute_energy: bool, coulomb=None, excl=None, box=None):
    """The plain version of `ghost_forces`: `_dense_forces` on the ghost
    grids, with every roll of the slot grid replaced by a block of the ghost
    grid.  A half-shell offset's neighbour block is the ghost block at +o,
    and its Newton reaction onto a cell is evaluated where `_dense_forces`
    evaluates it — the pairs of the cell at −o (a ghost block) against the
    cell — in a tile of the same shape, so every pair term and every sum is
    the one-card plain version's, bit for bit, whatever the decomposition.
    Displacements are d − L·round(d/L) of the raw ghost coordinates.

    With `excl`, the reaction tile matches the own cell's tags against the
    ghost centre's atom id, where `_dense_forces` matches the centre's tags
    against the own atom id: the tables are symmetric, so the scale is the
    same number, and the ghost grids need not carry tags."""
    from emdee_tpu_torch.neighbors.cell_dense import _GROUP, _OFFSETS

    t = ghost_tiles(ghost, config, model, uniform_params, compute_energy, coulomb, excl, box)
    mol, block, disp, r2_of, side, opt = t.mol, t.block, t.disp, t.r2_of, t.side, t.opt
    pos, hs, tse, valid, cells = t.pos, t.hs, t.tse, t.valid, t.cells
    c = ghost.shape[-1]
    forces, energies, virials = t.forces, t.energies, t.virials

    for g0 in range(0, len(_OFFSETS), _GROUP):
        offs = _OFFSETS[g0 : g0 + _GROUP]
        k = len(offs)
        # Forward tile: own centres against the cells at +o.
        nbr = lambda a: torch.cat([block(a, o) for o in offs], dim=1)  # noqa: E731
        nbr_pos, nbr_hs, nbr_tse, nbr_valid = nbr(t.pos_g), nbr(t.hs_g), nbr(t.tse_g), nbr(t.valid_g)
        dv = disp(pos[:, :, None, :], nbr_pos[:, None, :, :])
        ok = valid[:, :, None] & nbr_valid[:, None, :]
        r2s = torch.where(ok, r2_of(dv), 1.0)
        fwd = None if mol is None else side(opt(lambda a: nbr(a)[:, None, :], mol.q),
                                            opt(lambda a: nbr(a)[:, None, :], mol.aid))
        e, mre = t.pair_terms(r2s, ok, hs[:, :, None], tse[:, :, None], nbr_hs[:, None, :], nbr_tse[:, None, :],
                              t.cen_own, fwd)
        gdv = torch.where(ok, mre / r2s, 0.0)[..., None] * dv
        forces = forces + torch.sum(gdv, dim=2)
        if compute_energy:
            energies = energies + 0.5 * torch.sum(e, dim=2)
            virials = virials + 0.5 * torch.sum(mre, dim=2)

        # Reaction tile: the cells at −o (centres i) against the own cell (j),
        # laid out [cell, i, slot·C + j] like the forward tile of the cell at −o.
        def centres(a):
            r = torch.stack([block(a, o, -1) for o in offs], dim=2)  # (cells, C, k, …)
            rest = tuple(r.shape[3:])
            return r[:, :, :, None].expand((cells, c, k, c) + rest).reshape((cells, c, k * c) + rest)

        def owns(a):
            rest = tuple(a.shape[2:])
            return a[:, None, None].expand((cells, c, k, c) + rest).reshape((cells, c, k * c) + rest)

        dv = disp(centres(t.pos_g), owns(pos))
        ok = centres(t.valid_g) & owns(valid)
        r2s = torch.where(ok, r2_of(dv), 1.0)
        cen_r = nbr_r = None
        if mol is not None:
            # The centre's charge; the own cell's tags against the centre's atom id.
            tags_r = None if mol.excl is None else tuple(opt(owns, a) for a in mol.excl)
            cen_r = side(opt(centres, mol.q), None, tags_r)
            nbr_r = side(opt(owns, t.q_own), opt(centres, mol.aid))
        e, mre = t.pair_terms(r2s, ok, centres(t.hs_g), centres(t.tse_g), owns(hs), owns(tse), cen_r, nbr_r)
        gdv = torch.where(ok, mre / r2s, 0.0)[..., None] * dv
        reaction = -torch.sum(gdv, dim=1)  # (cells, k·C, 3)
        for i in range(k):
            forces = forces + reaction[:, i * c : (i + 1) * c]
        if compute_energy:
            e_r = 0.5 * torch.sum(e, dim=1)
            w_r = 0.5 * torch.sum(mre, dim=1)
            for i in range(k):
                energies = energies + e_r[:, i * c : (i + 1) * c]
                virials = virials + w_r[:, i * c : (i + 1) * c]

    forces = forces.reshape(t.shape + (3,)).movedim(-1, 0)
    if compute_energy:
        return forces, energies.reshape(t.shape), virials.reshape(t.shape)
    return forces, None, None
