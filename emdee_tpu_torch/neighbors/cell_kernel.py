"""Dense-cell force pass: the CUDA kernel and its plain version —
counterpart of emdee_tpu/neighbors/pallas_cell_kernel.py.

`cell_forces` (counterpart of `pallas_cell_forces`) takes the stacked
state: per-atom or uniform parameters, optional per-slot energies and
virials, and with `coulomb=`/`excl=` the molecular terms (K2c: DSF
Coulomb over the state's charges, exclusion tags, tag-borne bonds).
`cell_forces_split` (counterpart of `pallas_cell_forces_split`) takes
(M³, C) component arrays, uniform parameters, forces only.  Both
launch the one kernel of `csrc/cell_forces.cu` for CUDA tensors, with
backend 'auto' or 'cuda', and run the plain version
(`cell_dense.cell_dense_forces`) for CPU tensors or backend 'torch'.

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
# The most exclusion tags per slot that the molecular kernel holds in
# registers (kMaxTags of csrc/cell_forces.cu).
MAX_TAGS = 8


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
    """One launch of the force kernel's STRAG variant on CUDA tensors (the
    grid side of the straggler pass, K3): the split pass of
    `cell_forces_split` plus, for every center slot, the ≤ Kn aux atoms that
    `table` (M², Kn) lists for its pencil row.  Writes out[0..2] (M³, C);
    the caller (`straggler_kernel.straggler_forces`) checks the inputs."""
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


def _launch_mol(state: CellDenseState, config: CellDenseConfig, coulomb, excl, compute_energy: bool):
    """One launch of the molecular kernel (K2c) on a CUDA state."""
    global LAUNCHES
    nc, c = config.num_cells, config.capacity
    dev = state.positions.device
    operands, (forces, e, w) = stacked_operands(state, config, None, compute_energy)
    pos, hs, tse, valid = operands[0], operands[4], operands[5], operands[6]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    q = consts = aid = ids = mlj = mcs = bond = None
    ne = neb = 0
    if coulomb is not None:
        if state.charges is None:
            raise ValueError("coulomb model given but state has no charges")
        q = state.charges
        _check(q, "charges", torch.float32, (nc, c), dev)
        consts = (coulomb.alpha, coulomb.rc, coulomb.rc2, coulomb.e_shift, coulomb.f_shift, coulomb.kc)
        for name, t in zip(("alpha", "rc", "rc2", "e_shift", "f_shift", "kc"), consts):
            _check(t, f"coulomb.{name}", torch.float32, (), dev)
    if excl is not None:
        ids, mlj, mcs = excl[:3]
        bond = excl[3] if len(excl) > 3 else None
        if coulomb is not None and mcs is None:
            mcs = mlj
        ne = ids.shape[-1]
        if ne > MAX_TAGS:
            raise ValueError(
                f"{ne} exclusion tags per slot; the molecular kernel holds at most {MAX_TAGS}: build the tags "
                f"with exclusion_band={MAX_TAGS} or less and correct the rest in slot space "
                "(make_molecular_dense_sim does so on 'cuda')")
        aid = state.atom_id
        _check(aid, "atom_id", torch.int32, (nc, c), dev)
        for name, t in (("ids", ids), ("mlj", mlj), ("mcs", mcs)):
            if t is not None:
                _check(t, f"excl {name}", torch.float32, (nc, c, ne), dev)
        if bond is not None:
            neb = bond[0].shape[-1]
            for name, t in zip(("kb", "kr0", "kr02"), bond):
                _check(t, f"bond {name}", torch.float32, (nc, c, neb), dev)
    consts = consts or (None,) * 6
    kb, kr0, kr02 = bond or (None, None, None)
    err = build.load().emdee_cell_forces_mol(
        pos.data_ptr(), ptr(hs), ptr(tse), valid.data_ptr(), ptr(q), ptr(aid), ptr(ids), ptr(mlj),
        ptr(mcs), ptr(kb), ptr(kr0), ptr(kr02), ne, neb, *map(ptr, consts), forces.data_ptr(), ptr(e),
        ptr(w), config.cells_per_dim, c, box_ptr(_box_of(state, config), pos), *_pair_consts(config, None)[:8],
        int(coulomb is not None), int(excl is not None), int(bond is not None), int(compute_energy),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "cell_forces kernel (molecular)")
    LAUNCHES += 1
    return forces, e, w


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


def ghost_forces(ghost, shards, base, config: CellDenseConfig, model: LennardJonesModel, *,
                 uniform_params=None, compute_energy: bool = False, backend: str = "auto"):
    """The grid-sharded engine's per-shard force pass (the kernel's GHOST
    mode): forces (3, sz, sy, sx, mz, my, mx, C) of every own slot of the
    local shards and, with `compute_energy`, per-slot half-split energies and
    virials (sz, sy, sx, mz, my, mx, C) — else None, None.

    ghost: (F, sz, sy, sx, mz+2, my+2, mx+2, C) float32, each local shard's
    ghost grid: positions x, y, z with NaN in empty slots, then, without
    uniform parameters, σ/2 and 2√ε.  shards: (sz, sy, sx), the local shards'
    grid; base: the global shard coordinates (z, y, x) of its first shard,
    so that the kernel takes each periodic shift from a neighbour's global
    cell index.  The box is config.box."""
    if resolve_backend(backend, ghost) == "torch":
        return ghost_forces_plain(ghost, config, model, uniform_params, compute_energy)
    global LAUNCHES
    sz, sy, sx = shards
    gz, gy, gx, c = ghost.shape[-4:]
    nfield = 3 if uniform_params is not None else 5
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
    err = build.load().emdee_cell_forces_ghost(
        ghost[0].data_ptr(), ghost[1].data_ptr(), ghost[2].data_ptr(), *map(ptr, params),
        f[0].data_ptr(), f[1].data_ptr(), f[2].data_ptr(), ptr(e), ptr(w),
        gz - 2, gy - 2, gx - 2, sz * sy * sx, sy, sx, *base, config.cells_per_dim, c,
        box_ptr(config.box, ghost), *_pair_consts(config, uniform_params),
        int(uniform_params is not None), int(compute_energy), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "cell_forces kernel (ghost grid)")
    LAUNCHES += 1
    return f, e, w


def ghost_forces_plain(ghost, config: CellDenseConfig, model: LennardJonesModel, uniform_params,
                       compute_energy: bool):
    """The plain version of `ghost_forces`: `_dense_forces` on the ghost
    grids, with every roll of the slot grid replaced by a block of the ghost
    grid.  A half-shell offset's neighbour block is the ghost block at +o,
    and its Newton reaction onto a cell is evaluated where `_dense_forces`
    evaluates it — the pairs of the cell at −o (a ghost block) against the
    cell — in a tile of the same shape, so every pair term and every sum is
    the one-card plain version's, bit for bit, whatever the decomposition.
    Displacements are d − L·round(d/L) of the raw ghost coordinates."""
    from emdee_tpu_torch.neighbors.cell_dense import _GROUP, _OFFSETS, _box

    lead = tuple(ghost.shape[1:-4])
    gz, gy, gx, c = ghost.shape[-4:]
    mz, my, mx = gz - 2, gy - 2, gx - 2
    g = ghost.reshape((ghost.shape[0], -1) + tuple(ghost.shape[-4:]))
    valid_g = ~torch.isnan(g[0])
    pos_g = torch.where(valid_g[..., None], g[:3].movedim(0, -1), 0.0)
    if uniform_params is None:
        hs_g, tse_g = g[3], g[4]
    else:
        hs_g, tse_g = torch.full_like(g[0], uniform_params[0]), torch.full_like(g[0], uniform_params[1])
    box_t = _box(config.box, ghost)

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

    def pair_terms(r2s, ok, hs_i, tse_i, hs_j, tse_j):
        e, mre = pair_interaction(r2s, model, hs_i, tse_i, hs_j, tse_j)
        return torch.where(ok, e, 0.0), torch.where(ok, mre, 0.0)

    zero = (0, 0, 0)
    pos, hs, tse, valid = (block(a, zero) for a in (pos_g, hs_g, tse_g, valid_g))
    cells = pos.shape[0]

    # ---- self-cell tile, as in `_dense_forces` ----
    dv = disp(pos[:, :, None, :], pos[:, None, :, :])
    r2 = r2_of(dv)
    eye = torch.eye(c, dtype=torch.bool, device=pos.device)
    ok = valid[:, :, None] & valid[:, None, :] & ~eye[None]
    r2s = torch.where(ok, r2, 1.0)
    e, mre = pair_terms(r2s, ok, hs[:, :, None], tse[:, :, None], hs[:, None, :], tse[:, None, :])
    forces = torch.sum((mre / r2s)[..., None] * dv, dim=2)
    if compute_energy:
        energies = 0.5 * torch.sum(e, dim=2)
        virials = 0.5 * torch.sum(mre, dim=2)

    for g0 in range(0, len(_OFFSETS), _GROUP):
        offs = _OFFSETS[g0 : g0 + _GROUP]
        k = len(offs)
        # Forward tile: own centres against the cells at +o.
        nbr = lambda a: torch.cat([block(a, o) for o in offs], dim=1)  # noqa: E731
        nbr_pos, nbr_hs, nbr_tse, nbr_valid = nbr(pos_g), nbr(hs_g), nbr(tse_g), nbr(valid_g)
        dv = disp(pos[:, :, None, :], nbr_pos[:, None, :, :])
        ok = valid[:, :, None] & nbr_valid[:, None, :]
        r2s = torch.where(ok, r2_of(dv), 1.0)
        e, mre = pair_terms(r2s, ok, hs[:, :, None], tse[:, :, None], nbr_hs[:, None, :], nbr_tse[:, None, :])
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

        dv = disp(centres(pos_g), owns(pos))
        ok = centres(valid_g) & owns(valid)
        r2s = torch.where(ok, r2_of(dv), 1.0)
        e, mre = pair_terms(r2s, ok, centres(hs_g), centres(tse_g), owns(hs), owns(tse))
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

    shape = lead + (mz, my, mx, c)
    forces = forces.reshape(shape + (3,)).movedim(-1, 0)
    if compute_energy:
        return forces, energies.reshape(shape), virials.reshape(shape)
    return forces, None, None
