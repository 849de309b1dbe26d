"""The straggler pass (K3): its CUDA kernels and their plain version —
counterpart of the `strag_kn > 0` tile of
emdee_tpu/neighbors/pallas_cell_kernel.py `_make_kernel` (:620-670,
:807-862), with the caller's reaction fold and straggler↔straggler term
(cell_dense_straggler.py `_fold_strag_react`, `_aux_pair_forces`).

`straggler_forces` returns the grid forces (3, M³, C_t) — grid↔grid pairs
plus, for each center slot, the ≤ Kn aux atoms listed for its pencil row —
and the aux forces (3, A) — each parked atom against its parked cell's 27
neighbor cells and against the other aux atoms.  For CUDA tensors (backend
'auto' or 'cuda') it makes two launches: the force kernel's STRAG variant
(`csrc/cell_forces.cu`, counted in `cell_kernel.LAUNCHES`) and the aux
kernel (`csrc/straggler_forces.cu`, counted in `LAUNCHES` here).  Each pair
is evaluated once from each side, so there is no reaction fold, and every
sum runs in a fixed order without atomics: bitwise reproducible.  For CPU
tensors, or backend 'torch', it runs the plain version.

Between rebins the two sides see the same pairs inside the cutoff: an aux
atom and a grid atom within rc lie in adjacent cells as long as neither has
moved skin/2 since the rebin, which the staleness flag guards.
"""

from __future__ import annotations

import torch

from emdee_tpu_torch.csrc import build
from emdee_tpu_torch.neighbors import cell_kernel
from emdee_tpu_torch.neighbors.cell_dense import _box, resolve_backend
from emdee_tpu_torch.neighbors.cell_dense_straggler import (
    StragglerConfig,
    _aux_pair_forces,
    _gather_pair_forces,
    _gather_rows,
    _min_image,
    _uniform,
)
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel, pair_interaction

# Aux-side kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0


def _tile_forces(px, py, pz, valid, ax, ay, az, table, m, box_t, model, uniform_params):
    """Plain grid side of the tile: every center slot of a cell against the
    aux atoms that `table` lists for the cell's pencil row (cell // M)."""
    nc = valid.shape[0]
    lst = table[torch.arange(nc, device=px.device) // m]  # (M³, Kn)
    live = lst >= 0
    j = torch.clamp(lst, min=0).long()
    mi = lambda d: _min_image(d, box_t)  # noqa: E731
    dvx = mi(px[:, :, None] - ax[j][:, None, :])
    dvy = mi(py[:, :, None] - ay[j][:, None, :])
    dvz = mi(pz[:, :, None] - az[j][:, None, :])
    r2 = dvx * dvx + dvy * dvy + dvz * dvz
    ok = valid[:, :, None] & live[:, None, :]
    r2s = torch.where(ok, r2, 1.0)
    hs, tse = _uniform(uniform_params, px)
    _, mre = pair_interaction(r2s, model, hs, tse, hs, tse)
    g = torch.where(ok, mre / r2s, 0.0)
    return torch.stack([torch.sum(g * dvx, dim=2), torch.sum(g * dvy, dim=2), torch.sum(g * dvz, dim=2)])


def grid_forces_plain(px, py, pz, valid, ax, ay, az, table, config: StragglerConfig, uniform_params):
    """Plain grid side (3, M³, C_t): grid↔grid pairs plus the tile."""
    cfg = config.grid
    grid = cell_kernel.cell_forces_split(px, py, pz, valid, cfg, uniform_params=uniform_params, backend="torch")
    model = LennardJonesModel.create(cfg.cutoff, cfg.switch, device=px.device)
    tile = _tile_forces(
        px, py, pz, valid, ax, ay, az, table, cfg.cells_per_dim, _box(cfg.box, px), model, uniform_params
    )
    return torch.stack(grid) + tile


def aux_forces_plain(px, py, pz, valid, ax, ay, az, acell, config: StragglerConfig, uniform_params):
    """Plain aux side (3, A): the 27-row gather plus straggler↔straggler."""
    cfg = config.grid
    model = LennardJonesModel.create(cfg.cutoff, cfg.switch, device=px.device)
    box_t = _box(cfg.box, px)
    avalid = acell < cfg.num_cells
    idx, mask = _gather_rows(acell, valid, avalid, cfg.cells_per_dim)
    gx, gy, gz = _gather_pair_forces(px, py, pz, ax, ay, az, idx, mask, model, box_t, uniform_params)
    ss = _aux_pair_forces(ax, ay, az, avalid, model, box_t, uniform_params)
    return torch.stack([
        torch.sum(gx, dim=1) + ss[0],
        torch.sum(gy, dim=1) + ss[1],
        torch.sum(gz, dim=1) + ss[2],
    ])


def launch_aux(px, py, pz, valid, ax, ay, az, acell, out, config: StragglerConfig, uniform_params) -> None:
    """One launch of the aux kernel on CUDA tensors, writing out[0..2] (A,);
    `straggler_forces` checks the inputs."""
    global LAUNCHES
    cfg = config.grid
    stream = torch.cuda.current_stream(px.device).cuda_stream
    err = build.load().emdee_straggler_aux(
        px.data_ptr(), py.data_ptr(), pz.data_ptr(), valid.data_ptr(),
        ax.data_ptr(), ay.data_ptr(), az.data_ptr(), acell.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        cfg.cells_per_dim, cfg.capacity, config.aux_capacity, float(cfg.box),
        *cell_kernel._pair_consts(cfg, uniform_params), stream,
    )
    build.check(err, "straggler aux kernel")
    LAUNCHES += 1


def straggler_forces(
    px, py, pz, valid, ax, ay, az, acell, table, config: StragglerConfig, uniform_params,
    backend: str = "auto",
):
    """Grid forces (3, M³, C_t) and aux forces (3, A) of the straggler pass.

    px, py, pz, valid: the (M³, C_t) grid; ax, ay, az: the (A,) aux
    coordinates; acell: (A,) int32 parked cells, M³ for an empty lane;
    table: the (M², Kn) int32 list table of `cell_dense_straggler._bindings`;
    uniform_params: the shared (σ/2, 2√ε).  Empty slots and empty aux lanes
    get exact zeros."""
    if resolve_backend(backend, px) == "torch":
        return (
            grid_forces_plain(px, py, pz, valid, ax, ay, az, table, config, uniform_params),
            aux_forces_plain(px, py, pz, valid, ax, ay, az, acell, config, uniform_params),
        )
    cfg = config.grid
    nc, c, a_cap = cfg.num_cells, cfg.capacity, config.aux_capacity
    dev = px.device
    for name, t in (("px", px), ("py", py), ("pz", pz)):
        cell_kernel._check(t, name, torch.float32, (nc, c), dev)
    cell_kernel._check(valid, "valid", torch.bool, (nc, c), dev)
    for name, t in (("ax", ax), ("ay", ay), ("az", az)):
        cell_kernel._check(t, name, torch.float32, (a_cap,), dev)
    cell_kernel._check(acell, "acell", torch.int32, (a_cap,), dev)
    cell_kernel._check(table, "table", torch.int32, (cfg.cells_per_dim**2, config.kn), dev)
    fg = torch.empty((3, nc, c), dtype=torch.float32, device=dev)
    fa = torch.empty((3, a_cap), dtype=torch.float32, device=dev)
    cell_kernel.launch_strag(px, py, pz, valid, ax, ay, az, table, fg, cfg, uniform_params)
    launch_aux(px, py, pz, valid, ax, ay, az, acell, fa, config, uniform_params)
    return fg, fa
