"""Dense-cell LJ force pass: the CUDA kernel and its plain version —
counterpart of emdee_tpu/neighbors/pallas_cell_kernel.py.

`cell_forces` (counterpart of `pallas_cell_forces`) takes the stacked
state: per-atom or uniform parameters, optional per-slot energies and
virials.  `cell_forces_split` (counterpart of `pallas_cell_forces_split`)
takes (M³, C) component arrays, uniform parameters, forces only.  Both
launch the one kernel of `csrc/cell_forces.cu` for CUDA tensors, with
backend 'auto' or 'cuda', and run the plain version
(`cell_dense.cell_dense_forces`) for CPU tensors or backend 'torch'.

The TPU kernel's ghost grid, far sentinels, MXU segment sums and reaction
folds (`_ghost`, `_prep_inputs`, `_fold_ghosts`, `_const_tiles`,
`_sentinel_far`) exist because of VMEM and the MXU and have no counterpart:
the CUDA kernel shifts wrapped neighbor cells by ±box itself and masks
empty slots.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from emdee_tpu_torch.csrc import build
from emdee_tpu_torch.neighbors.cell_dense import (
    CellDenseConfig,
    CellDenseState,
    _dense_forces,
    cell_dense_forces,
    resolve_backend,
)
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0


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
            config: CellDenseConfig, box: float, uniform_params, energy: bool):
    global LAUNCHES
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(px.device).cuda_stream
    err = build.load().emdee_cell_forces(
        ptr(px), ptr(py), ptr(pz), pstride, ptr(hs), ptr(tse), ptr(valid),
        ptr(fx), ptr(fy), ptr(fz), fstride, ptr(e), ptr(w),
        config.cells_per_dim, config.capacity, float(box),
        *_pair_consts(config, uniform_params),
        int(uniform_params is not None), int(energy), stream,
    )
    build.check(err, "cell_forces kernel")
    LAUNCHES += 1


def cell_forces(
    state: CellDenseState,
    model: LennardJonesModel,
    config: CellDenseConfig,
    *,
    compute_energy: bool = False,
    uniform_params=None,
    backend: str = "auto",
):
    """Forces (M³, C, 3) and, with `compute_energy`, per-slot half-split
    energies and virials (M³, C) — else None, None.

    uniform_params: optional (half_sigma, twice_sqrt_eps) floats shared by
    every atom; the kernel then reads no per-atom parameter fields."""
    if resolve_backend(backend, state.positions) == "torch":
        return cell_dense_forces(state, model, config, compute_energy=compute_energy)
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
    _launch(
        px, px[1:], px[2:], 3, hs, tse, state.valid, fv, fv[1:], fv[2:], 3, e, w,
        config, config.box, uniform_params, compute_energy,
    )
    return forces, e, w


def cell_forces_split(
    px, py, pz, valid,
    config: CellDenseConfig,
    *,
    uniform_params,
    box: Optional[float] = None,
    backend: str = "auto",
):
    """Forces (fx, fy, fz), each (M³, C), from component positions with
    uniform LJ parameters — the component-carry rollout's force call."""
    box = config.box if box is None else box
    if resolve_backend(backend, px) == "torch":
        hs = torch.full_like(px, uniform_params[0])
        tse = torch.full_like(px, uniform_params[1])
        model = LennardJonesModel.create(config.cutoff, config.switch, device=px.device)
        f, _, _ = _dense_forces(
            torch.stack([px, py, pz], dim=-1), hs, tse, valid, model, config, box, False
        )
        return f[..., 0], f[..., 1], f[..., 2]
    shape = (config.num_cells, config.capacity)
    dev = px.device
    for name, t in (("px", px), ("py", py), ("pz", pz)):
        _check(t, name, torch.float32, shape, dev)
    _check(valid, "valid", torch.bool, shape, dev)
    fx, fy, fz = (torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(3))
    _launch(
        px, py, pz, 1, None, None, valid, fx, fy, fz, 1, None, None,
        config, box, uniform_params, False,
    )
    return fx, fy, fz
