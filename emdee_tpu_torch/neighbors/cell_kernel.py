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
):
    """Forces (M³, C, 3) and, with `compute_energy`, per-slot half-split
    energies and virials (M³, C) — else None, None.

    uniform_params: optional (half_sigma, twice_sqrt_eps) floats shared by
    every atom; the kernel then reads no per-atom parameter fields.  The box
    is the state's (`state.box`, read on the device, else config.box)."""
    if resolve_backend(backend, state.positions) == "torch":
        return cell_dense_forces(state, model, config, compute_energy=compute_energy)
    operands, outputs = stacked_operands(state, config, uniform_params, compute_energy)
    _launch(*operands, config, _box_of(state, config), uniform_params, compute_energy)
    return outputs


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
