"""FIRE energy minimization of a `State` (Bitzek et al., PRL 97, 170201,
2006; counterpart of emdee_tpu/dynamics/minimize.py):

    P = F·v
    v ← (1−α)·v + α·|v|·F̂            (inertial steering)
    P > 0 for > N_min steps:  dt ← min(dt·f_inc, dt_max), α ← α·f_α
    P ≤ 0:                    v ← 0, dt ← dt·f_dec, α ← α_start

dt, α and the downhill counter stay 0-d tensors on the device and every
branch is a `torch.where`, so the loop reads nothing on the host; the
constants are float32 values, as the reference forms them.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from emdee_tpu_torch.core.pbc import wrap
from emdee_tpu_torch.core.types import State, _f32


class FireConfig(NamedTuple):
    dt_start: float = 0.002
    dt_max: float = 0.02
    n_min: int = 5
    f_inc: float = 1.1
    f_dec: float = 0.5
    alpha_start: float = 0.1
    f_alpha: float = 0.99


def fire_minimize(
    state: State,
    aux: Any,
    force_fn: Callable,
    num_steps: int,
    config: FireConfig = FireConfig(),
) -> Tuple[State, Any, torch.Tensor]:
    """Relax `state` for `num_steps` FIRE iterations.

    Returns (the state at the best-visited configuration — FIRE's inertial
    dynamics overshoot near convergence, so the minimum-|F| snapshot is the
    answer — with zero velocities, aux re-bound to those positions, and the
    (num_steps,) max-|F| history)."""
    dev = state.positions.device
    full = lambda v, dtype=torch.float32: torch.full((), v, dtype=dtype, device=dev)  # noqa: E731
    inv_m = (1.0 / state.masses)[:, None]
    f, aux = force_fn(state.positions, state.box, aux)
    x, v = state.positions, torch.zeros_like(state.velocities)
    dt, alpha, n_up = full(_f32(config.dt_start)), full(_f32(config.alpha_start)), full(0, torch.int32)
    best_pos, best_f = x, torch.max(torch.abs(f))
    history = []
    for _ in range(num_steps):
        # Semi-implicit Euler MD step, then the FIRE steering.
        v = v + dt * f * inv_m
        p = torch.sum(f * v)
        v_norm = torch.sqrt(torch.sum(v * v))
        f_norm = torch.sqrt(torch.sum(f * f))
        v_steer = (1.0 - alpha) * v + alpha * v_norm * f / torch.clamp(f_norm, min=1e-30)
        uphill = p <= 0.0
        v = torch.where(uphill, 0.0, v_steer)
        n_up = torch.where(uphill, 0, n_up + 1)
        grow = ~uphill & (n_up > config.n_min)
        dt = torch.where(uphill, dt * _f32(config.f_dec),
                         torch.where(grow, torch.clamp(dt * _f32(config.f_inc), max=_f32(config.dt_max)), dt))
        alpha = torch.where(uphill, _f32(config.alpha_start), torch.where(grow, alpha * _f32(config.f_alpha), alpha))
        x = wrap(x + dt * v, state.box)
        f, aux = force_fn(x, state.box, aux)
        fmax = torch.max(torch.abs(f))
        better = fmax < best_f
        best_pos = torch.where(better, x, best_pos)
        best_f = torch.where(better, fmax, best_f)
        history.append(fmax)
    # The minimizer may have left the neighbor skin between the best-visited
    # and the final configurations: one more call re-binds aux to the
    # positions returned.
    _, aux = force_fn(best_pos, state.box, aux)
    return state._replace(positions=best_pos, velocities=torch.zeros_like(v)), aux, torch.stack(history)
