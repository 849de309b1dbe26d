"""Langevin (NVT) integration of a `State` by BAOAB splitting (counterpart
of emdee_tpu/dynamics/langevin.py): half kick (B), half drift (A), the exact
Ornstein–Uhlenbeck solve (O), half drift (A), half kick (B).

`baoab_step` is the pure step on given noise, so a test can feed it the
reference's draws; `langevin_baoab_step` draws the noise from `state.rng`.
The scalar constants exp(−γ·dt) and √((1 − c1²)·kT) are formed in float32
numpy, as the reference forms them in float32 (PyTorch's CPU sqrt is not
correctly rounded).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from emdee_tpu_torch.core.pbc import wrap
from emdee_tpu_torch.core.types import State, _f32
from emdee_tpu_torch.dynamics.verlet import Trajectory, rollout


def baoab_step(
    state: State,
    forces: torch.Tensor,
    aux: Any,
    force_fn: Callable,
    dt,
    friction,
    temperature,
    noise: torch.Tensor,
    kB: float = 1.0,
) -> Tuple[State, torch.Tensor, Any]:
    """One BAOAB step on the standard-normal `noise` (N, 3)."""
    dt32 = np.float32(dt)
    half_dt = _f32(np.float32(0.5) * dt32)
    c1 = np.float32(np.exp(np.float32(friction) * -dt32))
    c2 = _f32(np.sqrt((np.float32(1.0) - c1 * c1) * np.float32(kB * temperature)))
    inv_m = (1.0 / state.masses)[:, None]
    v = state.velocities + half_dt * forces * inv_m
    x = state.positions + half_dt * v
    v = float(c1) * v + c2 * torch.sqrt(inv_m) * noise
    x = wrap(x + half_dt * v, state.box)
    new_forces, aux = force_fn(x, state.box, aux)
    v = v + half_dt * new_forces * inv_m
    return state._replace(positions=x, velocities=v, step=state.step + 1), new_forces, aux


def langevin_baoab_step(
    state: State,
    forces: torch.Tensor,
    aux: Any,
    force_fn: Callable,
    dt,
    friction,
    temperature,
    kB: float = 1.0,
) -> Tuple[State, torch.Tensor, Any]:
    """One BAOAB step, its noise drawn from `state.rng`."""
    if state.rng is None:
        raise ValueError("Langevin dynamics needs a State with an rng generator")
    noise = torch.randn(state.velocities.shape, generator=state.rng, dtype=state.velocities.dtype,
                        device=state.velocities.device)
    return baoab_step(state, forces, aux, force_fn, dt, friction, temperature, noise, kB)


def nvt_rollout(
    state: State,
    aux: Any,
    force_fn: Callable,
    dt,
    friction,
    temperature,
    num_steps: int,
    record_every: int = 0,
    energy_fn=None,
    kB: float = 1.0,
) -> Tuple[State, Any, Optional[Trajectory]]:
    """`num_steps` BAOAB steps (the contract of `nve_rollout`)."""
    step = lambda st, f, ax: langevin_baoab_step(st, f, ax, force_fn, dt, friction, temperature, kB)  # noqa: E731
    return rollout(state, aux, force_fn, step, num_steps, record_every, energy_fn)
