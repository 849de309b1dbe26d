"""Bussi–Donadio–Parrinello stochastic velocity rescaling (CSVR) — the
port's copy of the rescaling factor of emdee_tpu/dynamics/bussi.py, which
the dense engine's CSVR thermostat applies once per step.

    α² = c + (1 − c)·K̄/(Nf·K)·(R₁² + Σ_{i=2}^{Nf} R_i²)
         + 2·R₁·√(c·(1 − c)·K̄/(Nf·K)),      c = e^{−dt/τ}, K̄ = Nf·kT/2

(Bussi et al., J. Chem. Phys. 126, 014101 (2007), eq. A7), with R_i
standard normals and Σ R_i² over Nf − 1 degrees of freedom drawn as
2·Gamma((Nf − 1)/2).  `_csvr_alpha2` is a pure function of its two draws,
so a test can feed it the reference's; `csvr_draws` makes them from a
`torch.Generator` on the state's device, without a host read.

The portable engine's `bussi_step` and `csvr_rollout` (of a `State`) apply
it after each velocity-Verlet step.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch

from emdee_tpu_torch.core.types import State
from emdee_tpu_torch.dynamics.observables import kinetic_energy
from emdee_tpu_torch.dynamics.verlet import rollout, velocity_verlet_step


def _csvr_alpha2(r1, sum_r2, kin, ndof: float, kT: float, dt: float, tau: float):
    """The squared rescaling factor from the draws r1 (a standard normal)
    and sum_r2 (Σ R_i² over Nf − 1 dofs) at kinetic energy `kin`.

    The constants are formed in float32 as the reference forms them
    (c = exp(−dt/τ), K̄ = ½·Nf·kT, (1 − c)·K̄); τ = ∞ gives c = 1 and
    α² = 1 exactly."""
    f32 = np.float32
    c = f32(np.exp(-f32(dt) / f32(tau)))
    kbar = f32(0.5) * f32(ndof) * f32(kT)
    factor = float((f32(1.0) - c) * kbar) / (float(f32(ndof)) * kin)
    c = float(c)
    return c + factor * (r1 * r1 + sum_r2) + 2.0 * r1 * torch.sqrt(c * factor)


def csvr_draws(rng: torch.Generator, ndof: float, like: torch.Tensor):
    """(r1, Σ R_i²) as 0-d float32 tensors on `like`'s device, drawn from
    `rng` (a generator on that device): one normal, then 2·Gamma((Nf−1)/2)
    (`torch._standard_gamma` takes the generator, so reruns from one seed
    repeat)."""
    r1 = torch.randn((), generator=rng, dtype=torch.float32, device=like.device)
    shape = torch.full((), 0.5 * float(np.float32(ndof) - np.float32(1.0)), dtype=torch.float32, device=like.device)
    return r1, 2.0 * torch._standard_gamma(shape, generator=rng)


def _ndof(state: State, com_fixed: bool) -> int:
    """Velocity Verlet conserves the (zeroed) total momentum, so with
    `com_fixed` the live dof count is 3N − 3."""
    return 3 * state.positions.shape[0] - (3 if com_fixed else 0)


def csvr_rescale(state: State, r1, sum_r2, dt, tau, temperature, kB: float = 1.0, com_fixed: bool = True) -> State:
    """The CSVR global rescale v ← α·v on given draws (r1, Σ R²): the pure
    half of `bussi_step`, so a test can feed it the reference's draws."""
    kin = torch.clamp(kinetic_energy(state), min=1e-30)
    alpha2 = _csvr_alpha2(r1, sum_r2, kin, _ndof(state, com_fixed), kB * temperature, dt, tau)
    return state._replace(velocities=torch.sqrt(torch.clamp(alpha2, min=0.0)) * state.velocities)


def bussi_step(
    state: State,
    forces: torch.Tensor,
    aux: Any,
    force_fn: Callable,
    dt,
    tau,
    temperature,
    kB: float = 1.0,
    com_fixed: bool = True,
) -> Tuple[State, torch.Tensor, Any]:
    """One velocity-Verlet step and the CSVR rescale, its two draws taken
    from `state.rng` (`csvr_draws`)."""
    if state.rng is None:
        raise ValueError("the Bussi thermostat needs a State with an rng generator")
    state, forces, aux = velocity_verlet_step(state, forces, aux, force_fn, dt)
    r1, sum_r2 = csvr_draws(state.rng, _ndof(state, com_fixed), state.positions)
    return csvr_rescale(state, r1, sum_r2, dt, tau, temperature, kB, com_fixed), forces, aux


def csvr_rollout(state: State, aux: Any, force_fn: Callable, dt, tau, temperature, num_steps: int, kB: float = 1.0):
    """`num_steps` Bussi CSVR steps; returns (state, aux)."""
    step = lambda st, f, ax: bussi_step(st, f, ax, force_fn, dt, tau, temperature, kB)  # noqa: E731
    state, aux, _ = rollout(state, aux, force_fn, step, num_steps)
    return state, aux
