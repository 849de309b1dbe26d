"""Berendsen pressure coupling (NPT) of a `State` for the portable force
paths (counterpart of emdee_tpu/dynamics/npt.py): after each
(thermostatted) step the box and the positions are rescaled by

    μ = (1 − (dt/τ_P)·κ·(P₀ − P))^{1/3},   P = (2·KE + W) / (3V),

with μ³ clipped to [0.9, 1.1].  The box stays a 0-d tensor on the device,
so nothing is read on the host.

The neighbor-list bundle binds its box when it is made: under NPT its list
is built and checked at that first box (ROADMAP fault R10, as in the
reference); the all-pairs path takes the state's box throughout.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch

from emdee_tpu_torch.core.types import State, _f32
from emdee_tpu_torch.dynamics.observables import kinetic_energy
from emdee_tpu_torch.dynamics.verlet import rollout, velocity_verlet_step


def instantaneous_pressure(state: State, virial_total) -> torch.Tensor:
    """P = (2·KE + W) / (3V) — the isotropic virial pressure."""
    return (2.0 * kinetic_energy(state) + virial_total) / (3.0 * state.box**3)


def berendsen_npt_step(
    state: State,
    forces: torch.Tensor,
    aux: Any,
    force_fn: Callable,
    virial_fn: Callable,  # (positions, box, aux) → total scalar virial
    dt,
    tau_p,
    pressure,
    kappa: float = 1.0,  # isothermal compressibility (units of 1/P)
    thermostat_step: Callable = None,
) -> Tuple[State, torch.Tensor, Any]:
    """One step of `thermostat_step(state, forces, aux, force_fn, dt)`
    (velocity Verlet by default), then the Berendsen box and position
    rescale; `virial_fn` is a second pair evaluation a step."""
    step_fn = thermostat_step or velocity_verlet_step
    state, forces, aux = step_fn(state, forces, aux, force_fn, dt)
    p_inst = instantaneous_pressure(state, virial_fn(state.positions, state.box, aux))
    coupling = _f32(np.float32(dt) / np.float32(tau_p))
    mu3 = 1.0 - coupling * (_f32(kappa) * (_f32(pressure) - p_inst))
    mu = torch.clamp(mu3, 0.9, 1.1) ** (1.0 / 3.0)
    return state._replace(positions=state.positions * mu, box=state.box * mu), forces, aux


def npt_rollout(
    state: State,
    aux: Any,
    force_fn: Callable,
    virial_fn: Callable,
    dt,
    tau_p,
    pressure,
    num_steps: int,
    kappa: float = 1.0,
    thermostat_step: Callable = None,
):
    """`num_steps` Berendsen-coupled steps; returns (state, aux, the box
    after every step as a (num_steps,) tensor)."""
    boxes = []

    def step(st, f, ax):
        st, f, ax = berendsen_npt_step(st, f, ax, force_fn, virial_fn, dt, tau_p, pressure, kappa, thermostat_step)
        boxes.append(st.box)
        return st, f, ax

    state, aux, _ = rollout(state, aux, force_fn, step, num_steps)
    return state, aux, torch.stack(boxes)
