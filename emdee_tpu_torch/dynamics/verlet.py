"""Velocity-Verlet integration of a `State` (counterpart of
emdee_tpu/dynamics/verlet.py).  The reference scans the steps on the
device (`lax.scan`); here they are a Python loop of eager steps, every one
on the state's device.

Force-function contract (made by `emdee_tpu_torch.neighbors.api.make_force_fn`):
    force_fn(positions, box, aux) -> (forces, aux)
where `aux` is opaque state the integrator carries (the neighbor list, with
its rebuild inside).  The integrators themselves read nothing on the host:
records stay device tensors.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from emdee_tpu_torch.core.pbc import wrap
from emdee_tpu_torch.core.types import State, _f32
from emdee_tpu_torch.dynamics.observables import kinetic_energy


class Trajectory(NamedTuple):
    """Per-record observables of a rollout (leading axis = records)."""

    step: torch.Tensor
    kinetic_energy: torch.Tensor
    potential_energy: Optional[torch.Tensor] = None
    virial: Optional[torch.Tensor] = None


def velocity_verlet_step(
    state: State,
    forces: torch.Tensor,
    aux: Any,
    force_fn: Callable,
    dt,
) -> Tuple[State, torch.Tensor, Any]:
    """One NVE velocity-Verlet step: kick–drift–(forces)–kick."""
    half_dt = _f32(np.float32(0.5) * np.float32(dt))
    inv_m = (1.0 / state.masses)[:, None]
    v_half = state.velocities + half_dt * forces * inv_m
    new_pos = wrap(state.positions + _f32(dt) * v_half, state.box)
    new_forces, aux = force_fn(new_pos, state.box, aux)
    new_vel = v_half + half_dt * new_forces * inv_m
    return state._replace(positions=new_pos, velocities=new_vel, step=state.step + 1), new_forces, aux


def rollout(state: State, aux: Any, force_fn: Callable, step_fn: Callable, num_steps: int,
            record_every: int = 0, energy_fn: Optional[Callable] = None):
    """`num_steps` steps of `step_fn(state, forces, aux) → (state, forces,
    aux)` from a fresh force evaluation.  With record_every > 0 a record is
    taken every `record_every` steps: (step, E_kin, and E_pot and W from
    `energy_fn(positions, aux) → (potential, virial)` if given).  Returns
    (state, aux, Trajectory or None)."""
    num_records, rem = divmod(num_steps, record_every) if record_every > 0 else (0, 0)
    if rem:
        raise ValueError("num_steps must be a multiple of record_every")
    forces, aux = force_fn(state.positions, state.box, aux)
    records = []
    for i in range(num_steps):
        state, forces, aux = step_fn(state, forces, aux)
        if num_records and (i + 1) % record_every == 0:
            pe_vir = energy_fn(state.positions, aux) if energy_fn is not None else (None, None)
            records.append((state.step, kinetic_energy(state), *pe_vir))
    if not num_records:
        return state, aux, None
    stack = lambda k: None if records[0][k] is None else torch.stack([r[k] for r in records])  # noqa: E731
    return state, aux, Trajectory(*(stack(k) for k in range(4)))


def nve_rollout(
    state: State,
    aux: Any,
    force_fn: Callable,
    dt,
    num_steps: int,
    record_every: int = 0,
    energy_fn: Optional[Callable] = None,
) -> Tuple[State, Any, Optional[Trajectory]]:
    """`num_steps` NVE steps; with record_every > 0, a record every
    `record_every` steps (E_kin, and E_pot and W through
    `energy_fn(positions, aux) → (potential, virial)` if given)."""
    step = lambda st, f, ax: velocity_verlet_step(st, f, ax, force_fn, dt)  # noqa: E731
    return rollout(state, aux, force_fn, step, num_steps, record_every, energy_fn)
