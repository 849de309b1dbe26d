"""Simulation observables of a `State` (counterpart of
emdee_tpu/dynamics/observables.py): kinetic and total energy, temperature,
pressure, NVE drift — 0-d tensors on the state's device.  Total potential
energy = Σᵢ energyᵢ, total scalar virial W = Σᵢ virialᵢ = Σ_pairs (−r·dE/dr)."""

from __future__ import annotations

import torch

from emdee_tpu_torch.core.types import State


def kinetic_energy(state: State) -> torch.Tensor:
    return 0.5 * torch.sum(state.masses[:, None] * state.velocities**2)


def temperature(state: State, kB: float = 1.0) -> torch.Tensor:
    """Instantaneous T from equipartition: 2·E_kin / (3N·kB)."""
    n = state.positions.shape[0]
    return 2.0 * kinetic_energy(state) / (3.0 * n * kB)


def pressure(state: State, total_virial, kB: float = 1.0) -> torch.Tensor:
    """Isotropic virial pressure: P = (N·kB·T + W/3) / V."""
    n = state.positions.shape[0]
    return (n * kB * temperature(state, kB) + total_virial / 3.0) / state.box**3


def total_energy(state: State, potential_energy) -> torch.Tensor:
    return kinetic_energy(state) + potential_energy


def energy_drift(total_energies: torch.Tensor) -> torch.Tensor:
    """Relative NVE drift: max |E(t) − E(0)| / |E(0)| over a rollout record."""
    e0 = total_energies[0]
    return torch.max(torch.abs(total_energies - e0)) / torch.abs(e0)
