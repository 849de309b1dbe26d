"""Core types (counterpart of emdee_tpu/core/types.py).

`FORCES`/`ENERGIES`/`VIRIALS` keep the reference's output-selection bit
values (nonbonded.jl:12-14).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Output-selection bitmask (reference: nonbonded.jl:12-14).
FORCES = 1 << 0
ENERGIES = 1 << 1
VIRIALS = 1 << 2
ALL_OUTPUTS = FORCES | ENERGIES | VIRIALS


class LJParams(NamedTuple):
    """Per-atom Lennard-Jones parameters, pre-transformed for mixing:
    ``σᵢⱼ = half_sigma_i + half_sigma_j`` and
    ``4εᵢⱼ = twice_sqrt_eps_i * twice_sqrt_eps_j``."""

    half_sigma: torch.Tensor  # (N,) float32
    twice_sqrt_eps: torch.Tensor  # (N,) float32
