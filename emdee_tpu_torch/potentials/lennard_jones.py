"""Switched 12-6 Lennard-Jones pair potential (counterpart of
emdee_tpu/potentials/lennard_jones.py; the math and its two cutoff modes
are documented there).  float32 throughout."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from emdee_tpu_torch.core.types import LJParams, resolve_device


class LennardJonesModel(NamedTuple):
    """Global LJ constants, pre-squared: rc², rs², δ⁻² = 1/(rc²−rs²), as
    0-d float32 tensors."""

    rc2: torch.Tensor
    rs2: torch.Tensor
    inv_delta2: torch.Tensor

    @classmethod
    def create(cls, cutoff: float, switch: float, device=None):
        """On `device`, by default the CUDA card (`resolve_device`)."""
        device = resolve_device(device)
        rc2 = torch.tensor(cutoff, dtype=torch.float32, device=device) ** 2
        rs2 = torch.tensor(switch, dtype=torch.float32, device=device) ** 2
        return cls(rc2=rc2, rs2=rs2, inv_delta2=1.0 / (rc2 - rs2))


def lennard_jones_atom(epsilon, sigma, device=None) -> LJParams:
    """Pre-transform host (ε, σ) into mixing-ready per-atom params (σ/2, 2√ε)
    on `device`, by default the CUDA card.  Formed in float32 numpy, whose
    square root is correctly rounded like the reference's (PyTorch's
    vectorized CPU sqrt is not)."""
    device = resolve_device(device)
    eps = np.atleast_1d(np.asarray(epsilon, np.float32))
    sig = np.atleast_1d(np.asarray(sigma, np.float32))
    return LJParams(
        half_sigma=torch.from_numpy(np.float32(0.5) * sig).to(device),
        twice_sqrt_eps=torch.from_numpy(np.float32(2.0) * np.sqrt(eps)).to(device),
    )


def pair_interaction(
    r2: torch.Tensor,
    model: LennardJonesModel,
    half_sigma_i,
    twice_sqrt_eps_i,
    half_sigma_j,
    twice_sqrt_eps_j,
    *,
    parity_mode: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pair energy and −r·dE/dr at squared distance r² (broadcasts).

    Callers mask invalid pairs: pass a safe nonzero r² for them and zero the
    outputs.  `parity_mode=True` keeps the reference's clamp quirk (x > 1
    maps back to 0, so pairs beyond the cutoff interact at full strength)."""
    sigma = half_sigma_i + half_sigma_j
    eps4 = twice_sqrt_eps_i * twice_sqrt_eps_j
    s2inv = sigma * sigma / r2
    s6inv = s2inv * s2inv * s2inv
    eps4_s6 = eps4 * s6inv
    energy = eps4_s6 * (s6inv - 1.0)
    minus_rE = 6.0 * eps4_s6 * (2.0 * s6inv - 1.0)

    x = (r2 - model.rs2) * model.inv_delta2
    if parity_mode:
        x = x * (0.5 * (torch.sign(x) - torch.sign(x - 1.0)))
    else:
        x = torch.clamp(x, 0.0, 1.0)
    x2 = x * x
    g = 1.0 + x * x2 * (15.0 * x - 6.0 * x2 - 10.0)
    one_minus_x = 1.0 - x
    minus_rg = 60.0 * x2 * (one_minus_x * one_minus_x) * model.inv_delta2 * r2
    return energy * g, minus_rE * g + energy * minus_rg


def pair_energy(r2, model: LennardJonesModel, params_i: LJParams, params_j: LJParams, **kw):
    """`pair_interaction` taking `LJParams` tuples for the two atoms."""
    return pair_interaction(
        r2,
        model,
        params_i.half_sigma,
        params_i.twice_sqrt_eps,
        params_j.half_sigma,
        params_j.twice_sqrt_eps,
        **kw,
    )
