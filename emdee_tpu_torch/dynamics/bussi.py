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
"""

from __future__ import annotations

import numpy as np
import torch


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
