"""The plain reference of the integrators the cells run: velocity Verlet
(kick, drift, kick), and after each step, where the traffic asks for it, the
Bussi-Donadio-Parrinello velocity rescale (CSVR; Bussi et al., J. Chem.
Phys. 126, 014101 (2007), eq. A7):

    alpha^2 = c + (1 - c) Kt/(Nf K) (R1^2 + S) + 2 R1 sqrt(c (1 - c) Kt/(Nf K)),

c = exp(-dt/tau), Kt = Nf kT/2, Nf = 3N - 3 (the zeroed total momentum),
R1 a standard normal and S = sum of Nf - 1 squared normals.  Both sides draw
R1 and S from one seeded torch.Generator in one order, a step at a time: R1
by `torch.randn((), float32)`, then S as 2 Gamma((Nf - 1)/2) by
`torch._standard_gamma` on a float32 shape, the protocol the system under
test documents for its thermostat.  So the reference, handed a copy of the
generator's state, draws the same numbers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mdbench.reference.forces import ForceField, evaluate


def csvr_draws(rng: torch.Generator, ndof: float, device):
    r1 = torch.randn((), generator=rng, dtype=torch.float32, device=device)
    shape = torch.full((), 0.5 * (float(torch.tensor(ndof, dtype=torch.float32)) - 1.0), dtype=torch.float32,
                       device=device)
    return float(r1), float(2.0 * torch._standard_gamma(shape, generator=rng))


def csvr_alpha(kin: float, r1: float, sum_r2: float, ndof: float, kT: float, dt: float, tau: float) -> float:
    c = math.exp(-dt / tau)
    factor = (1.0 - c) * 0.5 * ndof * kT / (ndof * kin)
    alpha2 = c + factor * (r1 * r1 + sum_r2) + 2.0 * r1 * math.sqrt(c * factor)
    return math.sqrt(max(alpha2, 0.0))


def velocity_verlet(positions, velocities, ff: ForceField, dt: float, steps: int, dtype=torch.float64,
                    csvr: Optional[dict] = None, rng: Optional[torch.Generator] = None, f0=None,
                    totals: Optional[list] = None):
    """(positions, velocities) after `steps` steps from (positions,
    velocities) in atom order; float64 state, force arithmetic in `dtype`.
    csvr: {"temperature", "tau", "kB"} with `rng` to rescale after each step;
    f0: the forces at `positions`, where the caller has them; totals: a list
    that gets (step, potential + kinetic energy) at the start and after each
    step."""
    x = positions.double().clone()
    v = velocities.double().clone()
    inv_m = (1.0 / ff.masses.double())[:, None]
    m = ff.masses.double()[:, None]
    ndof = 3.0 * len(x) - 3.0
    at = lambda x: evaluate(x if dtype == torch.float64 else x.float(), ff, dtype)  # noqa: E731
    ev = at(x) if f0 is None or totals is not None else None
    f = f0 if f0 is not None else ev.forces
    if totals is not None:
        totals.append((0, ev.energy + 0.5 * float((m * v * v).sum())))
    for i in range(steps):
        v = v + 0.5 * dt * f * inv_m
        x = x + dt * v
        ev = at(x)
        f = ev.forces
        v = v + 0.5 * dt * f * inv_m
        if csvr is not None:
            kin = 0.5 * float((m * v * v).sum())
            r1, s = csvr_draws(rng, ndof, x.device)
            v = v * csvr_alpha(kin, r1, s, ndof, csvr["kB"] * csvr["temperature"], dt, csvr["tau"])
        if totals is not None:
            totals.append((i + 1, ev.energy + 0.5 * float((m * v * v).sum())))
    return x, v
