"""Damped-shifted-force (DSF) Coulomb (counterpart of
emdee_tpu/potentials/coulomb.py; the functional form is documented there):

    g(r)  = erfc(αr)/r² + (2α/√π)·exp(−α²r²)/r
    E(r)  = kC·qᵢqⱼ·[ erfc(αr)/r − erfc(αrc)/rc + g(rc)·(r − rc) ]
    −r·E′ = kC·qᵢqⱼ·r·[ g(r) − g(rc) ]

with E(rc) = E′(rc) = 0.  The port evaluates the exact form with
`torch.special.erfc` and `torch.exp`, as the reference's XLA path does; the
reference's Pallas kernel uses a degree-10 fit instead
(pallas_cell_kernel.py `_dsf_polys`), which the port does not carry.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from emdee_tpu_torch.core.types import resolve_device

KJMOL_NM = 138.935456  # e²/(4πε0) in kJ/mol·nm
KJMOL_ANGSTROM = 1389.35456  # same, lengths in Å

_TWO_OVER_SQRT_PI = 1.1283791670955126


class DSFCoulomb(NamedTuple):
    """DSF constants (cutoff values precomputed in float64 on the host), as
    0-d float32 tensors."""

    alpha: torch.Tensor
    rc: torch.Tensor
    rc2: torch.Tensor
    e_shift: torch.Tensor  # erfc(α·rc)/rc
    f_shift: torch.Tensor  # g(rc)
    kc: torch.Tensor  # Coulomb constant

    @classmethod
    def create(cls, cutoff: float, alpha: float = 0.2, coulomb_constant: float = 1.0, device=None):
        """On `device`, by default the CUDA card (`resolve_device`)."""
        device = resolve_device(device)
        rc = float(cutoff)
        a = float(alpha)
        erfc_rc = math.erfc(a * rc)
        g_rc = erfc_rc / rc**2 + (2.0 * a / math.sqrt(math.pi)) * math.exp(-((a * rc) ** 2)) / rc
        f = lambda v: torch.tensor(np.float32(v), device=device)  # noqa: E731
        return cls(alpha=f(a), rc=f(rc), rc2=f(rc * rc), e_shift=f(erfc_rc / rc), f_shift=f(g_rc),
                   kc=f(coulomb_constant))


def coulomb_from_numpy(fields, device) -> DSFCoulomb:
    """Port `DSFCoulomb` from the six constants of a JAX `DSFCoulomb` taken
    to the host (`jax.device_get(model)`), bit for bit."""
    return DSFCoulomb(*(torch.tensor(np.float32(v), device=device) for v in fields))


def coulomb_consts(model: DSFCoulomb) -> tuple:
    """DSF constants as a host float tuple (alpha, rc, e_shift, f_shift,
    kc), the reference's form.  The port's force kernel reads the 0-d
    device tensors instead, so nothing waits for the device."""
    return tuple(float(v) for v in (model.alpha, model.rc, model.e_shift, model.f_shift, model.kc))


def coulomb_interaction(
    r2: torch.Tensor, model: DSFCoulomb, qi, qj
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E, −r·dE/dr) of the DSF pair at squared distance r², zero at and
    beyond the cutoff.  Callers mask invalid pairs by passing a safe r² and
    zeroing, as with the LJ pair function."""
    r = torch.sqrt(r2)
    rinv = 1.0 / r
    ar = model.alpha * r
    erfc_ar = torch.special.erfc(ar)
    gauss = _TWO_OVER_SQRT_PI * model.alpha * torch.exp(-ar * ar)
    g_r = erfc_ar * rinv * rinv + gauss * rinv
    qq = model.kc * qi * qj
    inside = r2 < model.rc2
    energy = qq * (erfc_ar * rinv - model.e_shift + model.f_shift * (r - model.rc))
    minus_rE = qq * r * (g_r - model.f_shift)
    return torch.where(inside, energy, 0.0), torch.where(inside, minus_rE, 0.0)
