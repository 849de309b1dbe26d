"""The plain reference of the force field both configurations run: forces,
potential energy and virial of a periodic cube, from positions in atom order
and the system's own parameters, in float64 unless told otherwise.

Nonbonded, over every pair closer than the cutoff that is not excluded:
- Lennard-Jones with Lorentz-Berthelot mixing, sigma = (si + sj)/2,
  eps = sqrt(ei ej), E = 4 eps ((s/r)^12 - (s/r)^6) S(x), multiplied by the
  switch S(x) = 1 - 10x^3 + 15x^4 - 6x^5 of x = (r^2 - rs^2)/(rc^2 - rs^2)
  clamped to [0, 1] (EmDee's switched LJ, zero at and beyond rc);
- damped shifted-force Coulomb (Fennell and Gezelter 2006), where the system
  has charges: E = kC qi qj [erfc(a r)/r - erfc(a rc)/rc + g(rc)(r - rc)],
  g(r) = erfc(a r)/r^2 + 2a/sqrt(pi) exp(-a^2 r^2)/r, zero beyond rc.
Bonded: harmonic bonds E = k/2 (r - r0)^2 and harmonic angles
E = k/2 (theta - theta0)^2.

The virial is W = sum over pairs and bonds of r.F (angles add nothing: they
are unchanged by a uniform scaling), the convention P = (2K + W)/(3V).

`dtype` sets the precision of the pair and bonded arithmetic.  The
difference vectors are formed from the positions as given (float32 positions
stay float32 until then), and sums are taken in float64 whatever `dtype` is:
at torch.bfloat16 this is the control that a comparison has to fail.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from mdbench.reference.cells import CellTable, min_image


@dataclass
class ForceField:
    """Everything the reference needs of a system, in atom order."""

    box: float
    cutoff: float
    switch: float
    masses: torch.Tensor  # (N,)
    sigma: torch.Tensor  # (N,)
    epsilon: torch.Tensor  # (N,)
    charges: Optional[torch.Tensor] = None  # (N,)
    alpha: float = 0.0
    coulomb_constant: float = 1.0
    exclusions: Optional[torch.Tensor] = None  # (N, E) partner ids, -1 pad
    bonds: Optional[torch.Tensor] = None  # (B, 2)
    bond_k: Optional[torch.Tensor] = None
    bond_r0: Optional[torch.Tensor] = None
    angles: Optional[torch.Tensor] = None  # (A, 3), the centre atom in the middle
    angle_k: Optional[torch.Tensor] = None
    angle_theta0: Optional[torch.Tensor] = None


@dataclass
class Evaluation:
    forces: torch.Tensor  # (N, 3) float64
    energy: float
    virial: float
    virial_scale: float  # sum of |r.F| over the terms, the scale the virial's cancellation hides


def _lj(r2, sig, eps, ff: ForceField):
    """(E, -r dE/dr) of the switched LJ pair."""
    rs2, rc2 = ff.switch**2, ff.cutoff**2
    s6 = (sig * sig / r2) ** 3
    e_raw = 4.0 * eps * s6 * (s6 - 1.0)
    mre_raw = 24.0 * eps * s6 * (2.0 * s6 - 1.0)
    x = torch.clamp((r2 - rs2) / (rc2 - rs2), 0.0, 1.0)
    s = 1.0 - 10.0 * x**3 + 15.0 * x**4 - 6.0 * x**5
    minus_r_ds = 60.0 * x * x * (1.0 - x) ** 2 * r2 / (rc2 - rs2)
    return e_raw * s, mre_raw * s + e_raw * minus_r_ds


def _dsf(r2, qq, ff: ForceField):
    """(E, -r dE/dr) of the DSF Coulomb pair, before the cutoff mask."""
    a, rc = ff.alpha, ff.cutoff
    g_rc = math.erfc(a * rc) / rc**2 + 2.0 * a / math.sqrt(math.pi) * math.exp(-((a * rc) ** 2)) / rc
    r = torch.sqrt(r2)
    erfc_ar = torch.special.erfc(a * r)
    g = erfc_ar / r2 + (2.0 * a / math.sqrt(math.pi)) * torch.exp(-(a * r) ** 2) / r
    e = ff.coulomb_constant * qq * (erfc_ar / r - math.erfc(a * rc) / rc + g_rc * (r - rc))
    return e, ff.coulomb_constant * qq * r * (g - g_rc)


def _pairs(pos, ff: ForceField, dtype, out_f):
    """Accumulate the nonbonded forces into out_f; return (E, W, sum |W|)."""
    cells = CellTable(pos, ff.box, ff.cutoff)
    energy = virial = scale = 0.0
    params = [ff.sigma, ff.epsilon] + ([ff.charges] if ff.charges is not None else [])
    params = [p.to(dtype) for p in params]
    for cen, nbr in cells.blocks():
        ci, nj = cen.clamp(min=0), nbr.clamp(min=0)
        d = min_image(pos[ci][:, :, None, :] - pos[nj][:, None, :, :], ff.box).to(dtype)
        r2 = (d * d).sum(-1)
        ok = (cen[:, :, None] >= 0) & (nbr[:, None, :] >= 0) & (cen[:, :, None] != nbr[:, None, :])
        ok &= r2 < ff.cutoff**2
        if ff.exclusions is not None:
            ex = ff.exclusions[ci]  # (B, C, E)
            ok &= ~(ex[:, :, None, :] == nbr[:, None, :, None]).any(-1)
        r2 = torch.where(ok, r2, torch.ones((), dtype=dtype, device=r2.device))
        sig = 0.5 * (params[0][ci][:, :, None] + params[0][nj][:, None, :])
        eps = torch.sqrt(params[1][ci][:, :, None] * params[1][nj][:, None, :])
        e, mre = _lj(r2, sig, eps, ff)
        if ff.charges is not None:
            ec, mrec = _dsf(r2, params[2][ci][:, :, None] * params[2][nj][:, None, :], ff)
            e, mre = e + ec, mre + mrec
        e = torch.where(ok, e, 0.0)
        mre = torch.where(ok, mre, 0.0)
        f = ((mre / r2)[..., None] * d).double().sum(2)  # (B, C, 3) on the centres
        live = cen >= 0
        out_f.index_add_(0, ci[live], f[live])
        energy += 0.5 * float(e.double().sum())
        virial += 0.5 * float(mre.double().sum())
        scale += 0.5 * float(mre.double().abs().sum())
    return energy, virial, scale


def _bonded(pos, ff: ForceField, dtype, out_f):
    energy = virial = scale = 0.0
    if ff.bonds is not None and len(ff.bonds):
        i, j = ff.bonds[:, 0], ff.bonds[:, 1]
        d = min_image(pos[i] - pos[j], ff.box).to(dtype)
        r = torch.sqrt((d * d).sum(-1))
        k, r0 = ff.bond_k.to(dtype), ff.bond_r0.to(dtype)
        fi = ((-k * (r - r0) / r)[:, None] * d).double()
        out_f.index_add_(0, i, fi)
        out_f.index_add_(0, j, -fi)
        w = (-k * r * (r - r0)).double()
        energy += float((0.5 * k * (r - r0) ** 2).double().sum())
        virial += float(w.sum())
        scale += float(w.abs().sum())
    if ff.angles is not None and len(ff.angles):
        i, j, k_ = ff.angles[:, 0], ff.angles[:, 1], ff.angles[:, 2]
        a = min_image(pos[i] - pos[j], ff.box).to(dtype)
        b = min_image(pos[k_] - pos[j], ff.box).to(dtype)
        la, lb = torch.sqrt((a * a).sum(-1)), torch.sqrt((b * b).sum(-1))
        ah, bh = a / la[:, None], b / lb[:, None]
        cos_t = torch.clamp((ah * bh).sum(-1), -1.0, 1.0)
        theta = torch.arccos(cos_t)
        sin_t = torch.sqrt(1.0 - cos_t * cos_t)
        de = ff.angle_k.to(dtype) * (theta - ff.angle_theta0.to(dtype))
        fi = (-de / (la * sin_t))[:, None] * (cos_t[:, None] * ah - bh)
        fk = (-de / (lb * sin_t))[:, None] * (cos_t[:, None] * bh - ah)
        out_f.index_add_(0, i, fi.double())
        out_f.index_add_(0, k_, fk.double())
        out_f.index_add_(0, j, -(fi + fk).double())
        energy += float((0.5 * ff.angle_k.to(dtype) * (theta - ff.angle_theta0.to(dtype)) ** 2).double().sum())
    return energy, virial, scale


def evaluate(positions: torch.Tensor, ff: ForceField, dtype=torch.float64) -> Evaluation:
    """Forces, energy and virial at `positions` (N, 3)."""
    pos = positions.double() if dtype == torch.float64 else positions.float()
    forces = torch.zeros(pos.shape, dtype=torch.float64, device=pos.device)
    e1, w1, s1 = _pairs(pos, ff, dtype, forces)
    e2, w2, s2 = _bonded(pos, ff, dtype, forces)
    return Evaluation(forces, e1 + e2, w1 + w2, s1 + s2)
