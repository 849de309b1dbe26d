"""The reference's hand-derived forces and virial against autograd of a
brute-force energy over all pairs, in float64."""

import math

import pytest
import torch

from mdbench.reference.forces import ForceField, evaluate
from mdbench.systems import lj_melt, water_box


def _brute(pos, ff: ForceField):
    """(energy, virial) over all pairs (minimum image) and bonded terms,
    written out plainly; the forces come from autograd."""
    n = len(pos)
    i, j = torch.triu_indices(n, n, 1)
    d = pos[i] - pos[j]
    d = d - ff.box * torch.round(d / ff.box)
    r2 = (d * d).sum(-1)
    keep = r2 < ff.cutoff**2
    if ff.exclusions is not None:
        keep &= ~(ff.exclusions[i] == j[:, None]).any(-1)
    i, j, r2 = i[keep], j[keep], r2[keep]
    r = torch.sqrt(r2)
    sig = 0.5 * (ff.sigma[i] + ff.sigma[j])
    eps = torch.sqrt(ff.epsilon[i] * ff.epsilon[j])
    x = torch.clamp((r2 - ff.switch**2) / (ff.cutoff**2 - ff.switch**2), 0, 1)
    s = 1 - 10 * x**3 + 15 * x**4 - 6 * x**5
    sr6 = torch.where(sig > 0, (sig / r) ** 6, torch.zeros_like(r))
    e = 4 * eps * (sr6 * sr6 - sr6) * s
    if ff.charges is not None:
        a, rc = ff.alpha, ff.cutoff
        g_rc = math.erfc(a * rc) / rc**2 + 2 * a / math.sqrt(math.pi) * math.exp(-(a * rc) ** 2) / rc
        e = e + ff.coulomb_constant * ff.charges[i] * ff.charges[j] * (
            torch.special.erfc(a * r) / r - math.erfc(a * rc) / rc + g_rc * (r - rc))
    energy = e.sum()
    rr = r.detach().requires_grad_(True)
    (de_dr,) = torch.autograd.grad(_pair_energy_of_r(rr, sig, eps, ff, i, j).sum(), rr)
    virial = (-rr * de_dr).sum()
    if ff.bonds is not None:
        b = pos[ff.bonds[:, 0]] - pos[ff.bonds[:, 1]]
        b = b - ff.box * torch.round(b / ff.box)
        rb = b.norm(dim=-1)
        energy = energy + (0.5 * ff.bond_k * (rb - ff.bond_r0) ** 2).sum()
        virial = virial + (-ff.bond_k * rb * (rb - ff.bond_r0)).sum().detach()
        u = pos[ff.angles[:, 0]] - pos[ff.angles[:, 1]]
        v = pos[ff.angles[:, 2]] - pos[ff.angles[:, 1]]
        u, v = (w - ff.box * torch.round(w / ff.box) for w in (u, v))
        theta = torch.arccos((u * v).sum(-1) / (u.norm(dim=-1) * v.norm(dim=-1)))
        energy = energy + (0.5 * ff.angle_k * (theta - ff.angle_theta0) ** 2).sum()
    return energy, float(virial.detach())


def _pair_energy_of_r(r, sig, eps, ff, i, j):
    r2 = r * r
    x = torch.clamp((r2 - ff.switch**2) / (ff.cutoff**2 - ff.switch**2), 0, 1)
    s = 1 - 10 * x**3 + 15 * x**4 - 6 * x**5
    sr6 = torch.where(sig > 0, (sig / r) ** 6, torch.zeros_like(r))
    e = 4 * eps * (sr6 * sr6 - sr6) * s
    if ff.charges is not None:
        a, rc = ff.alpha, ff.cutoff
        g_rc = math.erfc(a * rc) / rc**2 + 2 * a / math.sqrt(math.pi) * math.exp(-(a * rc) ** 2) / rc
        e = e + ff.coulomb_constant * ff.charges[i] * ff.charges[j] * (
            torch.special.erfc(a * r) / r - math.erfc(a * rc) / rc + g_rc * (r - rc))
    return e


def _lj_system():
    pos, box = lj_melt.fcc(5, 0.8442, "cpu")
    pos = pos + 0.08 * torch.randn(pos.shape, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    n = len(pos)
    one = torch.ones(n, dtype=torch.float64)
    return pos, ForceField(box=box, cutoff=2.5, switch=2.0, masses=one, sigma=one, epsilon=one)


def _water_system():
    import json
    from pathlib import Path

    cfg = json.loads((Path(__file__).parent / "data" / "configs" / "water-tiny.json").read_text())
    pos, box = water_box.lattice_waters(cfg, torch.Generator().manual_seed(4), "cpu")
    pos = pos + 0.02 * torch.randn(pos.shape, generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    n_w = len(pos) // 3
    bonds, angles, _ = water_box.topology(n_w, "cpu")
    per = lambda o, h: water_box.per_atom(n_w, o, h, "cpu")  # noqa: E731
    full = lambda v, like: torch.full((len(like),), float(v), dtype=torch.float64)  # noqa: E731
    return pos, ForceField(
        box=box, cutoff=cfg["cutoff"], switch=cfg["switch"], masses=per(cfg["mass_o"], cfg["mass_h"]),
        sigma=per(cfg["sigma_o"], 0.0), epsilon=per(cfg["epsilon_o"], 0.0),
        charges=per(cfg["charge_o"], cfg["charge_h"]), alpha=cfg["alpha"],
        coulomb_constant=cfg["coulomb_constant"], exclusions=water_box.exclusion_table(n_w, "cpu"), bonds=bonds,
        bond_k=full(cfg["bond_k"], bonds), bond_r0=full(cfg["bond_r0"], bonds), angles=angles,
        angle_k=full(cfg["angle_k"], angles), angle_theta0=full(cfg["angle_theta0"], angles))


@pytest.mark.parametrize("system", [_lj_system, _water_system], ids=["lj", "water"])
def test_forces_energy_virial_match_autograd(system):
    pos, ff = system()
    got = evaluate(pos, ff)
    x = pos.clone().requires_grad_(True)
    energy, virial = _brute(x, ff)
    (grad,) = torch.autograd.grad(energy, x)
    scale = float(grad.abs().max())
    assert float((got.forces + grad).abs().max()) <= 1e-9 * scale
    assert got.energy == pytest.approx(float(energy.detach()), rel=1e-11, abs=1e-9)
    assert got.virial == pytest.approx(virial, rel=1e-9, abs=1e-9 * got.virial_scale)


def test_bfloat16_control_is_far_from_float64():
    pos, ff = _lj_system()
    hi, lo = evaluate(pos, ff), evaluate(pos.float(), ff, torch.bfloat16)
    gap = float((hi.forces - lo.forces).norm(dim=-1).max()) / float(hi.forces.norm(dim=-1).max())
    assert gap > 1e-3
