"""Bonded potentials: harmonic bonds, harmonic angles, periodic torsions
(counterpart of emdee_tpu/potentials/bonded.py).

Functional forms (OpenMM conventions):
  bond:    E = ½ k (r − r₀)²
  angle:   E = ½ k (θ − θ₀)²
  torsion: E = Σ_n k_n (1 + cos(n φ − φ₀_n))

Tables are padded to static shapes with a validity mask.  Forces are the
reference's hand-derived gradients, as (index, row) pairs per term family
(`*_force_rows`) that callers fold into one scatter; `bonded_forces_analytic`
and `BondedSystem.force_fn` fold them with the fixed-order add of
`core/scatter.py` (no float atomics).  Invalid rows are masked with
`torch.where`, never by a 0/1 product: a pad row may gather a slot whose
coordinates are not finite.  Displacements are the minimum image of the raw
difference, d − L·round(d/L), as in the port's pair passes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from emdee_tpu_torch.core.scatter import add_plan, fixed_add


class BondTable(NamedTuple):
    atoms: torch.Tensor  # (B, 2) int64, pad rows = N
    length: torch.Tensor  # (B,) float32 r0
    k: torch.Tensor  # (B,) float32
    valid: torch.Tensor  # (B,) bool


class AngleTable(NamedTuple):
    atoms: torch.Tensor  # (A, 3) int64 — i, j (apex), k
    theta0: torch.Tensor  # (A,) float32 radians
    k: torch.Tensor  # (A,) float32
    valid: torch.Tensor  # (A,) bool


class TorsionTable(NamedTuple):
    atoms: torch.Tensor  # (T, 4) int64 — i, j, k, l
    periodicity: torch.Tensor  # (T, P) int32
    phase: torch.Tensor  # (T, P) float32 radians
    k: torch.Tensor  # (T, P) float32 (0 for unused terms)
    valid: torch.Tensor  # (T,) bool


_TABLE_DTYPES = {
    BondTable: {"atoms": np.int64, "length": np.float32, "k": np.float32, "valid": np.bool_},
    AngleTable: {"atoms": np.int64, "theta0": np.float32, "k": np.float32, "valid": np.bool_},
    TorsionTable: {"atoms": np.int64, "periodicity": np.int32, "phase": np.float32, "k": np.float32,
                   "valid": np.bool_},
}


def _idx(table, col: int, n: int) -> torch.Tensor:
    return torch.clamp(table.atoms[:, col], max=n - 1)


def _disp(positions, box, i, j):
    d = positions[i] - positions[j]
    return d - torch.round(d / box) * box


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1) + 1e-30)


def bond_energy(positions, box, table: BondTable):
    n = positions.shape[0]
    rv = _disp(positions, box, _idx(table, 0, n), _idx(table, 1, n))
    e = 0.5 * table.k * (_norm(rv) - table.length) ** 2
    return torch.sum(torch.where(table.valid, e, 0.0))


def _cos_angle(positions, box, table: AngleTable):
    n = positions.shape[0]
    j = _idx(table, 1, n)
    a = _disp(positions, box, _idx(table, 0, n), j)
    b = _disp(positions, box, _idx(table, 2, n), j)
    return a, b


def angle_energy(positions, box, table: AngleTable):
    a, b = _cos_angle(positions, box, table)
    cos_t = torch.sum(a * b, dim=-1) / torch.sqrt(torch.sum(a * a, dim=-1) * torch.sum(b * b, dim=-1) + 1e-30)
    theta = torch.arccos(torch.clamp(cos_t, -1.0, 1.0))
    e = 0.5 * table.k * (theta - table.theta0) ** 2
    return torch.sum(torch.where(table.valid, e, 0.0))


def _dihedral_frame(positions, box, table: TorsionTable):
    """(b1, b2, b3) with a non-degenerate frame substituted on invalid rows
    (their indices clip to one atom, whose zero vectors make 0/0)."""
    n = positions.shape[0]
    ii, jj, kk, ll = (_idx(table, c, n) for c in range(4))
    val = table.valid[:, None]
    eye = torch.eye(3, dtype=positions.dtype, device=positions.device)
    b1 = torch.where(val, _disp(positions, box, jj, ii), eye[0])
    b2 = torch.where(val, _disp(positions, box, kk, jj), eye[1])
    b3 = torch.where(val, _disp(positions, box, ll, kk), eye[2])
    return (ii, jj, kk, ll), b1, b2, b3


def torsion_energy(positions, box, table: TorsionTable):
    _, b1, b2, b3 = _dihedral_frame(positions, box, table)
    n1 = torch.linalg.cross(b1, b2, dim=-1)
    n2 = torch.linalg.cross(b2, b3, dim=-1)
    m1 = torch.linalg.cross(n1, b2 / torch.sqrt(torch.sum(b2 * b2, dim=-1, keepdim=True) + 1e-30), dim=-1)
    phi = torch.atan2(torch.sum(m1 * n2, dim=-1), torch.sum(n1 * n2, dim=-1))
    e = torch.sum(table.k * (1.0 + torch.cos(table.periodicity * phi[:, None] - table.phase)), dim=-1)
    return torch.sum(torch.where(table.valid, e, 0.0))


def bond_virial(positions, box, table: BondTable):
    """Scalar bond virial Σ −r·dE/dr = Σ −k·r·(r − r₀) (the engine's pair
    convention, so P = (2K + W)/(3V) stays exact with bonded terms)."""
    n = positions.shape[0]
    r = _norm(_disp(positions, box, _idx(table, 0, n), _idx(table, 1, n)))
    return torch.sum(torch.where(table.valid, -table.k * r * (r - table.length), 0.0))


def bond_force_rows(positions, box, table: BondTable):
    """(idx, rows) of the bond forces: f_i = −k(r−r0)·r̂, f_j = −f_i."""
    n = positions.shape[0]
    i, j = _idx(table, 0, n), _idx(table, 1, n)
    rv = _disp(positions, box, i, j)
    r = _norm(rv)
    f_i = torch.where(table.valid[:, None], (-table.k * (r - table.length) / r)[:, None] * rv, 0.0)
    return torch.cat([i, j]), torch.cat([f_i, -f_i])


def angle_force_rows(positions, box, table: AngleTable):
    """(idx, rows) of the angle forces; ∂θ/∂x_i = (cosθ·â − b̂)/(|a| sinθ)."""
    n = positions.shape[0]
    i, j, k = (_idx(table, c, n) for c in range(3))
    a, b = _cos_angle(positions, box, table)
    la, lb = _norm(a), _norm(b)
    ah = a / la[:, None]
    bh = b / lb[:, None]
    cos_t = torch.clamp(torch.sum(ah * bh, dim=-1), -1.0, 1.0)
    theta = torch.arccos(cos_t)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-12))
    d_e = table.k * (theta - table.theta0)
    gi = (cos_t[:, None] * ah - bh) / (la * sin_t)[:, None]
    gk = (cos_t[:, None] * bh - ah) / (lb * sin_t)[:, None]
    val = table.valid[:, None]
    f_i = torch.where(val, -d_e[:, None] * gi, 0.0)
    f_k = torch.where(val, -d_e[:, None] * gk, 0.0)
    return torch.cat([i, k, j]), torch.cat([f_i, f_k, -(f_i + f_k)])


def torsion_force_rows(positions, box, table: TorsionTable):
    """(idx, rows) of the torsion forces, the reference's dihedral gradient
    for φ = atan2((n1×b̂2)·n2, n1·n2) with b1 = x_j − x_i:
    ∂φ/∂x_i = +|b2|/|n1|²·n1, ∂φ/∂x_l = −|b2|/|n2|²·n2, f_j and f_k from
    torque balance."""
    (ii, jj, kk, ll), b1, b2, b3 = _dihedral_frame(positions, box, table)
    n1 = torch.linalg.cross(b1, b2, dim=-1)
    n2 = torch.linalg.cross(b2, b3, dim=-1)
    l2 = _norm(b2)
    m1 = torch.linalg.cross(n1, b2 / l2[:, None], dim=-1)
    phi = torch.atan2(torch.sum(m1 * n2, dim=-1), torch.sum(n1 * n2, dim=-1))
    d_e = -torch.sum(table.k * table.periodicity * torch.sin(table.periodicity * phi[:, None] - table.phase), dim=-1)
    inv_n1 = 1.0 / (torch.sum(n1 * n1, dim=-1) + 1e-30)
    inv_n2 = 1.0 / (torch.sum(n2 * n2, dim=-1) + 1e-30)
    dphi_di = (l2 * inv_n1)[:, None] * n1
    dphi_dl = (-(l2 * inv_n2))[:, None] * n2
    s12 = (torch.sum(b1 * b2, dim=-1) / (l2 * l2))[:, None]
    s32 = (torch.sum(b3 * b2, dim=-1) / (l2 * l2))[:, None]
    dphi_dj = -(1.0 + s12) * dphi_di + s32 * dphi_dl
    dphi_dk = s12 * dphi_di - (1.0 + s32) * dphi_dl
    val = table.valid[:, None]
    rows = [torch.where(val, -d_e[:, None] * g, 0.0) for g in (dphi_di, dphi_dj, dphi_dk, dphi_dl)]
    return torch.cat([ii, jj, kk, ll]), torch.cat(rows)


class BondedSystem(NamedTuple):
    """All bonded terms of a typed system (static-shape tables)."""

    bonds: Optional[BondTable]
    angles: Optional[AngleTable]
    torsions: Optional[TorsionTable]
    impropers: Optional[TorsionTable]

    def energy(self, positions, box):
        e = torch.zeros((), dtype=positions.dtype, device=positions.device)
        for table, fn in ((self.bonds, bond_energy), (self.angles, angle_energy),
                          (self.torsions, torsion_energy), (self.impropers, torsion_energy)):
            if table is not None:
                e = e + fn(positions, box, table)
        return e

    def virial(self, positions, box):
        """Total scalar virial of the bonded terms: only the bond lengths
        contribute (angles and torsions are invariant under isotropic
        scaling)."""
        w = torch.zeros((), dtype=positions.dtype, device=positions.device)
        if self.bonds is not None:
            w = w + bond_virial(positions, box, self.bonds)
        return w

    def force_fn(self):
        """forces(positions, box) = −∇E by the hand-derived gradients
        (`bonded_forces_analytic`)."""
        return lambda positions, box: bonded_forces_analytic(positions, box, self)

    def remap(self, index_map):
        """Tables with every atom index mapped through `index_map` (e.g. the
        per-rebin atom→slot binding; pad rows map through its last row)."""
        last = index_map.shape[0] - 1
        re = lambda t: None if t is None else t._replace(  # noqa: E731
            atoms=index_map[torch.clamp(t.atoms, max=last)].to(torch.int64))
        return BondedSystem(bonds=re(self.bonds), angles=re(self.angles),
                            torsions=re(self.torsions), impropers=re(self.impropers))


def bonded_force_rows(positions, box, system: BondedSystem):
    """Concatenated (idx, rows) of every bonded term family, for callers
    that fold them, with other slot-space rows, into one scatter."""
    idxs, rows = [], []
    for table, fn in ((system.bonds, bond_force_rows), (system.angles, angle_force_rows),
                      (system.torsions, torsion_force_rows), (system.impropers, torsion_force_rows)):
        if table is not None:
            i, r = fn(positions, box, table)
            idxs.append(i)
            rows.append(r)
    if not idxs:
        return (torch.zeros((0,), dtype=torch.int64, device=positions.device),
                positions.new_zeros((0, positions.shape[-1])))
    return torch.cat(idxs), torch.cat(rows)


def bonded_forces_analytic(positions, box, system: BondedSystem):
    """−∇E of all bonded terms by the hand gradients, folded in a fixed
    order."""
    idx, rows = bonded_force_rows(positions, box, system)
    return fixed_add(torch.zeros_like(positions), add_plan(idx, positions.shape[0]), rows)


def bonded_from_numpy(system, device) -> Optional[BondedSystem]:
    """Port `BondedSystem` from a JAX `BondedSystem` taken to the host
    (`jax.device_get(system)`, tables of numpy arrays, or None)."""
    if system is None:
        return None

    def table(cls, t):
        if t is None:
            return None
        return cls(**{name: torch.from_numpy(np.array(getattr(t, name), dtype=dt)).to(device)
                      for name, dt in _TABLE_DTYPES[cls].items()})

    return BondedSystem(
        bonds=table(BondTable, system.bonds), angles=table(AngleTable, system.angles),
        torsions=table(TorsionTable, system.torsions), impropers=table(TorsionTable, system.impropers),
    )
