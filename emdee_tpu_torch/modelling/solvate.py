"""Solvated-peptide system builder: protein-scale molecular fixtures
(counterpart of emdee_tpu/modelling/solvate.py; numpy only, the same PDB
text byte for byte).

The reference's modelling layer exists for protein force fields
(src/data/amber03.xml: 1957 types, 113 residues) yet ships no protein-scale
system.  This builder makes one from scratch: an extended poly-alanine chain
with zwitterionic termini (amber03's NALA/ALA/CALA graphs) solvated in a
TIP3P-style water lattice — geometry is approximate by construction and is
relaxed with `fire_minimize` before dynamics (the standard preparation step).

Nothing is read from the reference beyond the mounted force-field XMLs the
caller passes to `ForceField(*files)`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# One idealized ALA residue in a local frame; the i→i+1 repeat translation
# REPEAT places C(i)–N(i+1) at ~1.33 Å (extended backbone).  FIRE relaxation
# cleans up the rest.
_ALA_LOCAL = {
    "N": (0.00, 0.00, 0.00),
    "H": (-0.45, 0.88, 0.00),
    "CA": (1.21, -0.80, 0.00),
    "HA": (1.18, -1.45, 0.88),
    "CB": (1.28, -1.66, -1.26),
    "HB1": (0.38, -2.26, -1.33),
    "HB2": (2.16, -2.28, -1.28),
    "HB3": (1.30, -1.04, -2.14),
    "C": (2.45, 0.05, 0.00),
    "O": (2.47, 1.28, 0.04),
}
_REPEAT = np.array([3.63, -0.55, 0.0])
# N-terminal H1/H2/H3 replace H; C-terminal adds OXT.
_NTERM_H = {"H1": (-0.45, 0.88, 0.0), "H2": (-0.55, -0.55, 0.80), "H3": (-0.55, -0.55, -0.80)}
_OXT = (3.10, -0.65, -0.75)

# Standard-PDB water names (O/H1/H2) so the alias-regex bond perception
# finds the two O–H bonds without CONECT records.
_WATER_LOCAL = {
    "O": (0.0, 0.0, 0.0),
    "H1": (0.9572, 0.0, 0.0),
    "H2": (-0.2400, 0.9266, 0.0),
}


def _pdb_line(serial, name, resname, resid, xyz, het=False):
    rec = "HETATM" if het else "ATOM  "
    x, y, z = xyz
    return (
        f"{rec}{serial:5d} {name:<4s} {resname:<3s} A{resid:4d}    "
        f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          {name[0]:>2s}"
    )


def build_solvated_polyalanine(
    n_res: int = 12,
    box: float = 60.0,
    water_spacing: float = 3.11,
    buffer: float = 2.4,
    seed: int = 0,
) -> Tuple[str, int, int]:
    """PDB text for an extended poly-ALA chain solvated in a water lattice.

    Returns (pdb_text, n_peptide_atoms, n_waters).  Waters sit on a cubic
    lattice of side `water_spacing` (≈ liquid density), skipping sites
    within `buffer` Å of any peptide atom."""
    rng = np.random.default_rng(seed)
    lines = [
        f"CRYST1{box:9.3f}{box:9.3f}{box:9.3f}  90.00  90.00  90.00 P 1           1"
    ]
    serial = 0
    resid = 0
    peptide_xyz = []

    chain_span = (n_res - 1) * _REPEAT
    base0 = np.array([
        0.5 * (box - chain_span[0] - 3.0),
        0.5 * (box - chain_span[1]),
        0.5 * box,
    ])
    for i in range(n_res):
        resid += 1
        base = base0 + i * _REPEAT
        names = dict(_ALA_LOCAL)
        if i == 0:
            del names["H"]
            names.update(_NTERM_H)
        if i == n_res - 1:
            names["OXT"] = _OXT
        order = [nm for nm in (
            "N", "H1", "H2", "H3", "H", "CA", "HA", "CB", "HB1", "HB2", "HB3",
            "C", "O", "OXT",
        ) if nm in names]
        for nm in order:
            serial += 1
            xyz = base + np.asarray(names[nm])
            peptide_xyz.append(xyz)
            lines.append(_pdb_line(serial, nm, "ALA", resid, xyz))
    n_peptide = serial
    pep = np.asarray(peptide_xyz)

    n_side = int(np.floor(box / water_spacing))
    n_waters = 0
    for ix in range(n_side):
        for iy in range(n_side):
            for iz in range(n_side):
                o = (np.array([ix, iy, iz]) + 0.5) * water_spacing
                if o.max() > box or o.min() < 0:
                    continue
                if np.min(np.sum((pep - o) ** 2, axis=1)) < buffer * buffer:
                    continue
                resid += 1
                n_waters += 1
                # Random orientation: rotate the rigid water about a random
                # axis so the lattice carries no net dipole ordering.
                q = rng.normal(size=4)
                q /= np.linalg.norm(q)
                w, x, y, z = q
                rot = np.array([
                    [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                ])
                # ATOM records (standard-PDB): bond perception then applies
                # the HOH alias template (HETATM would need CONECT records).
                for nm in ("O", "H1", "H2"):
                    serial += 1
                    xyz = o + rot @ np.asarray(_WATER_LOCAL[nm])
                    lines.append(_pdb_line(serial, nm, "HOH", resid, xyz, het=False))
    lines.append("END")
    return "\n".join(lines) + "\n", n_peptide, n_waters
