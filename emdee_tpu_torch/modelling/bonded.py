"""Bonded-term parameter assignment: typed system + force field → tables
(counterpart of emdee_tpu/modelling/bonded.py).  The matching is the
reference's, in plain Python; the tables are the port's `BondTable`,
`AngleTable` and `TorsionTable` (atom ids int64), built in numpy and
moved to the caller's device, by default the CUDA card.

Completes the path the reference leaves dangling: it parses HarmonicBond /
HarmonicAngle / PeriodicTorsion tables (modelling.jl:193-197) but never
assigns them to a system's bonds.  Matching follows OpenMM conventions:

- rows match by per-position `type{i}` (exact atom type) or `class{i}`
  (atom-type class); empty string = wildcard,
- both orientations of a bond/angle/torsion are tried,
- exact (non-wildcard) matches win over wildcard matches,
- angles are enumerated from the bond graph (i–j–k with j the apex),
  proper torsions from bonded paths i–j–k–l,
- impropers follow the OpenMM ForceField-XML convention: the XML row's
  position 1 (`type1`/`class1`) names the CENTRAL atom; neighbor
  permutations fill positions 2-4; all-wildcard (score-0) matches are
  rejected.  The evaluation quad places the central atom third
  (i-j-center-l), the standard Amber improper-torsion layout.  (Best-effort:
  the reference parses impropers but defines no evaluation semantics,
  modelling.jl:193-197.)

`length_scale` converts the force field's length unit into simulation units
(OpenMM XMLs are nm/kJ/mol/rad; with Å coordinates pass 10.0 — k values are
rescaled accordingly).
"""

from __future__ import annotations

from itertools import permutations
from typing import List, Optional, Sequence

import numpy as np
import torch

from emdee_tpu_torch.core.types import resolve_device
from emdee_tpu_torch.modelling.forcefield import ForceField
from emdee_tpu_torch.potentials.bonded import (
    AngleTable,
    BondTable,
    BondedSystem,
    TorsionTable,
)


def _match_score(row: dict, positions: Sequence[str], types, classes) -> int:
    """−1 = no match; otherwise the number of exact (non-wildcard) slots."""
    score = 0
    for pos, (t, c) in zip(positions, zip(types, classes)):
        want_t = row.get(f"type{pos}", "")
        want_c = row.get(f"class{pos}", "")
        if want_t:
            if want_t != t:
                return -1
            score += 1
        elif want_c:
            if want_c != c:
                return -1
            score += 1
    return score


def _best_row(rows, types, classes, k_positions):
    best, best_score = None, -1
    for row in rows:
        for seq_t, seq_c in ((types, classes), (types[::-1], classes[::-1])):
            score = _match_score(row, k_positions, seq_t, seq_c)
            if score > best_score:
                best, best_score = row, score
    return best


def _pad8(k: int) -> int:
    return max(8, -(-k // 8) * 8)


def build_bonded_system(
    system,
    force_field: Optional[ForceField] = None,
    length_scale: float = 1.0,
    device=None,
) -> BondedSystem:
    """Assign bonded parameters to every bond/angle/torsion of `system`;
    the tables land on `device` (default: the CUDA card)."""
    device = resolve_device(device)
    ff = force_field or system.force_field
    if ff is None:
        raise ValueError("a ForceField is required to assign bonded parameters")
    n = len(system)
    types = system.ff_types
    classes = [ff.atom_types.get(t, {}).get("class", "") for t in types]

    neighbors: List[List[int]] = [[] for _ in range(n)]
    for a, b in system.bonds:
        neighbors[a].append(b)
        neighbors[b].append(a)

    ls = float(length_scale)

    # ---- bonds ----
    b_atoms, b_len, b_k = [], [], []
    for a, b in system.bonds:
        row = _best_row(
            ff.bond_types, (types[a], types[b]), (classes[a], classes[b]), ("1", "2")
        )
        if row is None:
            raise ValueError(
                f"no HarmonicBond parameters for bond {a}-{b} "
                f"({types[a]}-{types[b]})"
            )
        b_atoms.append((a, b))
        b_len.append(row["length"] * ls)
        b_k.append(row["k"] / ls**2)
    bonds = _bond_table(b_atoms, b_len, b_k, n, device)

    # ---- angles ----
    a_atoms, a_t0, a_k = [], [], []
    for j in range(n):
        nbrs = sorted(neighbors[j])
        for ai in range(len(nbrs)):
            for ak in range(ai + 1, len(nbrs)):
                i, k = nbrs[ai], nbrs[ak]
                row = _best_row(
                    ff.angle_types,
                    (types[i], types[j], types[k]),
                    (classes[i], classes[j], classes[k]),
                    ("1", "2", "3"),
                )
                if row is None:
                    continue  # many FFs omit some angles deliberately
                a_atoms.append((i, j, k))
                a_t0.append(row["angle"])
                a_k.append(row["k"])
    angles = _angle_table(a_atoms, a_t0, a_k, n, device)

    # ---- proper torsions ----
    t_atoms, t_rows = [], []
    seen = set()
    for j, k in system.bonds:
        for jj, kk in ((j, k), (k, j)):
            for i in neighbors[jj]:
                if i == kk:
                    continue
                for l in neighbors[kk]:
                    if l == jj or l == i:
                        continue
                    key = min((i, jj, kk, l), (l, kk, jj, i))
                    if key in seen:
                        continue
                    row = _best_row(
                        ff.dihedral_types,
                        tuple(types[x] for x in (i, jj, kk, l)),
                        tuple(classes[x] for x in (i, jj, kk, l)),
                        ("1", "2", "3", "4"),
                    )
                    if row is None:
                        continue
                    seen.add(key)
                    t_atoms.append((i, jj, kk, l))
                    t_rows.append(row)
    torsions = _torsion_table(t_atoms, t_rows, n, device)

    # ---- impropers (XML row: central atom first; evaluation: central third) ----
    i_atoms, i_rows = [], []
    for c in range(n):
        if len(neighbors[c]) < 3:
            continue
        nbrs = sorted(neighbors[c])
        # Prefilter rows on the central slot: position 1 must match atom c
        # (exactly or by class; wildcard-center rows stay in, but an
        # all-wildcard overall match is rejected below).
        rows_c = [
            row
            for row in ff.improper_types
            if _match_score(row, ("1",), (types[c],), (classes[c],)) >= 0
        ]
        if not rows_c:
            continue
        best_row, best_perm, best_score = None, None, 0
        for perm in permutations(nbrs, 3):
            match_order = (c,) + perm  # row positions 1-4
            for row in rows_c:
                score = _match_score(
                    row,
                    ("1", "2", "3", "4"),
                    tuple(types[x] for x in match_order),
                    tuple(classes[x] for x in match_order),
                )
                if score > best_score:
                    # Evaluation layout: i-j-center-l (Amber improper).
                    best_row = row
                    best_perm = (perm[0], perm[1], c, perm[2])
                    best_score = score
        if best_row is not None:
            i_atoms.append(best_perm)
            i_rows.append(best_row)
    impropers = _torsion_table(i_atoms, i_rows, n, device)

    return BondedSystem(
        bonds=bonds, angles=angles, torsions=torsions, impropers=impropers
    )


def _padded(rows, fill, cap, dtype) -> np.ndarray:
    """`rows` (count, …) as `dtype`, padded with `fill` rows to `cap`."""
    a = np.asarray(rows, dtype)
    return np.concatenate([a, np.full((cap - len(a),) + a.shape[1:], fill, dtype)])


def _on(device, **arrays) -> dict:
    return {name: torch.from_numpy(a).to(device) for name, a in arrays.items()}


def _bond_table(atoms, lengths, ks, n, device) -> Optional[BondTable]:
    if not atoms:
        return None
    cap = _pad8(len(atoms))
    return BondTable(**_on(
        device, atoms=_padded(atoms, n, cap, np.int64), length=_padded(lengths, 0.0, cap, np.float32),
        k=_padded(ks, 0.0, cap, np.float32), valid=np.arange(cap) < len(atoms),
    ))


def _angle_table(atoms, theta0s, ks, n, device) -> Optional[AngleTable]:
    if not atoms:
        return None
    cap = _pad8(len(atoms))
    return AngleTable(**_on(
        device, atoms=_padded(atoms, n, cap, np.int64), theta0=_padded(theta0s, 0.0, cap, np.float32),
        k=_padded(ks, 0.0, cap, np.float32), valid=np.arange(cap) < len(atoms),
    ))


def _torsion_table(atoms, rows, n, device, max_terms: int = 6) -> Optional[TorsionTable]:
    if not atoms:
        return None
    count = len(atoms)
    cap = _pad8(count)
    per = np.zeros((cap, max_terms), np.int32)
    phase = np.zeros((cap, max_terms), np.float32)
    k = np.zeros((cap, max_terms), np.float32)
    for r, row in enumerate(rows):
        for t in range(1, max_terms + 1):
            if f"periodicity{t}" in row and row.get(f"k{t}", 0.0):
                per[r, t - 1] = int(row[f"periodicity{t}"])
                phase[r, t - 1] = float(row[f"phase{t}"])
                k[r, t - 1] = float(row[f"k{t}"])
    return TorsionTable(**_on(
        device, atoms=_padded(atoms, n, cap, np.int64), periodicity=per, phase=phase, k=k,
        valid=np.arange(cap) < count,
    ))
