"""The work of one force pass and one rebin, frozen: float32 operations
counted per pair inside the cutoff, and bytes each read once and written
once, per atom.  The pair counts are those of `chip_smoke.py` (`OPS_PER_PAIR`,
`mol_ops`, `mol_bytes`), copied here so that a later change to the program
cannot move the yardstick.  Bytes are counted per atom, not per slot of the
program's cell grid: the padding of a grid is the implementation's, and a
layout with fewer empty slots does less work, which a share should show."""

from __future__ import annotations

# float32 operations of one LJ pair inside the cutoff, each pair once with
# Newton's third law: difference 3, r^2 5, 1/r^2 1, sigma^6/r^6 and eps terms
# 5, switch argument 4, two Horner polynomials 20, the force factor 4, force
# and reaction 9.
OPS_PER_PAIR = 51
# A molecular pair adds the per-atom mixing 3, DSF Coulomb's force part 47
# (sqrt, 1/r, ar 3, erfc ~20, exp and its argument ~11, the Gaussian and
# g(r) 6, qq 3, the force term 4) and 3 per exclusion tag (compare, mask,
# subtract); each bonded pair inside the cutoff adds the bond force 4.
OPS_MIX, OPS_DSF_FORCE, OPS_TAG, OPS_BOND_FORCE = 3, 47, 3, 4
# Bytes of a force pass per atom: positions 12 in, forces 12 out, a valid
# flag 1 (LJ with uniform parameters).
LJ_BYTES_PER_ATOM = 12 + 1 + 12


def lj_force_pass(pairs: int, atoms: int) -> tuple:
    """(operations, bytes) of one LJ force pass."""
    return OPS_PER_PAIR * pairs, LJ_BYTES_PER_ATOM * atoms


def molecular_force_pass(pairs: int, bonded_pairs: int, e_tags: int, e_bonds: int, atoms: int) -> tuple:
    """(operations, bytes) of one molecular force pass: positions 12,
    sigma/2 and 2 sqrt(eps) 8, valid 1, charge 4, atom id 4, the exclusion
    tags 12 a tag and the bond weights 8 a bond tag in; forces 12 out."""
    ops = (OPS_PER_PAIR + OPS_MIX + OPS_DSF_FORCE + OPS_TAG * e_tags) * pairs + OPS_BOND_FORCE * bonded_pairs
    per_atom = 12 + 8 + 1 + 4 + 4 + 12 * e_tags + 8 * e_bonds + 12
    return ops, per_atom * atoms


def rebin(fields: int, atoms: int) -> int:
    """Bytes of one rebin: each float32 or int32 field of an atom read once
    and written once."""
    return 2 * 4 * fields * atoms
