"""Standard-PDB data tables: element masses, atom-name regex aliases, and
per-residue bond templates (counterpart of emdee_tpu/modelling/pdb_data.py).
The tables are the port's own copy of emdee_tpu/data/pdb_aliases.json,
byte for byte (data provenance: OpenMM residues.xml/pdbNames.xml; generated
by tools/gen_pdb_data.py).  Plays the role of the reference's load-time
PDB_MASSES / PDB_REGEX_CODES / PDB_STD_BONDS constants
(modelling.jl:205-218)."""

from __future__ import annotations

import json
import re
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Pattern, Tuple

_DATA = Path(__file__).resolve().parent.parent / "data" / "pdb_aliases.json"

# General element masses (amu) for non-standard residues, where the reference
# relies on Chemfiles' element perception.  Subset covering common biomolecular
# and materials elements.
ELEMENT_MASSES: Dict[str, float] = {
    "H": 1.008, "He": 4.0026, "Li": 6.94, "Be": 9.0122, "B": 10.81,
    "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998, "Ne": 20.180,
    "Na": 22.990, "Mg": 24.305, "Al": 26.982, "Si": 28.085, "P": 30.974,
    "S": 32.06, "Cl": 35.45, "Ar": 39.948, "K": 39.098, "Ca": 40.078,
    "Fe": 55.845, "Cu": 63.546, "Zn": 65.38, "Se": 78.971, "Br": 79.904,
    "I": 126.90, "Mn": 54.938, "Co": 58.933, "Ni": 58.693,
}


@lru_cache(maxsize=1)
def load_pdb_aliases() -> Tuple[Dict[str, float], Dict[int, Pattern], Dict[str, List[List[int]]]]:
    """(std element masses, regex-id → compiled pattern, residue → bond id pairs)."""
    data = json.loads(_DATA.read_text())
    masses = {k: float(v) for k, v in data["element_masses"].items()}
    regexes = {int(k): re.compile(v) for k, v in data["regex_codes"].items()}
    bonds = {k: [tuple(pair) for pair in v] for k, v in data["residue_bonds"].items()}
    return masses, regexes, bonds


def element_from_pdb(name: str, element_field: str = "") -> str:
    """Element symbol for a PDB atom: the explicit element column when
    present, else parsed from the atom name (digits stripped, first letters).
    """
    if element_field:
        sym = element_field.strip().capitalize()
        if sym in ELEMENT_MASSES:
            return sym
    stripped = re.sub(r"[^A-Za-z]", "", name)
    if not stripped:
        return ""
    two = stripped[:2].capitalize()
    if two in ELEMENT_MASSES and two not in ("Ca", "Cd", "Co", "Cu", "Np"):
        # Two-letter match, but biomolecule names like "CA" (α-carbon) are
        # carbon — prefer single-letter for the HCNOPS set.
        if stripped[0].upper() in "HCNOPS":
            return stripped[0].upper()
        return two
    one = stripped[0].upper()
    return one if one in ELEMENT_MASSES else ""
