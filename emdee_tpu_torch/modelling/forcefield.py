"""OpenMM-style force-field XML parsing (counterpart of
emdee_tpu/modelling/forcefield.py; the standard library and numpy only).

The Python re-design of the reference's ForceField layer (modelling.jl:30-203):
AtomTypes, Residues (with Patches and AllowPatch expansion), HarmonicBondForce,
HarmonicAngleForce, PeriodicTorsionForce (Proper + Improper, up to 6 terms),
NonbondedForce (with lj14scale / coulomb14scale).  Tables land in plain
NumPy/odict structures instead of DataFrames; residue templates carry their
canonically-labeled adjacency for matching (ResidueTemplate ctor semantics of
modelling.jl:16-27).

Name sanitization matches the reference (modelling.jl:83): "-"→"_", "'"→"p",
"*"→"a" — applied identically to template atom names and to PDB atom names so
regex/bond matching lines up.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from emdee_tpu_torch.modelling.graphs import canonical_form


def sanitized(name: str) -> str:
    return name.replace("-", "_").replace("'", "p").replace("*", "a")


@dataclass
class TemplateAtom:
    name: str
    type: str
    charge: float


@dataclass
class _RawResidue:
    """Mutable residue under construction (patch target)."""

    atoms: List[TemplateAtom] = field(default_factory=list)
    bonds: List[frozenset] = field(default_factory=list)  # sets of atom names
    external_bonds: List[str] = field(default_factory=list)

    def copy(self) -> "_RawResidue":
        return _RawResidue(
            atoms=[replace(a) for a in self.atoms],
            bonds=list(self.bonds),
            external_bonds=list(self.external_bonds),
        )

    # ---- patch operations, dispatched by XML element name + "!"-less ----
    def AddAtom(self, attrs):
        self.atoms.append(
            TemplateAtom(
                name=sanitized(attrs["name"]),
                type=attrs["type"],
                charge=float(attrs.get("charge", 0.0)),
            )
        )

    def AddBond(self, attrs):
        names = [
            sanitized(attrs[k])
            for k in ("atomName1", "atomName2")
            if k in attrs
        ] or [sanitized(v) for v in attrs.values()]
        self.bonds.append(frozenset(names))

    def AddExternalBond(self, attrs):
        self.external_bonds.append(sanitized(attrs["atomName"]))

    def ChangeAtom(self, attrs):
        name = sanitized(attrs["name"])
        for atom in self.atoms:
            if atom.name == name:
                atom.charge = float(attrs.get("charge", 0.0))
                atom.type = attrs["type"]
                return

    def RemoveAtom(self, attrs):
        name = sanitized(attrs["name"])
        self.atoms = [a for a in self.atoms if a.name != name]

    def RemoveBond(self, attrs):
        bond = frozenset(sanitized(attrs[k]) for k in ("atomName1", "atomName2"))
        self.bonds = [b for b in self.bonds if b != bond]

    def RemoveExternalBond(self, attrs):
        name = sanitized(attrs["atomName"])
        self.external_bonds = [x for x in self.external_bonds if x != name]


class ResidueTemplate:
    """Canonically-labeled residue template (modelling.jl:13-28).

    `atoms` are stored in canonical order; `adjacency` is the canonical
    adjacency matrix (colors = atom-type masses binned at 0.1)."""

    def __init__(self, raw: _RawResidue, type_masses: Dict[str, float]):
        n = len(raw.atoms)
        index = {atom.name: i for i, atom in enumerate(raw.atoms)}
        adj = np.zeros((n, n), bool)
        for bond in raw.bonds:
            names = sorted(bond)
            if len(names) != 2:
                continue
            i, j = index[names[0]], index[names[1]]
            adj[i, j] = adj[j, i] = True
        masses = [type_masses[atom.type] for atom in raw.atoms]
        order, canon = canonical_form(adj, masses)
        self.atoms: List[TemplateAtom] = [raw.atoms[i] for i in order]
        self.adjacency: np.ndarray = canon
        # Mass sequence in canonical order, binned at 0.1 (the same bin the
        # canonical colors use) — part of the match key, so graphs that are
        # isomorphic but chemically different (e.g. water O–H₂ vs an NH₂
        # cap N–H₂) never collide.
        self.canonical_masses: tuple = tuple(
            int(round(masses[i] / 0.1)) for i in order
        )
        self.external_bonds: List[str] = list(raw.external_bonds)

    @property
    def num_atoms(self) -> int:
        return len(self.atoms)


def _rows(xroot, section: str, entry: str) -> List[dict]:
    out = []
    for sec in xroot.findall(section):
        for item in sec.findall(entry):
            out.append(dict(item.attrib))
    return out


class ForceField:
    """Parsed force field: typed tables + canonical residue templates."""

    def __init__(self, *xml_files: str):
        """Parse one or more OpenMM-style force-field XMLs into one field.

        Multiple files compose additively (the OpenMM ForceField(*files)
        convention — e.g. a protein force field plus a water model): types,
        templates and parameter rows accumulate in file order; 1-4 scaling
        factors come from the first file that declares them and must agree
        across files."""
        self.atom_types = OrderedDict()
        self.templates = OrderedDict()
        self.bond_types = []
        self.angle_types = []
        self.dihedral_types = []
        self.improper_types = []
        self.nonbonded = {}
        self.lj14_scale = None
        self.coulomb14_scale = None
        for xml_file in xml_files:
            self._parse_one(xml_file)
        if self.lj14_scale is None:
            self.lj14_scale = 1.0
        if self.coulomb14_scale is None:
            self.coulomb14_scale = 1.0

        # Canonical-adjacency index: (n, packed bits) → template names.  The
        # reference scans every template per residue (modelling.jl:311); a
        # 500-residue system against amber03's 113 templates is 56k dense
        # matrix compares — hashing makes matching O(1) per residue.
        self._template_index: Dict[tuple, List[str]] = {}
        for name, tpl in self.templates.items():
            key = (
                tpl.num_atoms,
                np.packbits(tpl.adjacency).tobytes(),
                tpl.canonical_masses,
            )
            self._template_index.setdefault(key, []).append(name)

    def _parse_one(self, xml_file: str):
        xroot = ET.parse(xml_file).getroot()

        # Patches: name → list of (operation, attributes).
        patches: Dict[str, List[Tuple[str, dict]]] = {}
        for sec in xroot.findall("Patches"):
            for patch in sec.findall("Patch"):
                patches[patch.get("name")] = [
                    (child.tag, dict(child.attrib)) for child in patch
                ]

        for row in _rows(xroot, "AtomTypes", "Type"):
            self.atom_types[row["name"]] = {
                "class": row.get("class", ""),
                "element": row.get("element", ""),
                "mass": float(row.get("mass", 0.0)),
            }
        type_masses = {k: v["mass"] for k, v in self.atom_types.items()}

        for sec in xroot.findall("Residues"):
            for res_el in sec.findall("Residue"):
                raw = _RawResidue()
                names: List[str] = []
                for atom_el in res_el.findall("Atom"):
                    names.append(atom_el.get("name"))
                    raw.AddAtom(dict(atom_el.attrib))
                for bond_el in res_el.findall("Bond"):
                    attrs = dict(bond_el.attrib)
                    # Bonds may reference atoms by name or by index (from/to).
                    resolved = [
                        names[int(v)] if k in ("from", "to") else v
                        for k, v in attrs.items()
                    ]
                    raw.AddBond(
                        {"atomName1": resolved[0], "atomName2": resolved[1]}
                    )
                for ext_el in res_el.findall("ExternalBond"):
                    attrs = dict(ext_el.attrib)
                    if "from" in attrs:
                        attrs["atomName"] = names[int(attrs["from"])]
                    raw.AddExternalBond(attrs)
                res_name = res_el.get("name")
                self.templates[res_name] = ResidueTemplate(raw, type_masses)
                for allow in res_el.findall("AllowPatch"):
                    patch_name = allow.get("name")
                    patched = raw.copy()
                    for op, attrs in patches.get(patch_name, []):
                        getattr(patched, op)(attrs)
                    self.templates[f"{res_name}({patch_name})"] = ResidueTemplate(
                        patched, type_masses
                    )

        def floats(rows, keys):
            return [
                {k: (float(v) if k in keys else v) for k, v in row.items()}
                for row in rows
            ]

        self.bond_types += floats(
            _rows(xroot, "HarmonicBondForce", "Bond"), {"length", "k"}
        )
        self.angle_types += floats(
            _rows(xroot, "HarmonicAngleForce", "Angle"), {"angle", "k"}
        )
        torsion_float_keys = {f"phase{i}" for i in range(1, 7)} | {
            f"k{i}" for i in range(1, 7)
        }
        self.dihedral_types += floats(
            _rows(xroot, "PeriodicTorsionForce", "Proper"), torsion_float_keys
        )
        self.improper_types += floats(
            _rows(xroot, "PeriodicTorsionForce", "Improper"), torsion_float_keys
        )

        scaling = {}
        for sec in xroot.findall("NonbondedForce"):
            scaling = dict(sec.attrib)
            for row in sec.findall("Atom"):
                a = dict(row.attrib)
                self.nonbonded[a["type"]] = {
                    "charge": float(a.get("charge", 0.0)),
                    "sigma": float(a.get("sigma", 0.0)),
                    "epsilon": float(a.get("epsilon", 0.0)),
                }
        if scaling:
            lj14 = float(scaling.get("lj14scale", 1.0))
            c14 = float(scaling.get("coulomb14scale", 1.0))
            if self.lj14_scale is None:
                self.lj14_scale, self.coulomb14_scale = lj14, c14
            elif abs(lj14 - self.lj14_scale) > 1e-6 or abs(c14 - self.coulomb14_scale) > 1e-6:
                raise ValueError(
                    f"{xml_file}: 1-4 scaling ({lj14}, {c14}) conflicts with "
                    f"an earlier file ({self.lj14_scale}, {self.coulomb14_scale})"
                )

    def type_mass(self, type_name: str) -> float:
        return self.atom_types[type_name]["mass"]

    def match_template(
        self, canonical_adjacency: np.ndarray, canonical_masses=None
    ) -> List[str]:
        """All template names whose canonical (mass-colored) form equals the
        given one (the modelling.jl:311 matching rule).  canonical_masses:
        the residue's mass sequence in canonical order, binned at 0.1; when
        None, matching degrades to adjacency-only (pre-mass-key behavior)."""
        if canonical_masses is None:
            n = canonical_adjacency.shape[0]
            packed = np.packbits(np.asarray(canonical_adjacency, bool)).tobytes()
            return [
                name
                for key, names in self._template_index.items()
                for name in names
                if key[0] == n and key[1] == packed
            ]
        key = (
            canonical_adjacency.shape[0],
            np.packbits(np.asarray(canonical_adjacency, bool)).tobytes(),
            tuple(canonical_masses),
        )
        return list(self._template_index.get(key, []))
