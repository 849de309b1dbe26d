"""System construction: structure file → typed, charged, bond-perceived system
(counterpart of emdee_tpu/modelling/system.py; the host side is numpy, and
only the bridge to the compute layer makes tensors).

The re-design of the reference's `System(file, force_field)` pipeline
(modelling.jl:235-349):

1. parse the PDB (or XYZ) natively — names sanitized like template names,
2. element masses: standard-PDB residues get table masses via the [HCNOPS]
   regex rule (modelling.jl:259-265); HETATM residues get periodic-table
   masses from the element column,
3. bond perception: explicit file bonds are kept for residues with any
   non-standard atom (modelling.jl:267-271); standard residues get template
   bonds by regex alias matching, including inter-residue backbone links with
   chain-id break detection (modelling.jl:272-295),
4. per-residue adjacency → colored canonical form (masses as colors) →
   force-field template matched by canonical-adjacency equality, with
   `disambiguation` for multi-matches (modelling.jl:306-328),
5. ff types and charges assigned through the canonical order
   (modelling.jl:323-327).

Unlike the reference — whose `System` output (a Chemfiles Frame) is never
consumable by its GPU kernel (SURVEY.md §1 "disconnected layers") — this
System bridges straight to the device: `lj_params()`, `exclusions()`,
`make_state()` produce the arrays the nonbonded kernels and integrators eat.
`lj_params()` and `make_state()` build their tensors on the CUDA card
unless the caller names a device.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from emdee_tpu_torch.modelling.forcefield import ForceField, sanitized
from emdee_tpu_torch.modelling.graphs import canonical_form, exclusion_table
from emdee_tpu_torch.modelling.pdb_data import (
    ELEMENT_MASSES,
    element_from_pdb,
    load_pdb_aliases,
)

_HCNOPS = re.compile(r"[HCNOPS]")


@dataclass(init=False)
class System:
    """Typed molecular system, ready for both analysis and device upload.

    Construction mirrors the reference's spelling (modelling.jl:235):
    ``System("file.pdb", ff)`` builds from a structure file (a shim over
    `System.from_file`), while keyword construction fills the dataclass
    fields directly (so `dataclasses.replace` and serialization keep
    working).
    """

    names: List[str]
    resnames: List[str]
    residue_spans: List[Tuple[int, int]]
    positions: np.ndarray  # (N, 3) float64, input units (Å for PDB)
    velocities: np.ndarray  # (N, 3) float64
    masses: np.ndarray  # (N,) float64 amu
    bonds: List[Tuple[int, int]]
    ff_types: List[str]
    charges: np.ndarray  # (N,) float64 e
    box_lengths: Optional[np.ndarray]
    force_field: Optional[ForceField] = None

    def __init__(self, *args, **kwargs):
        if args and isinstance(args[0], (str, bytes)):
            built = build_system(*args, **kwargs)
            self.__dict__.update(built.__dict__)
            return
        # Field-wise construction (what @dataclass would generate); also what
        # `dataclasses.replace` calls.
        fields = [
            "names", "resnames", "residue_spans", "positions", "velocities",
            "masses", "bonds", "ff_types", "charges", "box_lengths",
        ]
        for name, value in zip(fields, args):
            if name in kwargs:
                raise TypeError(f"System() got multiple values for {name!r}")
            kwargs[name] = value
        self.force_field = kwargs.pop("force_field", None)
        missing = [f for f in fields if f not in kwargs]
        if missing:
            raise TypeError(f"System() missing required fields: {missing}")
        for name in fields:
            setattr(self, name, kwargs.pop(name))
        if kwargs:
            raise TypeError(f"System() got unexpected fields: {sorted(kwargs)}")

    @classmethod
    def from_file(
        cls,
        file: str,
        force_field: Optional["ForceField"] = None,
        disambiguation: Optional[Dict[int, str]] = None,
    ) -> "System":
        """Build a System from a PDB/XYZ structure file (the explicit
        spelling of the reference-style ``System(file, ff)`` constructor)."""
        return build_system(file, force_field, disambiguation)

    def __len__(self) -> int:
        return len(self.names)

    def count_residues(self) -> int:
        return len(self.residue_spans)

    # ---- the bridge to the compute layer (absent in the reference) ----

    def lj_params(self, length_scale: float = 1.0, device=None):
        """Per-atom (σ/2, 2√ε) from the force field's NonbondedForce table,
        on `device` (default: the CUDA card), formed in float32 numpy by
        `lennard_jones_atom`.

        length_scale converts the FF's length unit into simulation units
        (OpenMM XMLs use nm; PDB coordinates are Å → pass 10.0)."""
        from emdee_tpu_torch.potentials.lennard_jones import lennard_jones_atom

        if self.force_field is None:
            raise ValueError("System was built without a force field")
        nb = self.force_field.nonbonded
        sigma = np.array([nb[t]["sigma"] for t in self.ff_types]) * length_scale
        eps = np.array([nb[t]["epsilon"] for t in self.ff_types])
        return lennard_jones_atom(eps, sigma, device=device)

    def exclusions(self, pad_to: Optional[int] = None, coulomb: bool = False):
        """(pairs, lj_scales) — or (pairs, lj_scales, coulomb_scales) with
        coulomb=True (independent coulomb14scale, modelling.jl:198-200)."""
        lj14 = self.force_field.lj14_scale if self.force_field else 1.0
        pairs, lj_scales = exclusion_table(len(self), self.bonds, lj14, pad_to=pad_to)
        if not coulomb:
            return pairs, lj_scales
        c14 = self.force_field.coulomb14_scale if self.force_field else 1.0
        _, coulomb_scales = exclusion_table(len(self), self.bonds, c14, pad_to=pad_to)
        return pairs, lj_scales, coulomb_scales

    def make_state(self, velocities=None, device=None):
        """The portable engine's `State` of this system on `device` (default:
        the CUDA card): positions, velocities (the given ones, else the
        system's), masses and the cubic box edge."""
        from emdee_tpu_torch.core.types import make_state

        if self.box_lengths is None:
            raise ValueError("System has no box — set box_lengths first")
        box = float(self.box_lengths[0])
        if not np.allclose(self.box_lengths, box):
            raise NotImplementedError("non-cubic boxes not yet supported")
        return make_state(
            self.positions,
            velocities if velocities is not None else self.velocities,
            box=box,
            masses=self.masses,
            device=device,
        )


def _std_residue_bonds(
    resname: str,
    atom_names: List[str],
    atom_indices: List[int],
    prev_names: List[str],
    prev_indices: List[int],
) -> List[Tuple[int, int]]:
    """Standard-PDB bonds for one residue by regex alias matching, searching
    the previous residue's ("_"-prefixed) names too for backbone links
    (the modelling.jl:272-295 scheme)."""
    _, regex_codes, std_bonds = load_pdb_aliases()
    if resname not in std_bonds:
        return []
    combined_names = prev_names + atom_names
    combined_indices = prev_indices + atom_indices
    bonds = []
    for id1, id2 in std_bonds[resname]:
        r1, r2 = regex_codes.get(id1), regex_codes.get(id2)
        if r1 is None or r2 is None:
            continue
        i = next((k for k, nm in enumerate(combined_names) if r1.search(nm)), None)
        j = next((k for k, nm in enumerate(combined_names) if r2.search(nm)), None)
        if i is not None and j is not None:
            bonds.append((combined_indices[i], combined_indices[j]))
    return bonds


def build_system(
    file: str,
    force_field: Optional[ForceField] = None,
    disambiguation: Optional[Dict[int, str]] = None,
) -> System:
    """Read a structure file and (when a force field is given) type it."""
    disambiguation = disambiguation or {}
    if str(file).lower().endswith(".xyz"):
        from emdee_tpu_torch.io.xyz import read_xyz_frame

        frame_xyz = read_xyz_frame(file)
        names = [sanitized(n) for n in frame_xyz.names]
        positions = frame_xyz.positions
        n = len(names)
        masses = np.array(
            [ELEMENT_MASSES.get(element_from_pdb(nm), 1.0) for nm in names]
        )
        return System(
            names=names,
            resnames=["UNK"] * n,
            residue_spans=[(0, n)],
            positions=positions,
            # Velocities ride along when the file carries them (the reference
            # reads them from its I/O frame, modelling.jl:240; the PDB format
            # itself has no velocity records, so PDB systems start at rest).
            velocities=(
                frame_xyz.velocities
                if frame_xyz.velocities is not None
                else np.zeros_like(positions)
            ),
            masses=masses,
            bonds=[],
            ff_types=[""] * n,
            charges=np.zeros(n),
            box_lengths=None,
            force_field=force_field,
        )

    from emdee_tpu_torch.io.pdb import read_pdb

    frame = read_pdb(file)
    n = frame.num_atoms
    names = [sanitized(nm) for nm in frame.names]
    spans = frame.residue_spans()
    num_res = len(spans)
    std_masses, _, std_bonds_table = load_pdb_aliases()

    # A residue is "standard PDB" when written as ATOM records (the Chemfiles
    # is_standard_pdb flag the reference reads, modelling.jl:259).
    res_is_std = [not frame.is_hetatm[s:e].any() for s, e in spans]
    atom_res = np.zeros(n, np.int64)
    for r, (s, e) in enumerate(spans):
        atom_res[s:e] = r

    # Masses.
    masses = np.zeros(n)
    for idx in range(n):
        r = atom_res[idx]
        if res_is_std[r]:
            match = _HCNOPS.search(element_from_pdb(names[idx], frame.elements[idx]) or names[idx])
            if match is None:
                match = _HCNOPS.search(names[idx])
            if match is None:
                raise ValueError(f"cannot infer element of standard-PDB atom {names[idx]}")
            masses[idx] = std_masses[match.group(0)]
        else:
            elem = element_from_pdb(names[idx], frame.elements[idx])
            masses[idx] = ELEMENT_MASSES.get(elem, 0.0)
            if masses[idx] == 0.0:
                raise ValueError(
                    f"cannot infer element/mass of atom {names[idx]} "
                    f"in residue {frame.resnames[r]}"
                )

    # Bonds: keep explicit bonds unless *all* atoms are in standard residues.
    bonds: List[Tuple[int, int]] = [
        (a, b)
        for (a, b) in frame.bonds
        if not (res_is_std[atom_res[a]] and res_is_std[atom_res[b]])
    ]
    chain_id = None
    prev_indices: List[int] = []
    prev_names: List[str] = []
    for r, (s, e) in enumerate(spans):
        if not res_is_std[r]:
            continue
        atom_indices = list(range(s, e))
        atom_names = [names[i] for i in atom_indices]
        this_chain = frame.chainids[s]
        if this_chain != chain_id:
            chain_id = this_chain
            prev_indices, prev_names = [], []
        bonds.extend(
            _std_residue_bonds(
                frame.resnames[s], atom_names, atom_indices, prev_names, prev_indices
            )
        )
        prev_indices = atom_indices
        prev_names = ["_" + nm for nm in atom_names]

    # Deduplicate.
    bonds = sorted({(min(a, b), max(a, b)) for a, b in bonds})

    ff_types = [""] * n
    charges = np.zeros(n)
    if force_field is not None:
        # Per-residue adjacency → canonical form → template match.
        bond_by_res: Dict[int, List[Tuple[int, int]]] = {r: [] for r in range(num_res)}
        for a, b in bonds:
            if atom_res[a] == atom_res[b]:
                bond_by_res[atom_res[a]].append((a, b))
        for r, (s, e) in enumerate(spans):
            size = e - s
            adj = np.zeros((size, size), bool)
            for a, b in bond_by_res[r]:
                adj[a - s, b - s] = adj[b - s, a - s] = True
            order, canon = canonical_form(adj, masses[s:e])
            canon_masses = tuple(
                int(round(masses[s + i] / 0.1)) for i in order
            )
            matches = force_field.match_template(canon, canon_masses)
            resname = frame.resnames[s]
            if not matches:
                raise ValueError(
                    f"no force-field template matched residue {r + 1} ({resname})"
                )
            if len(matches) > 1:
                choice = disambiguation.get(r + 1)
                if choice is None:
                    raise ValueError(
                        f"multiple templates {matches} matched residue "
                        f"{r + 1} ({resname}); pass disambiguation={{{r + 1}: name}}"
                    )
                if choice not in matches:
                    raise ValueError(
                        f"disambiguation {choice!r} for residue {r + 1} "
                        f"({resname}) is not among {matches}"
                    )
                matches = [choice]
            template = force_field.templates[matches[0]]
            for local_pos, tpl_atom in zip(order, template.atoms):
                ff_types[s + local_pos] = tpl_atom.type
                charges[s + local_pos] = tpl_atom.charge

    velocities = np.zeros_like(frame.positions)
    return System(
        names=names,
        resnames=[frame.resnames[s] for s, _ in spans],
        residue_spans=spans,
        positions=frame.positions,
        velocities=velocities,
        masses=masses,
        bonds=bonds,
        ff_types=ff_types,
        charges=charges,
        box_lengths=frame.box_lengths,
        force_field=force_field,
    )


