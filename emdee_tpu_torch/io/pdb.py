"""PDB file reading/writing (the Chemfiles-subset the reference exercises;
counterpart of emdee_tpu/io/pdb.py, numpy only, no torch).

The reference's `System` builder pulls from Chemfiles (modelling.jl:235-295):
atom names/types, residue grouping, chain ids, the `is_standard_pdb` flag
(ATOM vs HETATM record), explicit CONECT bonds, positions, and the CRYST1
cell.  This module parses exactly that, into NumPy arrays.

A C++ fast path (emdee_tpu_torch.native.chemio) accelerates large files; this
pure-Python implementation is the always-available fallback and spec.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple

import numpy as np


@dataclass
class PDBFrame:
    names: List[str]
    resnames: List[str]
    resids: np.ndarray  # (N,) int — resSeq per atom
    chainids: List[str]
    is_hetatm: np.ndarray  # (N,) bool — False for ATOM records ("standard PDB")
    elements: List[str]  # element column (may be "")
    positions: np.ndarray  # (N, 3) float64, Å
    box_lengths: Optional[np.ndarray] = None  # (3,) float64 or None
    box_angles: Optional[np.ndarray] = None  # (3,) float64 or None
    bonds: List[Tuple[int, int]] = field(default_factory=list)  # 0-based, i<j

    @property
    def num_atoms(self) -> int:
        return len(self.names)

    def residue_spans(self) -> List[Tuple[int, int]]:
        """Group atoms into residues by consecutive (chainid, resid, resname)
        change — the grouping Chemfiles produces for well-formed PDBs."""
        spans = []
        start = 0
        for i in range(1, self.num_atoms + 1):
            if i == self.num_atoms or (
                self.resids[i] != self.resids[start]
                or self.chainids[i] != self.chainids[start]
                or self.resnames[i] != self.resnames[start]
            ):
                spans.append((start, i))
                start = i
        return spans


def _parse_float(s: str) -> float:
    s = s.strip()
    return float(s) if s else 0.0


def read_pdb(path: str) -> PDBFrame:
    from emdee_tpu_torch.native import chemio

    if chemio.available():
        parsed = chemio.read_pdb(str(path))
        if parsed is not None:
            return parsed
    with open(path, "r") as fh:
        return _read_pdb_stream(fh)


def _read_pdb_stream(fh) -> PDBFrame:
    names: List[str] = []
    resnames: List[str] = []
    resids: List[int] = []
    chainids: List[str] = []
    is_het: List[bool] = []
    elements: List[str] = []
    xyz: List[Tuple[float, float, float]] = []
    serial_to_index = {}
    box_lengths = box_angles = None
    bond_set: Set[Tuple[int, int]] = set()

    for line in fh:
        rec = line[:6]
        if rec in ("ATOM  ", "HETATM"):
            serial_str = line[6:11].strip()
            index = len(names)
            if serial_str:
                try:
                    serial_to_index[int(serial_str)] = index
                except ValueError:
                    pass
            names.append(line[12:16].strip())
            resnames.append(line[17:21].strip())
            chainids.append(line[21:22])
            try:
                resids.append(int(line[22:26]))
            except ValueError:
                resids.append(0)
            xyz.append(
                (_parse_float(line[30:38]), _parse_float(line[38:46]), _parse_float(line[46:54]))
            )
            elements.append(line[76:78].strip() if len(line) >= 77 else "")
            is_het.append(rec == "HETATM")
        elif rec == "CRYST1":
            box_lengths = np.array(
                [_parse_float(line[6:15]), _parse_float(line[15:24]), _parse_float(line[24:33])]
            )
            box_angles = np.array(
                [_parse_float(line[33:40]), _parse_float(line[40:47]), _parse_float(line[47:54])]
            )
        elif rec == "CONECT":
            fields = [line[6 + 5 * k : 11 + 5 * k].strip() for k in range(5)]
            fields = [f for f in fields if f]
            if len(fields) >= 2:
                a = int(fields[0])
                for b_str in fields[1:]:
                    b = int(b_str)
                    if a in serial_to_index and b in serial_to_index:
                        i, j = serial_to_index[a], serial_to_index[b]
                        if i != j:
                            bond_set.add((min(i, j), max(i, j)))
        elif rec in ("END   ", "ENDMDL") or line.startswith("END"):
            break

    return PDBFrame(
        names=names,
        resnames=resnames,
        resids=np.array(resids, np.int64),
        chainids=chainids,
        is_hetatm=np.array(is_het, bool),
        elements=elements,
        positions=np.array(xyz, np.float64).reshape(-1, 3),
        box_lengths=box_lengths,
        box_angles=box_angles,
        bonds=sorted(bond_set),
    )


def write_pdb(path: str, frame: PDBFrame) -> None:
    with open(path, "w") as fh:
        if frame.box_lengths is not None:
            a, b, c = frame.box_lengths
            al, be, ga = (
                frame.box_angles if frame.box_angles is not None else (90.0, 90.0, 90.0)
            )
            fh.write(
                f"CRYST1{a:9.3f}{b:9.3f}{c:9.3f}{al:7.2f}{be:7.2f}{ga:7.2f} P 1           1\n"
            )
        for i in range(frame.num_atoms):
            rec = "HETATM" if frame.is_hetatm[i] else "ATOM  "
            name = frame.names[i]
            # PDB convention: names of <4 chars start at column 14.
            name_field = name if len(name) >= 4 else f" {name:<3s}"
            x, y, z = frame.positions[i]
            elem = frame.elements[i] if i < len(frame.elements) else ""
            fh.write(
                f"{rec}{(i % 99999) + 1:5d} {name_field}{'':1s}{frame.resnames[i]:<4s}"
                f"{frame.chainids[i]:1s}{int(frame.resids[i]) % 10000:4d}    "
                f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}          {elem:>2s}\n"
            )
        for i, j in frame.bonds:
            fh.write(f"CONECT{i + 1:5d}{j + 1:5d}\n")
        fh.write("END\n")
