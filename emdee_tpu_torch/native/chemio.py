"""ctypes bindings for the native chem-I/O parser (chemio.cpp; counterpart
of emdee_tpu/native/chemio.py).

Plays the role Chemfiles (C++) plays in the reference (modelling.jl:8,236):
fast parsing of PDB/XYZ into flat arrays.  Returns None / available()==False
when the native library can't be built, in which case the pure-Python parsers
in emdee_tpu_torch.io take over.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    from emdee_tpu_torch.native.build import library_path

    path = library_path()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.emdee_read_xyz.restype = ctypes.c_void_p
        lib.emdee_read_xyz.argtypes = [ctypes.c_char_p]
        lib.emdee_read_pdb.restype = ctypes.c_void_p
        lib.emdee_read_pdb.argtypes = [ctypes.c_char_p]
        lib.emdee_frame_natoms.restype = ctypes.c_long
        lib.emdee_frame_natoms.argtypes = [ctypes.c_void_p]
        lib.emdee_frame_nbonds.restype = ctypes.c_long
        lib.emdee_frame_nbonds.argtypes = [ctypes.c_void_p]
        lib.emdee_frame_positions.restype = ctypes.POINTER(ctypes.c_double)
        lib.emdee_frame_positions.argtypes = [ctypes.c_void_p]
        lib.emdee_frame_velocities.restype = ctypes.POINTER(ctypes.c_double)
        lib.emdee_frame_velocities.argtypes = [ctypes.c_void_p]
        lib.emdee_frame_has_velocities.restype = ctypes.c_int
        lib.emdee_frame_has_velocities.argtypes = [ctypes.c_void_p]
        lib.emdee_frame_bonds.restype = ctypes.POINTER(ctypes.c_long)
        lib.emdee_frame_bonds.argtypes = [ctypes.c_void_p]
        lib.emdee_frame_resids.restype = ctypes.POINTER(ctypes.c_long)
        lib.emdee_frame_resids.argtypes = [ctypes.c_void_p]
        lib.emdee_frame_flags.restype = ctypes.POINTER(ctypes.c_ubyte)
        lib.emdee_frame_flags.argtypes = [ctypes.c_void_p]
        lib.emdee_frame_cell.restype = ctypes.POINTER(ctypes.c_double)
        lib.emdee_frame_cell.argtypes = [ctypes.c_void_p]
        lib.emdee_frame_has_cell.restype = ctypes.c_int
        lib.emdee_frame_has_cell.argtypes = [ctypes.c_void_p]
        lib.emdee_frame_strings.restype = ctypes.c_char_p
        lib.emdee_frame_strings.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.emdee_frame_free.restype = None
        lib.emdee_frame_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _strings(lib, handle, which: int, n: int) -> List[str]:
    raw = lib.emdee_frame_strings(handle, which)
    if raw is None:
        return [""] * n
    parts = raw.decode("utf-8", "replace").split("\x1f")
    if len(parts) < n:
        parts += [""] * (n - len(parts))
    return parts[:n]


def read_xyz(path: str) -> Tuple[List[str], np.ndarray, Optional[np.ndarray], str]:
    """Returns (names, positions, velocities_or_None, comment)."""
    lib = _load()
    handle = lib.emdee_read_xyz(path.encode())
    if not handle:
        raise IOError(f"native XYZ parse failed: {path}")
    try:
        n = lib.emdee_frame_natoms(handle)
        pos = np.ctypeslib.as_array(lib.emdee_frame_positions(handle), shape=(n, 3)).copy()
        vel = None
        if lib.emdee_frame_has_velocities(handle):
            vel = np.ctypeslib.as_array(
                lib.emdee_frame_velocities(handle), shape=(n, 3)
            ).copy()
        names = _strings(lib, handle, 0, n)
        comment = _strings(lib, handle, 4, 1)[0]
        return names, pos, vel, comment
    finally:
        lib.emdee_frame_free(handle)


def read_pdb(path: str):
    from emdee_tpu_torch.io.pdb import PDBFrame

    lib = _load()
    handle = lib.emdee_read_pdb(path.encode())
    if not handle:
        return None
    try:
        n = lib.emdee_frame_natoms(handle)
        nb = lib.emdee_frame_nbonds(handle)
        pos = np.ctypeslib.as_array(lib.emdee_frame_positions(handle), shape=(n, 3)).copy()
        bonds_arr = (
            np.ctypeslib.as_array(lib.emdee_frame_bonds(handle), shape=(nb, 2)).copy()
            if nb
            else np.zeros((0, 2), np.int64)
        )
        resids = np.ctypeslib.as_array(lib.emdee_frame_resids(handle), shape=(n,)).copy()
        flags = np.ctypeslib.as_array(lib.emdee_frame_flags(handle), shape=(n,)).copy()
        has_cell = lib.emdee_frame_has_cell(handle)
        cell = (
            np.ctypeslib.as_array(lib.emdee_frame_cell(handle), shape=(6,)).copy()
            if has_cell
            else None
        )
        return PDBFrame(
            names=_strings(lib, handle, 0, n),
            resnames=_strings(lib, handle, 1, n),
            resids=resids,
            chainids=_strings(lib, handle, 2, n),
            is_hetatm=flags.astype(bool),
            elements=_strings(lib, handle, 3, n),
            positions=pos,
            box_lengths=cell[:3] if cell is not None else None,
            box_angles=cell[3:] if cell is not None else None,
            bonds=[(int(i), int(j)) for i, j in bonds_arr],
        )
    finally:
        lib.emdee_frame_free(handle)
