"""ctypes bindings for the native colored-graph canonicalization (canon.cpp;
counterpart of emdee_tpu/native/canon.py).

The reference calls the nauty C library (`ccall(:densenauty)`,
molecular_graphs.jl:75-80) to canonically label vertex-colored residue graphs.
canon.cpp implements a McKay-style refinement + backtracking canonical-form
search in C++; `emdee_tpu_torch.modelling.graphs` holds the pure-Python reference
implementation used as fallback and for differential testing.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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
        lib.emdee_canonical_form.restype = ctypes.c_int
        lib.emdee_canonical_form.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte),  # adjacency n*n row-major 0/1
            ctypes.POINTER(ctypes.c_int),  # color class per vertex
            ctypes.c_int,  # n
            ctypes.POINTER(ctypes.c_int),  # out: canonical order (n)
            ctypes.POINTER(ctypes.c_ubyte),  # out: canonical adjacency n*n
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def canonical_form(
    adjacency: np.ndarray, color_classes: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native canonical form; returns (order, canonical_adjacency) or None.

    `order` lists original vertex indices in canonical position order, i.e.
    canonical_adjacency = adjacency[order][:, order].
    """
    lib = _load()
    if lib is None:
        return None
    n = adjacency.shape[0]
    adj = np.ascontiguousarray(adjacency, np.uint8)
    colors = np.ascontiguousarray(color_classes, np.int32)
    order = np.empty(n, np.int32)
    canon_adj = np.empty((n, n), np.uint8)
    rc = lib.emdee_canonical_form(
        adj.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        colors.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n,
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        canon_adj.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if rc != 0:
        return None
    return order.astype(np.int64), canon_adj.astype(bool)
