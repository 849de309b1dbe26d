"""Colored-graph canonicalization and molecular-graph utilities
(counterpart of emdee_tpu/modelling/graphs.py; numpy only).

The reference FFIs into the nauty C library for canonical labeling of
vertex-colored residue graphs (`ccall(:densenauty)`,
molecular_graphs.jl:63-82); residue-template matching then compares canonical
adjacency matrices (modelling.jl:306-328).  This module provides:

- `canonical_form(adjacency, colors, atol=0.1)` — a McKay-style canonical
  labeling (equitable refinement + individualization backtracking) with the
  same contract as the reference: colors are binned with `atol`
  (molecular_graphs.jl:66-69), the canonical order respects color classes
  (smaller color first), and two graphs are colored-isomorphic iff their
  canonical adjacency matrices are equal.
  The C++ implementation (native/canon.cpp) is used when available; the
  pure-Python implementation here is the behavioral spec and fallback —
  residue graphs are ≤ ~40 vertices, where either is instant.
- exclusion generation: 1-2/1-3 excluded pairs and 1-4 scaled pairs from the
  bond graph (the reference parses lj14scale/coulomb14scale,
  modelling.jl:198-200, but never derives the pair lists — this supplies
  the missing piece feeding the nonbonded kernel's exclusion corrections).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def color_classes(colors: Sequence[float], atol: float = 0.1) -> np.ndarray:
    """Bin scalar colors into integer classes: sort, then split where adjacent
    values differ by more than atol (the molecular_graphs.jl:66-69 scheme).
    Returns (n,) int class ids ordered by ascending color."""
    colors = np.asarray(colors, np.float64)
    order = np.argsort(colors, kind="stable")
    classes = np.empty(len(colors), np.int64)
    cls = 0
    for k, idx in enumerate(order):
        if k > 0 and abs(colors[idx] - colors[order[k - 1]]) > atol:
            cls += 1
        classes[idx] = cls
    return classes


def _refine(adj_sets: List[set], partition: List[List[int]]) -> List[List[int]]:
    """Equitable refinement (1-dim Weisfeiler-Leman with ordered cells).

    Cells split by neighbor counts against every cell until stable; split
    pieces stay in place ordered by ascending count — deterministic, so
    isomorphic graphs refine identically.
    """
    partition = [list(cell) for cell in partition]
    changed = True
    while changed:
        changed = False
        for splitter in list(partition):
            spl = set(splitter)
            new_partition: List[List[int]] = []
            for cell in partition:
                if len(cell) == 1:
                    new_partition.append(cell)
                    continue
                counts = {}
                for v in cell:
                    counts.setdefault(len(adj_sets[v] & spl), []).append(v)
                if len(counts) == 1:
                    new_partition.append(cell)
                else:
                    changed = True
                    for key in sorted(counts):
                        new_partition.append(counts[key])
            partition = new_partition
            if changed:
                break
    return partition


def _adjacency_key(adj: np.ndarray, order: List[int]) -> bytes:
    return np.ascontiguousarray(adj[np.ix_(order, order)]).tobytes()


def canonical_form(
    adjacency: np.ndarray, colors: Sequence[float], atol: float = 0.1
) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical labeling of a vertex-colored graph.

    Returns (order, canonical_adjacency): `order[i]` is the original vertex
    at canonical position i, and canonical_adjacency =
    adjacency[order][:, order].  Two graphs with the same color multiset are
    colored-isomorphic iff their canonical adjacencies are equal.
    """
    adjacency = np.asarray(adjacency, bool)
    n = adjacency.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros((0, 0), bool)
    classes = color_classes(colors, atol)

    native = _native_canonical_form(adjacency, classes)
    if native is not None:
        return native

    adj_sets = [set(np.nonzero(adjacency[v])[0].tolist()) for v in range(n)]
    initial = [
        sorted(np.nonzero(classes == cls)[0].tolist())
        for cls in range(int(classes.max()) + 1)
    ]

    best: dict = {"key": None, "order": None}

    def search(partition: List[List[int]]) -> None:
        partition = _refine(adj_sets, partition)
        target = next((c for c in partition if len(c) > 1), None)
        if target is None:
            order = [cell[0] for cell in partition]
            key = _adjacency_key(adjacency, order)
            if best["key"] is None or key < best["key"]:
                best["key"] = key
                best["order"] = order
            return
        idx = partition.index(target)
        for v in target:
            branched = (
                partition[:idx]
                + [[v], [u for u in target if u != v]]
                + partition[idx + 1 :]
            )
            search(branched)

    search(initial)
    order = np.asarray(best["order"], np.int64)
    return order, adjacency[np.ix_(order, order)]


def _native_canonical_form(adjacency: np.ndarray, classes: np.ndarray):
    try:
        from emdee_tpu_torch.native import canon

        if canon.available():
            return canon.canonical_form(adjacency, classes)
    except Exception:
        pass
    return None


# ---------------------------------------------------------------------------
# Bond-graph exclusions
# ---------------------------------------------------------------------------


def bonded_paths(
    num_atoms: int, bonds: Sequence[Tuple[int, int]]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Classify pairs by shortest bond-path length 1, 2, 3.

    Returns (pairs12, pairs13, pairs14) as (P, 2) int arrays with i < j.
    A pair appears only in its *shortest* class (standard MD convention: a
    1-4 pair that is also 1-3 through a ring is treated as 1-3).
    """
    neighbors: List[set] = [set() for _ in range(num_atoms)]
    for a, b in bonds:
        neighbors[a].add(b)
        neighbors[b].add(a)

    p12, p13, p14 = set(), set(), set()
    for i in range(num_atoms):
        for j in neighbors[i]:
            if i < j:
                p12.add((i, j))
    for j in range(num_atoms):
        for i in neighbors[j]:
            for k in neighbors[j]:
                if i < k:
                    p13.add((i, k))
    for a, b in bonds:
        for i in neighbors[a]:
            if i == b:
                continue
            for l in neighbors[b]:
                if l == a or l == i:
                    continue
                p14.add((min(i, l), max(i, l)))
    p13 -= p12
    p14 -= p12 | p13

    def arr(s):
        return (
            np.asarray(sorted(s), np.int32) if s else np.zeros((0, 2), np.int32)
        )

    return arr(p12), arr(p13), arr(p14)


def exclusion_table(
    num_atoms: int,
    bonds: Sequence[Tuple[int, int]],
    lj14_scale: float = 1.0,
    pad_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exclusion pair list + per-pair LJ scale factors for the nonbonded
    kernel: 1-2 and 1-3 pairs fully excluded (scale 0), 1-4 pairs scaled by
    `lj14_scale` (modelling.jl:198-200's lj14scale).  Optionally padded with
    (num_atoms, num_atoms) sentinel rows to a static size."""
    p12, p13, p14 = bonded_paths(num_atoms, bonds)
    pairs = np.concatenate([p12, p13, p14], axis=0)
    scales = np.concatenate(
        [
            np.zeros(len(p12), np.float32),
            np.zeros(len(p13), np.float32),
            np.full(len(p14), lj14_scale, np.float32),
        ]
    )
    if pad_to is not None:
        if pad_to < len(pairs):
            raise ValueError(f"pad_to={pad_to} < {len(pairs)} exclusion pairs")
        pad = pad_to - len(pairs)
        pairs = np.concatenate(
            [pairs, np.full((pad, 2), num_atoms, np.int32)], axis=0
        )
        scales = np.concatenate([scales, np.ones(pad, np.float32)])
    return pairs, scales
