"""Fixed-shape bin-and-sort cell lists (counterpart of
emdee_tpu/neighbors/cell_list.py).

Cell ids from wrapped scaled coordinates (the cells.jl:80-85 binning), one
stable sort by cell id in place of linked lists, and a dense (M³, C) atom
table with an overflow flag; the stencil offsets are host numpy, copied
from the reference.  Geometry: M = ⌊ndiv·L/cutoff⌋ cells a side.

Every step is a torch op on the positions' device that waits for nothing:
the counts and each cell's first sorted row come from a binary search of
the sorted ids (`torch.bincount` on CUDA reads its maximum on the host),
and the table is written through a dump column that is cut off, the
pattern of core/scatter.py, where the reference drops out-of-range writes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from emdee_tpu_torch.core.pbc import wrap_scaled
from emdee_tpu_torch.core.types import resolve_device
from emdee_tpu_torch.neighbors.cell_dense import _box


class CellList(NamedTuple):
    """Dense cell decomposition of an atom set."""

    cell_ids: torch.Tensor  # (N,) int32 — cell id per atom
    sorted_atoms: torch.Tensor  # (N,) int32 — atom indices stably sorted by cell id
    cell_table: torch.Tensor  # (num_cells, capacity) int32 — atom ids, pad = N
    cell_counts: torch.Tensor  # (num_cells,) int32
    overflow: torch.Tensor  # () bool — some cell exceeded capacity

    @property
    def num_cells(self) -> int:
        return self.cell_table.shape[0]

    @property
    def capacity(self) -> int:
        return self.cell_table.shape[1]


def cells_per_dimension(box: float, cutoff: float, ndiv: int = 2) -> int:
    """M = ⌊ndiv·L/cutoff⌋ (cells.jl:36)."""
    return int(np.floor(ndiv * box / cutoff))


def suggest_capacity(num_atoms: int, num_cells: int, multiplier: float = 1.6, minimum: int = 4) -> int:
    """Static per-cell capacity: the mean occupancy times `multiplier` plus
    three of its Poisson standard deviations and 2, so that overflow is a
    rare event handled by doubling."""
    mean = num_atoms / max(num_cells, 1)
    return max(minimum, int(np.ceil(mean * multiplier + 3.0 * np.sqrt(mean) + 2.0)))


def stencil_offsets(cells_per_dim: int, ndiv: int = 2, half: bool = False) -> np.ndarray:
    """Integer cell offsets whose cells can hold atoms within the cutoff:
    |v| ≤ ndiv per axis with the nearest-corner distance Σ max(|v|−1, 0)²
    below ndiv² (the corrected form of cells.jl:28-34), the origin left
    out; with `half`, one of each ±v pair (lexicographic z, y, x)."""
    n = ndiv
    rng = np.arange(-n, n + 1)
    vx, vy, vz = np.meshgrid(rng, rng, rng, indexing="ij")
    offsets = np.stack([vx.ravel(), vy.ravel(), vz.ravel()], axis=1)
    corner = np.maximum(np.abs(offsets) - 1, 0)
    offsets = offsets[(corner**2).sum(axis=1) < float(n) ** 2]
    offsets = offsets[~np.all(offsets == 0, axis=1)]
    if half:
        key = offsets[:, 2] * (2 * n + 1) ** 2 + offsets[:, 1] * (2 * n + 1) + offsets[:, 0]
        offsets = offsets[key > 0]
    return offsets.astype(np.int32)


def compute_cell_ids(positions: torch.Tensor, box, cells_per_dim: int) -> torch.Tensor:
    """Cell id per atom, x fastest: id = vx + M·(vy + M·vz) with
    v = ⌊M·wrap(x/L)⌋ (cells.jl:80-85), clipped to M − 1 at the s → 1 edge.
    The box divides as a 0-d tensor on the positions' device, so the bin
    edges are the reference's bit for bit."""
    m = cells_per_dim
    s = wrap_scaled(positions / _box(box, positions))
    v = torch.clamp(torch.floor(m * s).to(torch.int32), 0, m - 1)
    return v[:, 0] + m * (v[:, 1] + m * v[:, 2])


def build_cell_list(positions: torch.Tensor, box, *, cells_per_dim: int, capacity: int) -> CellList:
    """Bin and sort: one stable sort replaces distribute!/renew_cells!."""
    n = positions.shape[0]
    dev = positions.device
    num_cells = cells_per_dim**3
    cell_ids = compute_cell_ids(positions, box, cells_per_dim)
    sorted_atoms = torch.argsort(cell_ids, stable=True)
    sorted_ids = cell_ids[sorted_atoms]
    cells = torch.arange(num_cells, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(sorted_ids, cells)
    counts = torch.searchsorted(sorted_ids, cells, right=True) - starts
    # Rank of each sorted atom within its cell; ranks past the capacity go
    # to the dump column C, which is cut off (the flag reports them).
    ranks = torch.arange(n, device=dev) - starts[sorted_ids.long()]
    col = torch.clamp(ranks, max=capacity)
    table = torch.full((num_cells, capacity + 1), n, dtype=torch.int32, device=dev)
    table = table.index_put((sorted_ids.long(), col), sorted_atoms.to(torch.int32))[:, :capacity]
    return CellList(
        cell_ids=cell_ids,
        sorted_atoms=sorted_atoms.to(torch.int32),
        cell_table=table.contiguous(),
        cell_counts=counts.to(torch.int32),
        overflow=torch.max(counts) > capacity,
    )


@functools.lru_cache(maxsize=None)
def _stencil_table(cells_per_dim: int, offsets: bytes, device: torch.device) -> torch.Tensor:
    # Copied to the device once per geometry: a host-to-device copy from
    # pageable memory waits for the stream, and the neighbor list rebuilds
    # inside rollouts.
    m = cells_per_dim
    off = np.frombuffer(offsets, dtype=np.int32).reshape(-1, 3)
    ids = np.arange(m**3)
    coords = np.stack([ids % m, (ids // m) % m, ids // (m * m)], axis=1)
    nbr = (coords[:, None, :] + off[None, :, :]) % m
    return torch.from_numpy((nbr[..., 0] + m * (nbr[..., 1] + m * nbr[..., 2])).astype(np.int32)).to(device)


def stencil_cell_ids(cells_per_dim: int, offsets: np.ndarray, device=None) -> torch.Tensor:
    """(num_cells, S) int32 table of the wrapped neighbor-cell ids of each
    cell at the given offsets (the dense `surrounding_cells`,
    cells.jl:38-44), on `device` (by default the CUDA card).  Cached per
    geometry and device: do not write into it."""
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    return _stencil_table(cells_per_dim, offsets.tobytes(), resolve_device(device))
