"""Per-atom padded (Verlet) neighbor lists built from the cell list
(counterpart of emdee_tpu/neighbors/neighbor_list.py).

Each atom's candidates are the atoms of its own cell and of its full-shell
stencil cells, read out of the dense cell table; a distance filter at
r < cutoff + skin keeps the neighbors, and an exclusive scan places them in
an (N, K) table padded with N, with an overflow flag.  The full shell lists
every pair twice, so the force pass is a per-atom gather and sum.  The skin
lets the list stand until some atom has moved more than skin/2
(`needs_rebuild`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from emdee_tpu_torch.core.pbc import displacement
from emdee_tpu_torch.neighbors.cell_dense import _box
from emdee_tpu_torch.neighbors.cell_list import build_cell_list, stencil_cell_ids, stencil_offsets


class NeighborList(NamedTuple):
    idx: torch.Tensor  # (N, K) int32 — neighbor atom ids, pad = N
    ref_positions: torch.Tensor  # (N, 3) — positions at build time
    overflow: torch.Tensor  # () bool — a capacity was exceeded somewhere
    cell_capacity: int  # the cell-table capacity the list was built with

    @property
    def max_neighbors(self) -> int:
        return self.idx.shape[1]


def estimate_max_neighbors(
    num_atoms: int, box: float, list_cutoff: float, multiplier: float = 1.4, minimum: int = 8
) -> int:
    """Neighbor capacity from the mean density: ρ·(4/3)π·rc_list³·multiplier,
    rounded up to a multiple of 8."""
    density = num_atoms / float(box) ** 3
    mean = density * (4.0 / 3.0) * np.pi * list_cutoff**3
    k = max(minimum, int(np.ceil(mean * multiplier)))
    return -(-k // 8) * 8


@functools.lru_cache(maxsize=None)
def _candidate_cells(cells_per_dim: int, ndiv: int, device: torch.device) -> torch.Tensor:
    """(num_cells, S + 1) int64: each cell, then its full-shell stencil."""
    stencil = stencil_cell_ids(cells_per_dim, stencil_offsets(cells_per_dim, ndiv=ndiv), device)
    own = torch.arange(cells_per_dim**3, dtype=torch.int32, device=device)[:, None]
    return torch.cat([own, stencil], dim=1).long()


def build_neighbor_list(
    positions: torch.Tensor,
    box,
    list_cutoff: float,
    *,
    cells_per_dim: int,
    cell_capacity: int,
    max_neighbors: int,
    ndiv: int = 2,
    atom_chunk: int = 4096,
) -> NeighborList:
    """Build the (N, K) neighbor table through the cell list, in atom
    blocks of `atom_chunk`.  Nothing waits for the device."""
    n = positions.shape[0]
    dev = positions.device
    box = _box(box, positions)
    cl = build_cell_list(positions, box, cells_per_dim=cells_per_dim, capacity=cell_capacity)
    cand_cells = _candidate_cells(cells_per_dim, ndiv, dev)
    pos_ext = torch.cat([positions, positions.new_zeros((1, 3))])
    cutoff2 = float(np.float32(list_cutoff) ** 2)
    k = max_neighbors
    idx_blocks, count_blocks = [], []
    for start in range(0, n, atom_chunk):
        rows = torch.arange(start, min(start + atom_chunk, n), device=dev)
        cand = cl.cell_table[cand_cells[cl.cell_ids[rows].long()]].reshape(rows.shape[0], -1).long()  # (B, C)
        dv = displacement(positions[rows, None, :], pos_ext[cand], box)
        r2 = torch.sum(dv * dv, dim=-1)
        valid = (cand != rows[:, None]) & (cand < n) & (r2 < cutoff2)
        # Exclusive scan → columns; invalid candidates and those past K go
        # to the dump column K, which is cut off.
        col = torch.cumsum(valid, dim=1) - 1
        col = torch.where(valid & (col < k), col, k)
        out = torch.full((rows.shape[0], k + 1), n, dtype=torch.int32, device=dev)
        idx_blocks.append(out.scatter(1, col, cand.to(torch.int32))[:, :k])
        count_blocks.append(torch.sum(valid, dim=1))
    counts = torch.cat(count_blocks)
    return NeighborList(
        idx=torch.cat(idx_blocks),
        ref_positions=positions,
        overflow=(torch.max(counts) > k) | cl.overflow,
        cell_capacity=cell_capacity,
    )


def needs_rebuild(nbrs: NeighborList, positions: torch.Tensor, box, skin: float) -> torch.Tensor:
    """() bool tensor: some atom moved more than skin/2 since the build."""
    dv = displacement(positions, nbrs.ref_positions, _box(box, positions))
    max_d2 = torch.max(torch.sum(dv * dv, dim=-1))
    return max_d2 > float((np.float32(0.5) * np.float32(skin)) ** 2)
