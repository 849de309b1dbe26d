"""Cell lists for the plain reference: every pair of atoms closer than the
cutoff, found from the positions alone and handed out in blocks of cells so
that a million-atom box fits beside nothing else on the card.

The box is cut into M = floor(L / rc) cells a side (M >= 3, so the 27
neighbour cells of a cell are distinct); a cell's atoms sit in one padded
row of a (M^3, Cmax) table.  `blocks` yields, for a range of centre cells,
the centre atoms (B, Cmax) and the atoms of their 27 neighbour cells
(B, 27 * Cmax), -1 where a row is padding: each pair appears twice, once
from each side.
"""

from __future__ import annotations

import torch

# Entries (centre slot x neighbour slot) a block may hold: about 2^25 keeps
# the float64 temporaries of a block under a few GB.
BLOCK_ENTRIES = 1 << 25


class CellTable:
    """Atoms binned into cubic cells of side >= `cutoff` in a periodic cube."""

    def __init__(self, positions: torch.Tensor, box: float, cutoff: float):
        m = int(box // cutoff)
        if m < 3:
            raise ValueError(f"box {box} holds {m} cells of side >= {cutoff}; the reference needs 3")
        self.m, self.box, self.cutoff = m, float(box), float(cutoff)
        dev = positions.device
        wrapped = torch.remainder(positions.double(), box)
        v = torch.clamp(torch.floor(wrapped * (m / box)).long(), 0, m - 1)
        cell = v[:, 0] + m * (v[:, 1] + m * v[:, 2])
        nc = m**3
        counts = torch.bincount(cell, minlength=nc)
        self.cmax = int(counts.max())
        order = torch.argsort(cell, stable=True)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(len(cell), device=dev) - starts[cell[order]]
        table = torch.full((nc, self.cmax), -1, dtype=torch.long, device=dev)
        table[cell[order], rank] = order
        self.table = table
        g = torch.arange(m, device=dev)
        offs = torch.tensor([(x, y, z) for z in (-1, 0, 1) for y in (-1, 0, 1) for x in (-1, 0, 1)], device=dev)
        cx, cy, cz = g.repeat(m * m), g.repeat_interleave(m).repeat(m), g.repeat_interleave(m * m)
        nb = lambda c, o: torch.remainder(c[:, None] + o[None, :], m)  # noqa: E731
        self.neighbours = nb(cx, offs[:, 0]) + m * (nb(cy, offs[:, 1]) + m * nb(cz, offs[:, 2]))  # (nc, 27)

    def blocks(self, entries: int = BLOCK_ENTRIES):
        """Yield (centre atoms (B, Cmax), neighbour atoms (B, 27 Cmax))."""
        nc = self.m**3
        per_cell = self.cmax * 27 * self.cmax
        step = max(1, entries // max(per_cell, 1))
        for c0 in range(0, nc, step):
            c1 = min(nc, c0 + step)
            yield self.table[c0:c1], self.table[self.neighbours[c0:c1]].reshape(c1 - c0, -1)


def min_image(d: torch.Tensor, box: float) -> torch.Tensor:
    return d - box * torch.round(d / box)


def count_pairs(positions: torch.Tensor, box: float, cutoff: float) -> int:
    """Unique pairs of atoms closer than `cutoff` (minimum image)."""
    cells = CellTable(positions, box, cutoff)
    pos = positions.double()
    total = 0
    for cen, nbr in cells.blocks():
        d = min_image(pos[cen.clamp(min=0)][:, :, None, :] - pos[nbr.clamp(min=0)][:, None, :, :], box)
        ok = (cen[:, :, None] >= 0) & (nbr[:, None, :] >= 0) & (cen[:, :, None] != nbr[:, None, :])
        total += int((ok & ((d * d).sum(-1) < cutoff * cutoff)).sum())
    return total // 2
