"""Initial-configuration generators (simple-cubic / FCC lattices, Maxwell-
Boltzmann velocities) — counterpart of emdee_tpu/utils/lattice.py.  Pure
numpy with a seed, so both packages start from byte-identical arrays."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def cubic_lattice(num_atoms: int, density: float, jitter: float = 0.0, seed: int = 0):
    """Simple-cubic lattice holding ≥ num_atoms at the given number density.

    Returns (positions (N,3) float64, box_edge L).
    """
    side = int(np.ceil(num_atoms ** (1.0 / 3.0)))
    L = (num_atoms / density) ** (1.0 / 3.0)
    a = L / side
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = (grid[:num_atoms] + 0.5) * a
    if jitter > 0:
        rng = np.random.default_rng(seed)
        pos = pos + rng.uniform(-jitter * a, jitter * a, pos.shape)
    return pos, float(L)


def fcc_lattice(num_cells: int, density: float):
    """FCC lattice of 4·num_cells³ atoms — the standard LJ solid start.

    Returns (positions (N,3) float64, box_edge L)."""
    n = 4 * num_cells**3
    L = (n / density) ** (1.0 / 3.0)
    a = L / num_cells
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    grid = np.stack(
        np.meshgrid(*[np.arange(num_cells)] * 3, indexing="ij"), -1
    ).reshape(-1, 1, 3)
    pos = ((grid + base[None]) * a).reshape(-1, 3) + 0.25 * a
    return pos, float(L)


def maxwell_boltzmann(num_atoms: int, temperature: float, masses=1.0, seed: int = 0,
                      zero_momentum: bool = True):
    """Velocities from the MB distribution at kB·T=temperature (LJ units)."""
    rng = np.random.default_rng(seed)
    m = np.broadcast_to(np.asarray(masses, np.float64), (num_atoms,))
    v = rng.normal(0.0, 1.0, (num_atoms, 3)) * np.sqrt(temperature / m)[:, None]
    if zero_momentum:
        p = (m[:, None] * v).sum(axis=0) / m.sum()
        v = v - p[None, :]
    return v
