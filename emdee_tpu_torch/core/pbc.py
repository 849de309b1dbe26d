"""Periodic-boundary helpers for a cubic box (counterpart of
emdee_tpu/core/pbc.py).  `torch.round` rounds half to even, like
`jnp.round`, so the minimum image matches the reference bit for bit."""

from __future__ import annotations

import torch


def minimum_image(scaled: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement for box-scaled coordinates: s − round(s)."""
    return scaled - torch.round(scaled)


def wrap_scaled(scaled: torch.Tensor) -> torch.Tensor:
    """Wrap box-scaled coordinates into [0, 1)."""
    return scaled - torch.floor(scaled)


def wrap(positions: torch.Tensor, box) -> torch.Tensor:
    """Wrap absolute positions into [0, L)."""
    return box * wrap_scaled(positions / box)
