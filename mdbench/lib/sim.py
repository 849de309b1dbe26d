"""What a system adapter hands the harness: the program's state and closures
after set-up, and the same inputs, untouched by the program, for the
reference."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from mdbench.reference.forces import ForceField


@dataclass
class Sim:
    state: object  # the program's state after equilibration and warm-up
    rollout: Callable
    energy: Callable
    rng: Optional[torch.Generator]  # the thermostat's generator, None in NVE
    num_atoms: int
    rebin_every: int
    dt: float
    geometry: dict  # the program's cell grid: cells_per_dim, capacity, box, skin
    forcefield: ForceField  # the reference's inputs
    csvr: Optional[dict]  # {"temperature", "tau", "kB"} or None
    work: dict  # what the work counts need: "force" ("lj" | "molecular"), "e_tags", "e_bonds", "rebin_fields"


def seeded(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one use of the run's seed: streams of one
    seed never share draws, and any seed below 2^63 / 8 is taken whole."""
    return torch.Generator(device=device).manual_seed((int(seed) * 8 + stream) % (1 << 63))


class Clock:
    """Seconds of set-up by part, each part closed by a device sync."""

    def __init__(self, device):
        self.device = device
        self.parts = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - self._t
        self._t = now
