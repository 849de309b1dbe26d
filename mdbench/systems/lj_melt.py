"""The Lennard-Jones melt: an FCC lattice at reduced density rho*, velocities
drawn at T* from the seed, on the program's dense-cell engine with the
component carry (uniform parameters and mass), as a frozen, vectorised copy
of `emdee_tpu_torch/tools/melt.py`'s generator.

Configuration keys: fcc_cells, density, cutoff, switch, skin, dt,
temperature, mass, sigma, epsilon.  Traffic keys: ensemble ("nve"), backend,
rebin ("shift" or "sort"), equil_steps, equil_rebin_every, rebin_every.
"""

from __future__ import annotations

import numpy as np
import torch

from mdbench.lib.sim import Clock, Sim, seeded
from mdbench.reference.forces import ForceField

VELOCITIES = 0  # the seed's stream for the velocities


def fcc(cells: int, density: float, device):
    """(positions (4 cells^3, 3) float64, box edge): FCC unit cells of edge a,
    atoms at (0,0,0), (1/2,1/2,0), (1/2,0,1/2), (0,1/2,1/2) of each cell,
    shifted by a/4."""
    n = 4 * cells**3
    box = (n / density) ** (1.0 / 3.0)
    a = box / cells
    base = torch.tensor([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]], dtype=torch.float64, device=device)
    g = torch.arange(cells, dtype=torch.float64, device=device)
    grid = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 1, 3)
    return ((grid + base[None]) * a).reshape(-1, 3) + 0.25 * a, box


def velocities(n: int, temperature: float, mass: float, gen: torch.Generator, device):
    """Maxwell-Boltzmann velocities at kT = temperature, total momentum zero."""
    v = torch.randn((n, 3), generator=gen, dtype=torch.float64, device=device) * np.sqrt(temperature / mass)
    return v - v.mean(0)


def build(cfg: dict, traffic: dict, seed: int, device, clock: Clock) -> Sim:
    from emdee_tpu_torch import (
        LennardJonesModel, cell_dense_init, detect_uniform_params, lennard_jones_atom, make_cell_dense_sim,
        suggest_cell_dense_config,
    )

    if traffic["ensemble"] != "nve":
        raise ValueError(f"lj_melt runs NVE, not {traffic['ensemble']!r}")
    if device.type == "cuda":
        from emdee_tpu_torch.csrc import build as kernels

        kernels.load()
    pos, box = fcc(cfg["fcc_cells"], cfg["density"], device)
    n = len(pos)
    vel = velocities(n, cfg["temperature"], cfg["mass"], seeded(seed, VELOCITIES, device), device)
    masses = np.full(n, cfg["mass"])
    params = lennard_jones_atom(np.full(n, cfg["epsilon"]), np.full(n, cfg["sigma"]), device=device)
    config = suggest_cell_dense_config(n, box, cutoff=cfg["cutoff"], switch=cfg["switch"], skin=cfg["skin"])
    state = cell_dense_init(pos, vel, masses, params, config, device=device)
    if bool(state.overflow):
        raise RuntimeError("the lattice start overflows the suggested capacity")
    model = LennardJonesModel.create(cfg["cutoff"], cfg["switch"], device=device)
    rollout, energy = make_cell_dense_sim(config, model, dt=cfg["dt"], backend=traffic["backend"],
                                          uniform_params=detect_uniform_params(params), uniform_mass=cfg["mass"],
                                          rebin=traffic["rebin"])
    del pos, vel
    clock.mark("state")

    state = rollout(state, num_steps=traffic["equil_steps"], rebin_every=traffic["equil_rebin_every"])
    if bool(state.overflow):
        raise RuntimeError("the equilibration tripped the overflow flag")
    v = torch.where(state.valid[..., None], state.velocities, 0.0).double()
    t_eq = cfg["mass"] * float((v * v).sum()) / (3.0 * n - 3.0)
    clock.mark("equil")

    full = lambda v: torch.full((n,), float(v), dtype=torch.float64, device=device)  # noqa: E731
    return Sim(
        state=state, rollout=rollout, energy=energy, rng=None, num_atoms=n, rebin_every=int(traffic["rebin_every"]),
        dt=cfg["dt"],
        geometry={"cells_per_dim": config.cells_per_dim, "capacity": config.capacity, "box": box,
                  "skin": config.skin, "equil_temperature": t_eq},
        forcefield=ForceField(box=box, cutoff=cfg["cutoff"], switch=cfg["switch"], masses=full(cfg["mass"]),
                              sigma=full(cfg["sigma"]), epsilon=full(cfg["epsilon"])),
        csvr=None, work={"force": "lj", "rebin_fields": 7},
    )
