"""The flexible-water box: waters on a cubic lattice, each in a random
orientation drawn from the seed, velocities drawn at the thermostat's
temperature, on the program's molecular dense-cell engine (DSF Coulomb,
exclusion tags, bonds and angles), as a frozen, vectorised copy of
`emdee_tpu_torch/tools/water.py`'s generator.

Units: Angstrom, amu, e, kJ/mol; time in 0.1 ps.  Configuration keys:
waters_per_side, spacing, cutoff, switch, skin, dt, alpha,
coulomb_constant, and the model: charge_o, charge_h, sigma_o, epsilon_o,
mass_o, mass_h, bond_r0, bond_k, angle_theta0, angle_k (hydrogens carry no
LJ).  Traffic keys: ensemble ("csvr"), temperature, tau, kB, backend, rebin
("shift" or "sort"), equil_steps, equil_rebin_every, rebin_every.
"""

from __future__ import annotations

import numpy as np
import torch

from mdbench.lib.sim import Clock, Sim, seeded
from mdbench.reference.forces import ForceField

ORIENTATIONS, VELOCITIES, THERMOSTAT = 1, 2, 3  # the seed's streams


def lattice_waters(cfg: dict, gen: torch.Generator, device):
    """(positions (3W, 3) float64 in [0, L), box edge): a water on each site
    of a cubic lattice of `spacing`, O at the site, H1 and H2 at bond_r0 from
    it at angle_theta0, turned by a uniform random rotation (a normalised
    Gaussian quaternion); atoms O, H1, H2 per water."""
    side, h = cfg["waters_per_side"], cfg["spacing"]
    box = side * h
    g = torch.arange(side, dtype=torch.float64, device=device)
    sites = (torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3) + 0.5) * h
    r0, t0 = cfg["bond_r0"], cfg["angle_theta0"]
    local = torch.tensor([[0.0, 0.0, 0.0], [r0, 0.0, 0.0], [r0 * np.cos(t0), r0 * np.sin(t0), 0.0]],
                         dtype=torch.float64, device=device)
    q = torch.randn((len(sites), 4), generator=gen, dtype=torch.float64, device=device)
    w, x, y, z = (q / q.norm(dim=1, keepdim=True)).T
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], 1)
    pos = (sites[:, None, :] + torch.einsum("wij,aj->wai", rot, local)).reshape(-1, 3)
    return torch.remainder(pos, box), box


def per_atom(n_w: int, o: float, h: float, device) -> torch.Tensor:
    return torch.tensor([o, h, h], dtype=torch.float64, device=device).repeat(n_w)


def topology(n_w: int, device):
    """(bonds (2W, 2), angles (W, 3) centred on O, exclusion pairs (3W, 2)):
    O-H1 and O-H2 bonded, H1-O-H2 an angle, the three pairs of each water
    excluded from LJ and Coulomb."""
    o = torch.arange(0, 3 * n_w, 3, device=device)
    h1, h2 = o + 1, o + 2
    bonds = torch.cat([torch.stack([o, h1], 1), torch.stack([o, h2], 1)])
    return bonds, torch.stack([h1, o, h2], 1), torch.cat([bonds, torch.stack([h1, h2], 1)])


def exclusion_table(n_w: int, device) -> torch.Tensor:
    """(3W, 2) excluded partners of each atom: the two other atoms of its water."""
    base = 3 * torch.arange(n_w, device=device)[:, None, None]
    other = torch.tensor([[1, 2], [0, 2], [0, 1]], device=device)
    return (base + other[None]).reshape(-1, 2)


def _pad8(rows: torch.Tensor, fill: int):
    """`rows` padded with `fill` to a multiple of 8 rows, and its valid mask."""
    cap = -(-len(rows) // 8) * 8
    pad = torch.full((cap - len(rows),) + rows.shape[1:], fill, dtype=rows.dtype, device=rows.device)
    return torch.cat([rows, pad]), torch.arange(cap, device=rows.device) < len(rows)


def bonded_tables(bonds, angles, cfg: dict, n: int):
    """The bonds and angles as the program's `BondedSystem`."""
    from emdee_tpu_torch import AngleTable, BondedSystem, BondTable

    b_atoms, b_valid = _pad8(bonds, n)
    a_atoms, a_valid = _pad8(angles, n)
    f32 = lambda v, ok: torch.where(ok, v, 0.0).to(torch.float32)  # noqa: E731
    ones_b, ones_a = torch.ones(len(b_atoms), device=bonds.device), torch.ones(len(a_atoms), device=bonds.device)
    return BondedSystem(
        bonds=BondTable(atoms=b_atoms, length=f32(cfg["bond_r0"] * ones_b, b_valid),
                        k=f32(cfg["bond_k"] * ones_b, b_valid), valid=b_valid),
        angles=AngleTable(atoms=a_atoms, theta0=f32(cfg["angle_theta0"] * ones_a, a_valid),
                          k=f32(cfg["angle_k"] * ones_a, a_valid), valid=a_valid),
        torsions=None, impropers=None,
    )


def start_capacity(pos: torch.Tensor, m: int, box: float) -> int:
    """The largest cell occupancy of `pos` on an m^3 grid, rounded up to 8."""
    v = torch.clamp(torch.floor(torch.remainder(pos, box) * (m / box)).long(), 0, m - 1)
    top = int(torch.bincount(v[:, 0] + m * (v[:, 1] + m * v[:, 2]), minlength=m**3).max())
    return -(-top // 8) * 8


def build(cfg: dict, traffic: dict, seed: int, device, clock: Clock) -> Sim:
    from emdee_tpu_torch import (
        CSVRConfig, LennardJonesModel, cell_dense_init, lennard_jones_atom, make_molecular_dense_sim,
        suggest_cell_dense_config,
    )
    from emdee_tpu_torch.potentials.coulomb import DSFCoulomb

    if traffic["ensemble"] != "csvr":
        raise ValueError(f"water_box runs CSVR NVT, not {traffic['ensemble']!r}")
    if device.type == "cuda":
        from emdee_tpu_torch.csrc import build as kernels

        kernels.load()
    pos, box = lattice_waters(cfg, seeded(seed, ORIENTATIONS, device), device)
    n = len(pos)
    n_w = n // 3
    masses = per_atom(n_w, cfg["mass_o"], cfg["mass_h"], device)
    charges = per_atom(n_w, cfg["charge_o"], cfg["charge_h"], device)
    sigma = per_atom(n_w, cfg["sigma_o"], 0.0, device)
    epsilon = per_atom(n_w, cfg["epsilon_o"], 0.0, device)
    kT = traffic["kB"] * traffic["temperature"]
    vel = torch.randn((n, 3), generator=seeded(seed, VELOCITIES, device), dtype=torch.float64, device=device)
    vel = vel * torch.sqrt(kT / masses)[:, None]
    vel = vel - (masses[:, None] * vel).sum(0) / masses.sum()
    bonds, angles, pairs = topology(n_w, device)

    config = suggest_cell_dense_config(n, box, cutoff=cfg["cutoff"], switch=cfg["switch"], skin=cfg["skin"])
    config = config._replace(capacity=max(config.capacity, start_capacity(pos, config.cells_per_dim, box)))
    params = lennard_jones_atom(epsilon.cpu().numpy(), sigma.cpu().numpy(), device=device)
    state = cell_dense_init(pos, vel, masses, params, config, charges=charges, device=device)
    if bool(state.overflow):
        raise RuntimeError("the lattice start overflows its own capacity")
    model = LennardJonesModel.create(cfg["cutoff"], cfg["switch"], device=device)
    coulomb = DSFCoulomb.create(cfg["cutoff"], cfg["alpha"], cfg["coulomb_constant"], device=device)
    thermostat = CSVRConfig(traffic["temperature"], tau=traffic["tau"], kB=traffic["kB"])
    rollout, energy = make_molecular_dense_sim(
        config, model, cfg["dt"], n, params=params, charges=charges.cpu().numpy(), coulomb=coulomb,
        exclusion_pairs=pairs.cpu().numpy(), exclusion_scales=np.zeros(len(pairs), np.float32),
        bonded=bonded_tables(bonds, angles, cfg, n), backend=traffic["backend"], thermostat=thermostat,
        rebin=traffic["rebin"])
    del pos, vel
    clock.mark("state")

    rng = seeded(seed, THERMOSTAT, device)
    state = rollout(state, num_steps=traffic["equil_steps"], rebin_every=traffic["equil_rebin_every"], rng=rng)
    if bool(state.overflow):
        raise RuntimeError("the equilibration tripped the overflow flag")
    clock.mark("equil")

    full = lambda v, like: torch.full((len(like),), float(v), dtype=torch.float64, device=device)  # noqa: E731
    return Sim(
        state=state, rollout=rollout, energy=energy, rng=rng, num_atoms=n, rebin_every=int(traffic["rebin_every"]),
        dt=cfg["dt"],
        geometry={"cells_per_dim": config.cells_per_dim, "capacity": config.capacity, "box": box,
                  "skin": config.skin},
        forcefield=ForceField(
            box=box, cutoff=cfg["cutoff"], switch=cfg["switch"], masses=masses, sigma=sigma, epsilon=epsilon,
            charges=charges, alpha=cfg["alpha"], coulomb_constant=cfg["coulomb_constant"],
            exclusions=exclusion_table(n_w, device), bonds=bonds, bond_k=full(cfg["bond_k"], bonds),
            bond_r0=full(cfg["bond_r0"], bonds), angles=angles, angle_k=full(cfg["angle_k"], angles),
            angle_theta0=full(cfg["angle_theta0"], angles)),
        csvr={"temperature": traffic["temperature"], "tau": traffic["tau"], "kB": traffic["kB"]},
        work={"force": "molecular", "e_tags": 2, "e_bonds": 2, "rebin_fields": 14},
    )
