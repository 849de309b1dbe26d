"""Two small molecular fixtures, built from numpy seeds, that the card's
tests (`tests/test_torch_cuda.py`), the CPU differential tests and
`chip_smoke.py` share.

- The charged fixture of the reference's tests/test_pallas_kernel.py:
  110-160: 864 atoms on a jittered cubic lattice, ±0.3 charges (neutral),
  synthetic triplet exclusions with scales 0 and 0.5 (LJ) / 0.8 (Coulomb),
  and harmonic bonds (k = 40, r0 = 1.1) on every other exclusion pair for
  the kernel's bond tags.
- The triatomic fixture of tests/test_grid_sharded_pallas.py:36-104: 125
  bent A–B–C molecules on a 5³ lattice (375 atoms, box 12.5), bonds A–B and
  B–C, the A–B–C angle, and the 1-3 pair A–C scaled 0.5 / 0.8; at
  exclusion band 1 it has leftover pairs and shared and exclusive terms.
- A crowded charged box (`crowded_arrays`): M³ cells each holding one
  jittered lattice of more than 96 or 192 atoms, with the charged
  fixture's charges, exclusions and bonds, for the streaming family's
  variants above three centre slots a lane (C > 96).
- The grid's charged fixture of tests/test_grid_sharded.py:150-202: 2,048
  atoms at ρ = 0.09, ±0.25 charges (neutral), the pairs (i, i+1) and
  (i+1, i+2) of every triplet excluded at 0.5 (LJ) / 0.8 (Coulomb); M = 10,
  C = 8.

`*_arrays` return numpy only, so the JAX side of a differential test builds
its own objects from the same numbers; the other functions build the
port's on a device.
"""

from __future__ import annotations

import numpy as np
import torch

CUTOFF, SWITCH = 2.5, 2.0  # LJ units, as both reference tests
CHARGED_SKIN = 0.3


def charged_arrays() -> dict:
    """The charged fixture as numpy arrays: n, pos, box, vel, q, the
    exclusion pairs with their LJ and Coulomb scales, and bonds =
    (pairs, k, r0)."""
    from emdee_tpu_torch.utils.lattice import cubic_lattice, maxwell_boltzmann

    n = 864
    pos, box = cubic_lattice(n, 0.5, jitter=0.15, seed=5)
    return dict(n=n, pos=pos, box=box, vel=maxwell_boltzmann(n, 1.0, seed=7), **_charged_terms(n))


def _charged_terms(n: int) -> dict:
    """The charged fixture's terms over atoms 0 … n−1: ±0.3 charges
    (neutral), the triplet exclusions (i, i+1), (i+1, i+2) with their LJ
    and Coulomb scales, and bonds on every other pair."""
    q = np.where(np.arange(n) % 2 == 0, 0.3, -0.3).astype(np.float32)
    q -= q.mean()
    base = np.arange(0, n - 2, 3)
    pairs = np.concatenate([np.stack([base, base + 1], 1), np.stack([base + 1, base + 2], 1)])
    ljs = np.where(np.arange(len(pairs)) % 2 == 0, 0.0, 0.5).astype(np.float32)
    cs = np.where(np.arange(len(pairs)) % 2 == 0, 0.0, 0.8).astype(np.float32)
    bonds = (pairs[0::2], np.full(len(base), 40.0, np.float32), np.full(len(base), 1.1, np.float32))
    return dict(q=q, pairs=pairs, ljs=ljs, cs=cs, bonds=bonds)


def crowded_arrays(per_cell, m: int = 3, edge: float = 5.0, seed: int = 9) -> dict:
    """A box of m³ cells of side `edge`, each holding one lattice of
    per_cell = (nx, ny, nz) sites, each site moved by at most 0.1 on each
    axis (numpy `seed`), so every cell holds exactly nx·ny·nz atoms; with
    the charged fixture's terms (`_charged_terms`) over the atoms in cell
    order.  (5, 5, 4) at edge 6 gives cells of 100 atoms (two 96-entry
    chunks), (7, 7, 4) at edge 8.5 cells of 196 (three), their forces,
    energies and virials no larger than the charged fixture's."""
    from emdee_tpu_torch.utils.lattice import maxwell_boltzmann

    rng = np.random.default_rng(seed)
    dims = np.asarray(per_cell)
    site = np.stack(np.meshgrid(*(np.arange(d) for d in dims), indexing="ij"), -1).reshape(-1, 3)
    site = (site + 0.5) * edge / dims
    corner = np.stack(np.meshgrid(*([np.arange(m)] * 3), indexing="ij"), -1).reshape(-1, 3) * edge
    pos = (corner[:, None, :] + site[None]).reshape(-1, 3)
    pos = pos + rng.uniform(-0.1, 0.1, pos.shape)
    n = len(pos)
    return dict(n=n, pos=pos, box=m * edge, vel=maxwell_boltzmann(n, 1.0, seed=seed + 1), **_charged_terms(n))


def charged_fixture(device, capacity=None, arrays=None, cells_per_dim=None):
    """The charged fixture on the port, every atom moved 0.45·skin along its
    velocity so that a real fraction crosses cell faces and the periodic
    seam: (state, config, LJ model, DSF model, slot tags with bond
    weights).  capacity: C in place of the suggested one (24); arrays: the
    system's arrays in place of `charged_arrays()` (e.g. `crowded_arrays`),
    cells_per_dim its M."""
    from emdee_tpu_torch import (
        DSFCoulomb, LennardJonesModel, build_exclusion_tables, cell_dense_init, lennard_jones_atom,
        make_exclusion_aux_fn, suggest_cell_dense_config,
    )

    a = charged_arrays() if arrays is None else arrays
    n = a["n"]
    config = suggest_cell_dense_config(n, a["box"], cutoff=CUTOFF, switch=SWITCH, skin=CHARGED_SKIN)
    if capacity is not None:
        config = config._replace(capacity=capacity)
    if cells_per_dim is not None:
        config = config._replace(cells_per_dim=cells_per_dim)
    st = cell_dense_init(a["pos"], a["vel"], np.ones(n), lennard_jones_atom(np.ones(n), np.ones(n), device=device),
                         config, charges=a["q"], device=device)
    v = st.velocities
    st = st._replace(positions=torch.where(
        st.valid[..., None], st.positions + (0.45 * CHARGED_SKIN / float(v.abs().max())) * v, 0.0))
    tabs, _, bond_tabs, _ = build_exclusion_tables(n, a["pairs"], a["ljs"], a["cs"], bonds=a["bonds"])
    tags = make_exclusion_aux_fn(n, *tabs, bond_tabs=bond_tabs)(st)
    coul = DSFCoulomb.create(CUTOFF, alpha=0.25, coulomb_constant=1.0, device=device)
    return st, config, LennardJonesModel.create(CUTOFF, SWITCH, device=device), coul, tags


def triatomic_arrays(seed: int = 71) -> dict:
    """The triatomic fixture as numpy arrays: n, box, pos, vel, q, the
    exclusion pairs with their scales, bond pairs (r0 0.8, k 100) and
    angle triples (θ0 π/2, k 20)."""
    rng = np.random.default_rng(seed)
    n_side, spacing = 5, 2.5
    sites = np.stack(np.meshgrid(*([np.arange(n_side)] * 3), indexing="ij"), axis=-1).reshape(-1, 3) * spacing + 0.6
    n_mol = len(sites)
    pos = np.concatenate([sites + [0.8, 0.0, 0.0], sites, sites + [0.0, 0.8, 0.0]], axis=1).reshape(-1, 3)
    pos += rng.normal(scale=0.02, size=pos.shape)
    n = 3 * n_mol
    vel = rng.normal(scale=0.15, size=(n, 3))
    q = np.tile(np.array([0.25, -0.5, 0.25], np.float32), n_mol)
    a = np.arange(0, n, 3)
    b, c = a + 1, a + 2
    bond_pairs = np.concatenate([np.stack([a, b], 1), np.stack([b, c], 1)])
    pairs = np.concatenate([bond_pairs, np.stack([a, c], 1)])
    ljs = np.concatenate([np.ones(2 * n_mol, np.float32), np.full(n_mol, 0.5, np.float32)])
    cs = np.concatenate([np.ones(2 * n_mol, np.float32), np.full(n_mol, 0.8, np.float32)])
    return dict(n=n, box=n_side * spacing, pos=pos, vel=vel, q=q, pairs=pairs, ljs=ljs, cs=cs,
                bond_pairs=bond_pairs, bond_r0=0.8, bond_k=100.0, angles=np.stack([a, b, c], 1),
                angle_theta0=np.pi / 2, angle_k=20.0)


def triatomic_bonded(fx: dict, device):
    """The triatomic fixture's bonds and angles as the port's `BondedSystem`."""
    from emdee_tpu_torch import AngleTable, BondedSystem, BondTable

    t = lambda x, dt: torch.from_numpy(np.asarray(x, dt)).to(device)  # noqa: E731
    nb, na = len(fx["bond_pairs"]), len(fx["angles"])
    return BondedSystem(
        bonds=BondTable(t(fx["bond_pairs"], np.int64), t(np.full(nb, fx["bond_r0"]), np.float32),
                        t(np.full(nb, fx["bond_k"]), np.float32), t(np.ones(nb), np.bool_)),
        angles=AngleTable(t(fx["angles"], np.int64), t(np.full(na, fx["angle_theta0"]), np.float32),
                          t(np.full(na, fx["angle_k"]), np.float32), t(np.ones(na), np.bool_)),
        torsions=None, impropers=None)


def triatomic_sim(device, backend: str, dt: float = 1e-3):
    """The triatomic fixture on the molecular dense engine at band 1:
    (initial state, (rollout, energy) of `make_molecular_dense_sim`)."""
    from emdee_tpu_torch import DSFCoulomb, lennard_jones_atom, make_molecular_dense_sim

    fx = triatomic_arrays()
    n = fx["n"]
    st, cfg, model = triatomic_state(device)
    sim = make_molecular_dense_sim(
        cfg, model, dt, n, params=lennard_jones_atom(np.ones(n), np.ones(n), device=device), charges=fx["q"],
        coulomb=DSFCoulomb.create(CUTOFF, alpha=0.25, coulomb_constant=1.0, device=device),
        exclusion_pairs=fx["pairs"], exclusion_scales=fx["ljs"], exclusion_scales_coulomb=fx["cs"],
        bonded=triatomic_bonded(fx, device), backend=backend, exclusion_band=1)
    return st, sim


def grid_charged_arrays() -> dict:
    """The grid's charged fixture as numpy arrays: n, pos, box, vel, q and
    the exclusion pairs with their LJ and Coulomb scales."""
    from emdee_tpu_torch.utils.lattice import cubic_lattice, maxwell_boltzmann

    n = 2048
    pos, box = cubic_lattice(n, 0.09, jitter=0.1, seed=31)
    q = np.where(np.arange(n) % 2 == 0, 0.25, -0.25).astype(np.float32)
    q -= q.mean()
    base = np.arange(0, n - 2, 3)
    pairs = np.concatenate([np.stack([base, base + 1], 1), np.stack([base + 1, base + 2], 1)])
    return dict(n=n, pos=pos, box=box, vel=maxwell_boltzmann(n, 0.9, seed=32), q=q, pairs=pairs,
                ljs=np.full(len(pairs), 0.5, np.float32), cs=np.full(len(pairs), 0.8, np.float32))


def grid_charged_config(a: dict):
    """The fixture's config: the suggested one with M cut to an even count
    (at least 4), as the reference test cuts it."""
    from emdee_tpu_torch import suggest_cell_dense_config

    config = suggest_cell_dense_config(a["n"], a["box"], cutoff=CUTOFF, switch=SWITCH, skin=CHARGED_SKIN)
    return config._replace(cells_per_dim=max((config.cells_per_dim // 2) * 2, 4))


def grid_charged_kwargs(device) -> dict:
    """The molecular options of `make_grid_sharded_sim` for the grid's
    charged fixture on `device`: DSF (α = 0.25, kC = 1) and the full-width
    tag tables."""
    from emdee_tpu_torch import DSFCoulomb, build_exclusion_tables

    a = grid_charged_arrays()
    return dict(coulomb=DSFCoulomb.create(CUTOFF, alpha=0.25, coulomb_constant=1.0, device=device),
                excl_tables=build_exclusion_tables(a["n"], a["pairs"], a["ljs"], a["cs"]))


def grid_charged_state(device):
    """(state, config, LJ model) of the grid's charged fixture on `device`."""
    from emdee_tpu_torch import LennardJonesModel, cell_dense_init, lennard_jones_atom

    a = grid_charged_arrays()
    n = a["n"]
    config = grid_charged_config(a)
    st = cell_dense_init(a["pos"], a["vel"], np.ones(n), lennard_jones_atom(np.ones(n), np.ones(n), device=device),
                         config, charges=a["q"], device=device)
    return st, config, LennardJonesModel.create(CUTOFF, SWITCH, device=device)


def triatomic_grid_kwargs(device, band: int = 1) -> dict:
    """The molecular options of `make_grid_sharded_sim` for the triatomic
    fixture at exclusion band `band` (tests/test_grid_sharded_pallas.py:
    98-103): DSF, the tag tables, the bonds and angles as term rows, the
    leftover pairs beyond the band with the atoms' LJ parameters and
    charges."""
    from emdee_tpu_torch import DSFCoulomb, build_exclusion_tables, lennard_jones_atom

    fx = triatomic_arrays()
    n = fx["n"]
    tabs, leftover = build_exclusion_tables(n, fx["pairs"], fx["ljs"], fx["cs"], band_e=band)
    return dict(coulomb=DSFCoulomb.create(CUTOFF, alpha=0.25, coulomb_constant=1.0, device=device),
                excl_tables=tabs, bonded=triatomic_bonded(fx, device), excl_leftover=leftover,
                atom_params=lennard_jones_atom(np.ones(n), np.ones(n), device=device), atom_charges=fx["q"])


def triatomic_state(device, positions=None):
    """(state, config, LJ model) of the triatomic fixture on `device`
    (`positions` in place of the fixture's, if given)."""
    from emdee_tpu_torch import LennardJonesModel, cell_dense_init, lennard_jones_atom, suggest_cell_dense_config

    fx = triatomic_arrays()
    n = fx["n"]
    cfg = suggest_cell_dense_config(n, fx["box"], cutoff=CUTOFF, switch=SWITCH, skin=0.3)
    pos = fx["pos"] if positions is None else positions
    st = cell_dense_init(pos, fx["vel"], np.ones(n), lennard_jones_atom(np.ones(n), np.ones(n), device=device), cfg,
                         charges=fx["q"], device=device)
    return st, cfg, LennardJonesModel.create(CUTOFF, SWITCH, device=device)
