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
    q = np.where(np.arange(n) % 2 == 0, 0.3, -0.3).astype(np.float32)
    q -= q.mean()
    base = np.arange(0, n - 2, 3)
    pairs = np.concatenate([np.stack([base, base + 1], 1), np.stack([base + 1, base + 2], 1)])
    ljs = np.where(np.arange(len(pairs)) % 2 == 0, 0.0, 0.5).astype(np.float32)
    cs = np.where(np.arange(len(pairs)) % 2 == 0, 0.0, 0.8).astype(np.float32)
    bonds = (pairs[0::2], np.full(len(base), 40.0, np.float32), np.full(len(base), 1.1, np.float32))
    return dict(n=n, pos=pos, box=box, vel=maxwell_boltzmann(n, 1.0, seed=7), q=q, pairs=pairs, ljs=ljs, cs=cs,
                bonds=bonds)


def charged_fixture(device):
    """The charged fixture on the port, every atom moved 0.45·skin along its
    velocity so that a real fraction crosses cell faces and the periodic
    seam: (state, config, LJ model, DSF model, slot tags with bond
    weights)."""
    from emdee_tpu_torch import (
        DSFCoulomb, LennardJonesModel, build_exclusion_tables, cell_dense_init, lennard_jones_atom,
        make_exclusion_aux_fn, suggest_cell_dense_config,
    )

    a = charged_arrays()
    n = a["n"]
    config = suggest_cell_dense_config(n, a["box"], cutoff=CUTOFF, switch=SWITCH, skin=CHARGED_SKIN)
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
    from emdee_tpu_torch import (
        DSFCoulomb, LennardJonesModel, cell_dense_init, lennard_jones_atom, make_molecular_dense_sim,
        suggest_cell_dense_config,
    )

    fx = triatomic_arrays()
    n = fx["n"]
    cfg = suggest_cell_dense_config(n, fx["box"], cutoff=CUTOFF, switch=SWITCH, skin=0.3)
    params = lennard_jones_atom(np.ones(n), np.ones(n), device=device)
    st = cell_dense_init(fx["pos"], fx["vel"], np.ones(n), params, cfg, charges=fx["q"], device=device)
    sim = make_molecular_dense_sim(
        cfg, LennardJonesModel.create(CUTOFF, SWITCH, device=device), dt, n, params=params, charges=fx["q"],
        coulomb=DSFCoulomb.create(CUTOFF, alpha=0.25, coulomb_constant=1.0, device=device),
        exclusion_pairs=fx["pairs"], exclusion_scales=fx["ljs"], exclusion_scales_coulomb=fx["cs"],
        bonded=triatomic_bonded(fx, device), backend=backend, exclusion_band=1)
    return st, sim
