"""The flexible-water boxes that `chip_smoke.py` drives on the molecular
dense engine: 32³ = 32,768 waters (98,304 atoms) on a cubic lattice of
spacing 3.11 Å (liquid density, the lattice of
emdee_tpu/modelling/solvate.py `build_solvated_polyalanine`, without the
peptide) in a 99.52 Å box, each water in a random orientation from a numpy
seed; and the same lattice at 69³ = 328,509 waters (985,527 atoms, 214.59 Å),
the size of bench_all.py's 1M melt.

Model: flexible TIP3P — Jorgensen et al., J. Chem. Phys. 79, 926 (1983),
with the harmonic bond and angle terms of OpenMM's tip3p.xml — in the units
of the reference's `dense_sim_from_system`: Å, amu, e and kJ/mol, so time
is in units of 0.1 ps and kC = 1389.35456.  Each water's three pairs (O–H
twice, H–H) are excluded from LJ and Coulomb (scale 0): E = 2 tags an atom.
Run config: bench_all.py's molecular run (cutoff 7.0 Å, switch 6.0, skin
1.0, dt 5e-4, spill geometry) with DSF α = 0.2 Å⁻¹.  Velocities are
Maxwell-Boltzmann at 300 K; the lattice start holds much potential energy,
so an NVE start heats the box (to ~730 K in 100 fs on the H100), and
`chip_smoke.py` equilibrates it with CSVR at 300 K (τ = 10 fs) instead.

The same model as an OpenMM-style force-field XML is `FORCE_FIELD`
(`emdee_tpu_torch/data/tip3p_flexible.xml`, nm and kJ/mol), and
`write_box_pdb` writes the box as a PDB of standard HOH residues, so that
`System(pdb, ForceField(FORCE_FIELD))` builds the same box through the
modelling layer (bonds from the PDB alias table; masses from it too: O
15.999 there, 15.9994 here); `check_system` holds such a System's tables
against the box's.  The hand-built box stays the witness.

    python3 -m emdee_tpu_torch.tools.water [CHUNKS]

runs the box on the card from its lattice start on the plain config (M =
12, C = 80, `backend="auto"`, which resolves to the streaming family K5c
there; the 985,527-atom box's plain config is M = 26, C = 88, also
streaming), with CSVR at 300 K and then without a
thermostat, CHUNKS × 2,000 steps each (default 8: 800 fs), and after each
chunk re-initialises the state on the spill config (M = 12, C = 64): it
prints ms/step, T, the potential energy, the true-cell occupancy (mean,
sd, max) and whether the spill init holds, and if it does, how many rebin
blocks the spill rollout runs before its flag.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

SEED = 5
N_SIDE = 32  # 32³ waters
N_SIDE_1M = 69  # 69³ waters: 985,527 atoms
SPACING = 3.11  # Å
CUTOFF, SWITCH, SKIN, DT, ALPHA = 7.0, 6.0, 1.0, 5e-4, 0.2
EQ_STEPS, REBIN_EVERY = 2000, 6  # the equilibration chunk (100 fs) and the rebin interval
TEMPERATURE = 300.0  # K
TAU = 0.1  # CSVR time constant: 10 fs in the time unit of 0.1 ps
KB = 0.0083144626  # kJ/mol/K

Q_O, Q_H = -0.834, 0.417
SIGMA_O, EPS_O = 3.15061, 0.636386  # Å, kJ/mol; H carries no LJ
MASS_O, MASS_H = 15.9994, 1.008
BOND_R0, BOND_K = 0.9572, 4627.504  # Å, kJ/mol/Å²
ANGLE_THETA0, ANGLE_K = 1.82421813418, 836.8  # rad, kJ/mol/rad²
# The rigid TIP3P geometry: O at the origin, H1 along x, H2 at θ0.
_LOCAL = np.array([[0.0, 0.0, 0.0], [0.9572, 0.0, 0.0], [-0.2400, 0.9266, 0.0]])
# The model as a force-field XML (nm, kJ/mol), shared by the CPU tests and
# chip_smoke.py.
FORCE_FIELD = Path(__file__).resolve().parent.parent / "data" / "tip3p_flexible.xml"
LENGTH_SCALE = 10.0  # the XML's nm → Å


def water_box(n_side: int = N_SIDE, seed: int = SEED) -> dict:
    """numpy arrays of the box: positions (N, 3) in [0, L), velocities,
    masses, charges, sigma, epsilon (N,), bonds (B, 2) with bond_k and
    bond_r0, angles (A, 3) with angle_k and angle_theta0, exclusion pairs
    (P, 2) with their scales, and the box edge; atoms O, H1, H2 per water."""
    rng = np.random.default_rng(seed)
    box = n_side * SPACING
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    sites = (grid + 0.5) * SPACING
    q = rng.normal(size=(len(sites), 4))
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    rot = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], 1)  # (W, 3, 3)
    pos = (sites[:, None, :] + np.einsum("wij,aj->wai", rot, _LOCAL)).reshape(-1, 3)
    pos = pos - np.floor(pos / box) * box
    n_w = len(sites)
    n = 3 * n_w
    per = lambda o, h: np.tile(np.array([o, h, h], np.float64), n_w)  # noqa: E731
    masses = per(MASS_O, MASS_H)
    vel = rng.normal(size=(n, 3)) * np.sqrt(KB * TEMPERATURE / masses)[:, None]
    vel -= (masses[:, None] * vel).sum(0) / masses.sum()  # zero total momentum
    o = np.arange(0, n, 3)
    h1, h2 = o + 1, o + 2
    bonds = np.concatenate([np.stack([o, h1], 1), np.stack([o, h2], 1)])
    pairs = np.concatenate([bonds, np.stack([h1, h2], 1)])
    return {
        "positions": pos, "velocities": vel, "masses": masses, "charges": per(Q_O, Q_H),
        "sigma": per(SIGMA_O, 0.0), "epsilon": per(EPS_O, 0.0),
        "bonds": bonds, "bond_k": np.full(len(bonds), BOND_K), "bond_r0": np.full(len(bonds), BOND_R0),
        "angles": np.stack([h1, o, h2], 1), "angle_k": np.full(n_w, ANGLE_K),
        "angle_theta0": np.full(n_w, ANGLE_THETA0),
        "exclusion_pairs": pairs, "exclusion_scales": np.zeros(len(pairs), np.float32),
        "box": float(box),
    }


def write_box_pdb(path, box: dict) -> None:
    """Write the box as a PDB through the port's `io/pdb.py`: its CRYST1
    cell, and per water one HOH residue of ATOM records O, H1, H2 (chain A,
    resids 1, 2, … written modulo 10,000), no CONECT records."""
    from emdee_tpu_torch.io.pdb import PDBFrame, write_pdb

    n = len(box["masses"])
    n_w = n // 3
    write_pdb(str(path), PDBFrame(
        names=["O", "H1", "H2"] * n_w, resnames=["HOH"] * n, resids=np.repeat(np.arange(1, n_w + 1), 3),
        chainids=["A"] * n, is_hetatm=np.zeros(n, bool), elements=["O", "H", "H"] * n_w,
        positions=box["positions"], box_lengths=np.full(3, box["box"]),
    ))


def check_system(system, bonded, box: dict) -> None:
    """Raise AssertionError unless a System built from `write_box_pdb`'s file
    and `FORCE_FIELD`, with its bonded tables `bonded` (`build_bonded_system`
    at `LENGTH_SCALE`), describes the box: atoms, residues, positions (to
    the PDB's 1e-3 Å), charges; masses per the PDB alias table; LJ after the
    unit change (σ only where ε ≠ 0: the XML's σ_H = 1 nm meets ε_H = 0);
    exclusion pairs with their LJ and Coulomb scales; bonds and angles
    (atoms, r0, k, θ0) in float32, as the kernels read them."""
    from emdee_tpu_torch.modelling.pdb_data import load_pdb_aliases

    def same(what, got, want):
        if not np.array_equal(got, want):
            raise AssertionError(f"System vs tools/water.py: {what} differ")

    n = len(box["masses"])
    n_w = n // 3
    same("atom count", len(system), n)
    same("names", system.names, ["O", "H1", "H2"] * n_w)
    same("residues", system.resnames, ["HOH"] * n_w)
    same("residue spans", system.residue_spans, [(3 * i, 3 * i + 3) for i in range(n_w)])
    if not np.abs(system.positions - box["positions"]).max() <= 5e-4:
        raise AssertionError("System vs tools/water.py: positions differ beyond the PDB's rounding")
    same("charges", system.charges, box["charges"])
    masses = load_pdb_aliases()[0]
    same("masses", system.masses, np.tile([masses["O"], masses["H"], masses["H"]], n_w))
    nb = system.force_field.nonbonded
    eps = np.array([nb[t]["epsilon"] for t in system.ff_types])
    sigma = np.array([nb[t]["sigma"] for t in system.ff_types]) * LENGTH_SCALE
    same("LJ epsilon", eps, box["epsilon"])
    same("LJ sigma", np.where(eps > 0, sigma, 0.0), box["sigma"])
    by_pair = lambda a: np.lexsort(np.asarray(a).T[::-1])  # noqa: E731  (row order of sorted pairs)
    pairs, lj_s, c_s = system.exclusions(coulomb=True)
    mine, ref = by_pair(pairs), by_pair(box["exclusion_pairs"])
    same("exclusion pairs", pairs[mine], box["exclusion_pairs"][ref])
    same("exclusion LJ scales", lj_s[mine], box["exclusion_scales"][ref])
    same("exclusion Coulomb scales", c_s[mine], box["exclusion_scales"][ref])
    same("bonds", np.asarray(system.bonds), box["bonds"][by_pair(box["bonds"])])

    def rows(table, *fields):
        valid = table.valid.cpu().numpy()
        return [getattr(table, f).cpu().numpy()[valid] for f in fields]

    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    b_atoms, b_len, b_k = rows(bonded.bonds, "atoms", "length", "k")
    bond_of = {tuple(ab): i for i, ab in enumerate(box["bonds"].tolist())}
    idx = np.array([bond_of[tuple(ab)] for ab in b_atoms.tolist()])
    same("bonds' r0", b_len, f32(box["bond_r0"])[idx])
    same("bonds' k", b_k, f32(box["bond_k"])[idx])
    a_atoms, a_t0, a_k = rows(bonded.angles, "atoms", "theta0", "k")
    same("angles", a_atoms, box["angles"])
    same("angles' theta0", a_t0, f32(box["angle_theta0"]))
    same("angles' k", a_k, f32(box["angle_k"]))
    if bonded.torsions is not None or bonded.impropers is not None:
        raise AssertionError("System vs tools/water.py: torsions where the box has none")


def _pad8(a: np.ndarray, fill) -> tuple:
    """`a` padded with `fill` rows to a multiple of 8, and its valid mask."""
    cap = -(-len(a) // 8) * 8
    pad = np.full((cap - len(a),) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad]), np.arange(cap) < len(a)


def bonded_system(box: dict, device):
    """The box's bonds and angles as a port `BondedSystem` on `device`."""
    import torch

    from emdee_tpu_torch.potentials.bonded import AngleTable, BondedSystem, BondTable

    n = len(box["masses"])
    t = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(device)  # noqa: E731
    b_atoms, b_valid = _pad8(box["bonds"].astype(np.int64), n)
    a_atoms, a_valid = _pad8(box["angles"].astype(np.int64), n)
    nb, na = len(b_atoms), len(a_atoms)
    fill = lambda v, size, count: np.concatenate([v, np.zeros(size - count)])  # noqa: E731
    return BondedSystem(
        bonds=BondTable(atoms=t(b_atoms, np.int64), length=t(fill(box["bond_r0"], nb, len(box["bonds"])), np.float32),
                        k=t(fill(box["bond_k"], nb, len(box["bonds"])), np.float32), valid=t(b_valid, np.bool_)),
        angles=AngleTable(atoms=t(a_atoms, np.int64),
                          theta0=t(fill(box["angle_theta0"], na, len(box["angles"])), np.float32),
                          k=t(fill(box["angle_k"], na, len(box["angles"])), np.float32), valid=t(a_valid, np.bool_)),
        torsions=None, impropers=None,
    )


def water_setup(device, n_side: int = N_SIDE, seed: int = SEED, spill: bool = True):
    """(box arrays, config, LJ model, DSF model, atom-order LJParams) of the
    water box; `spill` picks the spill geometry (bench_all.py's) or the
    plain one, whose capacity is then raised to the start's largest cell
    occupancy (rounded up to 8), as the reference's `dense_sim_from_system`
    does for a constructed start."""
    from emdee_tpu_torch import LennardJonesModel, lennard_jones_atom, suggest_cell_dense_config
    from emdee_tpu_torch.potentials.coulomb import KJMOL_ANGSTROM, DSFCoulomb

    box = water_box(n_side, seed)
    n = len(box["masses"])
    if spill:
        config = suggest_cell_dense_config(n, box["box"], cutoff=CUTOFF, switch=SWITCH, skin=SKIN, spill=True)
    else:
        config = plain_config(box)
    model = LennardJonesModel.create(CUTOFF, SWITCH, device=device)
    coulomb = DSFCoulomb.create(CUTOFF, ALPHA, KJMOL_ANGSTROM, device=device)
    params = lennard_jones_atom(box["epsilon"], box["sigma"], device=device)
    return box, config, model, coulomb, params


def plain_config(box: dict):
    """The box's plain geometry (no spill), its capacity raised to the
    start's largest cell occupancy, rounded up to 8, as the reference's
    `dense_sim_from_system` does for a constructed start."""
    from emdee_tpu_torch import suggest_cell_dense_config

    config = suggest_cell_dense_config(len(box["masses"]), box["box"], cutoff=CUTOFF, switch=SWITCH, skin=SKIN)
    return config._replace(capacity=max(config.capacity, start_capacity(box["positions"], config)))


def occupancy(positions, config) -> np.ndarray:
    """The atom count of every cell of `config`'s grid, each atom binned in
    its true cell."""
    m = config.cells_per_dim
    s = positions / config.box - np.floor(positions / config.box)
    v = np.clip(np.floor(m * s).astype(np.int64), 0, m - 1)
    return np.bincount(v[:, 0] + m * (v[:, 1] + m * v[:, 2]), minlength=m**3)


def start_capacity(positions, config) -> int:
    """The largest cell occupancy of `positions` binned on `config`'s grid,
    rounded up to a multiple of 8."""
    return -(-int(occupancy(positions, config).max()) // 8) * 8


def molecular_sim(box: dict, config, model, coulomb, params, backend: str = "auto", device=None, thermostat=None):
    """`make_molecular_dense_sim` on the box: (rollout, energy).  On the
    card 'auto' resolves to the streaming family (K5c) at both boxes' plain
    configs and to the resident one (K2c) at the spill config."""
    from emdee_tpu_torch.neighbors.cell_dense_molecular import make_molecular_dense_sim

    return make_molecular_dense_sim(
        config, model, DT, len(box["masses"]), params=params, charges=box["charges"], coulomb=coulomb,
        exclusion_pairs=box["exclusion_pairs"], exclusion_scales=box["exclusion_scales"],
        bonded=bonded_system(box, device), backend=backend, thermostat=thermostat,
    )


def csvr():
    """The equilibration thermostat: CSVR at 300 K, τ = 10 fs."""
    from emdee_tpu_torch import CSVRConfig

    return CSVRConfig(TEMPERATURE, tau=TAU, kB=KB)


def main(chunks: int = 8) -> None:
    import time

    import torch

    from emdee_tpu_torch import cell_dense_init, gather_dense_atoms

    dev = torch.device("cuda")
    box, spill_cfg, model, coul, params = water_setup(dev, spill=True)
    _, plain_cfg, *_ = water_setup(dev, spill=False)
    n = len(box["masses"])
    init = lambda pos, vel, cfg: cell_dense_init(pos, vel, box["masses"], params, cfg,  # noqa: E731
                                                 charges=box["charges"], device=dev)
    roll_s, _ = molecular_sim(box, spill_cfg, model, coul, params, "auto", dev)
    for arm, thermostat in (("CSVR 300 K", csvr()), ("NVE", None)):
        roll, energy = molecular_sim(box, plain_cfg, model, coul, params, "auto", dev, thermostat)
        rng = torch.Generator(device=dev).manual_seed(1)
        st = init(box["positions"], box["velocities"], plain_cfg)
        for chunk in range(1, chunks + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = roll(st, EQ_STEPS, REBIN_EVERY, rng=rng)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / EQ_STEPS
            pe, _, ke = (float(x) for x in energy(st))
            pos, vel = gather_dense_atoms(st, n)
            occ = occupancy(pos, spill_cfg)
            ss = init(pos, vel, spill_cfg)
            note = "overflows"
            if not bool(ss.overflow):
                blocks = 0
                while blocks < 100 and not bool(ss.overflow):
                    ss, blocks = roll_s(ss, num_steps=REBIN_EVERY, rebin_every=REBIN_EVERY), blocks + 1
                note = f"holds; {'flag after' if bool(ss.overflow) else 'no flag in'} {blocks} rebin blocks"
            print(f"{arm}, {chunk * EQ_STEPS} steps ({chunk * EQ_STEPS * DT * 100:.0f} fs): {ms:.4f} ms/step, "
                  f"T {2.0 * ke / ((3 * n - 3) * KB):.1f} K, PE {pe:.1f} kJ/mol, flag {bool(st.overflow)}; "
                  f"spill config M={spill_cfg.cells_per_dim} C={spill_cfg.capacity}: true-cell occupancy mean "
                  f"{occ.mean():.2f}, sd {occ.std():.2f}, max {occ.max()}; its init {note}", flush=True)


if __name__ == "__main__":
    import sys

    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
