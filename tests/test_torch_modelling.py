"""The port's modelling layer (`emdee_tpu_torch.modelling`, `native/canon`)
and `dense_sim_from_system` against the JAX package's, on the CPU.

- `canonical_form`, native and Python, against the reference's on seeded
  random coloured graphs (canonical adjacency and order equal), and the
  cases of tests/test_modelling.py:40-128 on both of the port's paths.
- `bonded_paths` and `exclusion_table` against the reference (butane, a
  ring, padding).
- The copied C++ sources and alias table are byte for byte the
  reference's.
- `ForceField`, `System` and `build_bonded_system` on the port's fixture
  (`emdee_tpu_torch/data/tip3p_flexible.xml`) and an 8³-water PDB (1,536
  atoms, box 24.88 Å) written by `tools/water.py`: every table equal to the
  reference's (LJ parameters bit for bit), and equal to `tools/water.py`'s
  hand-built box (`water.check_system`).
- `dense_sim_from_system` on that box, the port on the CPU (plain) against
  the reference's `backend="xla"`: the config and the initial state bit for
  bit, the first forces within 2e-4 of the force scale
  (tests/test_torch_molecular.py's gate), `energy(state)`: the potential
  within 3e-4 relative and the virial within 5e-3 (tests/
  test_cell_dense_molecular.py:125,284, the dense engine against another
  summation order in kJ/mol; per-slot energies agree to ~1.5e-6 of their
  size, the totals of the box's large, cancelling Coulomb terms to
  ~5e-5), the kinetic energy within 1e-6; a short `run_dense_simulation`
  on each side with the same velocities, positions and velocities
  compared as tests/test_torch_molecular.py:224-240 compares rollouts.
- `build_solvated_polyalanine`'s PDB text byte for byte the reference's."""

import jax
import numpy as np
import pytest
import torch

import emdee_tpu.modelling.graphs as jgraphs
from emdee_tpu.modelling.bonded import build_bonded_system as jbuild_bonded
from emdee_tpu.modelling.forcefield import ForceField as JForceField
from emdee_tpu.modelling.solvate import build_solvated_polyalanine as jsolvate
from emdee_tpu.modelling.system import System as JSystem
from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.neighbors import cell_dense_molecular as jmol
from emdee_tpu.potentials import bonded as jb
from emdee_tpu.potentials.coulomb import KJMOL_ANGSTROM, DSFCoulomb
from emdee_tpu.potentials.lennard_jones import LennardJonesModel as JModel
from emdee_tpu.utils.runner import RunnerConfig as JRunnerConfig
from emdee_tpu.utils.runner import run_dense_simulation as jrun
import emdee_tpu_torch.modelling.graphs as tgraphs
from emdee_tpu_torch.modelling.bonded import build_bonded_system
from emdee_tpu_torch.modelling.forcefield import ForceField, sanitized
from emdee_tpu_torch.modelling.solvate import build_solvated_polyalanine
from emdee_tpu_torch.modelling.system import System
from emdee_tpu_torch.native import canon
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.neighbors import cell_dense_molecular as tmol
from emdee_tpu_torch.potentials import bonded as tb
from emdee_tpu_torch.potentials.coulomb import coulomb_from_numpy
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel as TModel
from emdee_tpu_torch.tools import water
from emdee_tpu_torch.utils.runner import RunnerConfig, run_dense_simulation
from torch_port_utils import assert_states_bitequal, bits

torch.set_num_threads(2)

PORT = water.FORCE_FIELD.parent.parent
REF = PORT.parent / "emdee_tpu"
FORCE_GATE = 2e-4  # of the force scale: tests/test_torch_molecular.py's gate
PE_REL, VIR_REL = 3e-4, 5e-3  # tests/test_cell_dense_molecular.py:125,284


# ---------------------------------------------------------------------------
# canonical_form, native and Python
# ---------------------------------------------------------------------------


def _random_graph(n, p, rng):
    adj = np.triu(rng.random((n, n)) < p, 1)
    return adj | adj.T


@pytest.fixture(params=["native", "python"])
def path(request, monkeypatch):
    """Run the test on the port's native path, or with the native shortcut
    cut off (the Python spec), on both packages alike."""
    if request.param == "native":
        if not canon.available():
            pytest.skip("native library unavailable")
    else:
        monkeypatch.setattr(tgraphs, "_native_canonical_form", lambda *a: None)
        monkeypatch.setattr(jgraphs, "_native_canonical_form", lambda *a: None)
    return request.param


def test_canonical_form_matches_reference(path):
    """On 25 seeded random coloured graphs (2–20 vertices, automorphism-rich
    ones among them): the port's canonical order and adjacency equal the
    reference's on the same path, and the native adjacency equals the
    Python one."""
    rng = np.random.default_rng(7)
    for _ in range(25):
        n = int(rng.integers(2, 20))
        adj = _random_graph(n, 0.3, rng)
        colors = rng.choice([1.008, 12.011, 15.999], size=n)
        order, canon_adj = tgraphs.canonical_form(adj, colors)
        j_order, j_adj = jgraphs.canonical_form(adj, colors)
        np.testing.assert_array_equal(order, j_order)
        np.testing.assert_array_equal(canon_adj, j_adj)
        np.testing.assert_array_equal(adj[np.ix_(order, order)], canon_adj)
        if path == "native":
            native_order, native_adj = canon.canonical_form(adj, tgraphs.color_classes(colors))
            np.testing.assert_array_equal(native_adj, canon_adj)
            np.testing.assert_array_equal(native_order, order)


def test_native_adjacency_equals_python():
    """The native canonical adjacency equals the pure-Python one on the
    same graphs (orders may differ within automorphisms)."""
    if not canon.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(11)
    for _ in range(25):
        n = int(rng.integers(2, 20))
        adj = _random_graph(n, 0.3, rng)
        colors = rng.choice([1.008, 12.011, 15.999], size=n)
        native_order, native_adj = canon.canonical_form(adj, tgraphs.color_classes(colors))
        orig = tgraphs._native_canonical_form
        tgraphs._native_canonical_form = lambda *a: None
        try:
            _, py_adj = tgraphs.canonical_form(adj, colors)
        finally:
            tgraphs._native_canonical_form = orig
        np.testing.assert_array_equal(native_adj, py_adj)
        np.testing.assert_array_equal(adj[np.ix_(native_order, native_order)], native_adj)


def _permute(adj, colors, perm):
    return adj[np.ix_(perm, perm)], [colors[i] for i in perm]


def test_canonical_invariant_under_relabeling(path):
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(3, 24))
        adj = _random_graph(n, 0.3, rng)
        colors = rng.choice([1.008, 12.011, 15.999], size=n)
        _, canon1 = tgraphs.canonical_form(adj, colors)
        _, canon2 = tgraphs.canonical_form(*_permute(adj, colors, rng.permutation(n)))
        np.testing.assert_array_equal(canon1, canon2)


def test_canonical_distinguishes_colors(path):
    adj = np.array([[0, 1, 0], [1, 0, 1], [0, 1, 0]], bool)
    _, hoh = tgraphs.canonical_form(adj, [1.008, 15.999, 1.008])
    _, ohh = tgraphs.canonical_form(adj, [15.999, 1.008, 1.008])
    assert not np.array_equal(hoh, ohh)


def test_canonical_order_consistency(path):
    rng = np.random.default_rng(1)
    adj = _random_graph(12, 0.35, rng)
    colors = rng.choice([1.0, 12.0, 16.0], size=12)
    order, canon_adj = tgraphs.canonical_form(adj, colors)
    np.testing.assert_array_equal(canon_adj, adj[np.ix_(order, order)])
    perm = rng.permutation(12)
    order2, _ = tgraphs.canonical_form(*_permute(adj, colors, perm))
    np.testing.assert_array_equal(np.asarray(perm)[order2], order)


def test_color_binning_atol():
    classes = tgraphs.color_classes([1.008, 1.0079, 12.011, 12.01, 16.0], atol=0.1)
    assert classes[0] == classes[1] and classes[2] == classes[3]
    assert len(set(classes.tolist())) == 3
    np.testing.assert_array_equal(classes, jgraphs.color_classes([1.008, 1.0079, 12.011, 12.01, 16.0], atol=0.1))


def test_automorphic_graph(path):
    n = 6
    adj = np.zeros((n, n), bool)
    for i in range(n):
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = True
    _, canon_adj = tgraphs.canonical_form(adj, [12.011] * n)
    assert canon_adj.sum() == 12
    perm = np.roll(np.arange(n), 2)
    _, canon2 = tgraphs.canonical_form(adj[np.ix_(perm, perm)], [12.011] * n)
    np.testing.assert_array_equal(canon_adj, canon2)


def test_sanitized():
    assert sanitized("C1'-*") == "C1p_a"


# ---------------------------------------------------------------------------
# exclusions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["butane", "ring", "padded"])
def test_bonded_paths_and_exclusions_match_reference(case):
    """tests/test_modelling.py:110-137's cases: butane's 1-2/1-3/1-4 pairs,
    cyclobutane's shortest path winning, and the padded exclusion table
    with its 1-4 scale, each equal to the reference's."""
    bonds = {"butane": [(0, 1), (1, 2), (2, 3)], "ring": [(0, 1), (1, 2), (2, 3), (3, 0)],
             "padded": [(0, 1), (1, 2), (2, 3)]}[case]
    for got, want in zip(tgraphs.bonded_paths(4, bonds), jgraphs.bonded_paths(4, bonds)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    pad = 8 if case == "padded" else None
    for got, want in zip(tgraphs.exclusion_table(4, bonds, 0.5, pad_to=pad),
                         jgraphs.exclusion_table(4, bonds, 0.5, pad_to=pad)):
        np.testing.assert_array_equal(got, want)
    p12, p13, p14 = tgraphs.bonded_paths(4, bonds)
    if case == "butane":
        assert p12.tolist() == [[0, 1], [1, 2], [2, 3]] and p13.tolist() == [[0, 2], [1, 3]]
        assert p14.tolist() == [[0, 3]]
    elif case == "ring":
        assert len(p12) == 4 and sorted(map(tuple, p13.tolist())) == [(0, 2), (1, 3)] and len(p14) == 0
    else:
        pairs, scales = tgraphs.exclusion_table(4, bonds, lj14_scale=0.5, pad_to=8)
        assert scales[:5].tolist() == [0] * 5 and scales[5] == 0.5
        assert (pairs[6:] == 4).all() and (scales[6:] == 1.0).all()
    with pytest.raises(ValueError, match="pad_to"):
        tgraphs.exclusion_table(4, bonds, pad_to=2)


@pytest.mark.parametrize("name", ["native/canon.cpp", "native/chemio.cpp", "data/pdb_aliases.json"])
def test_copied_files_are_the_references(name):
    assert (PORT / name).read_bytes() == (REF / name).read_bytes()


# ---------------------------------------------------------------------------
# ForceField, System, bonded tables on the fixture
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def water8(tmp_path_factory):
    """The 8³-water box, its PDB, and the System of each package on it."""
    box = water.water_box(8)
    pdb = tmp_path_factory.mktemp("water8") / "water8.pdb"
    water.write_box_pdb(pdb, box)
    ff = str(water.FORCE_FIELD)
    return {"box": box, "pdb": str(pdb), "port": System(str(pdb), ForceField(ff)),
            "ref": JSystem(str(pdb), JForceField(ff))}


def test_forcefield_matches_reference():
    port, ref = ForceField(str(water.FORCE_FIELD)), JForceField(str(water.FORCE_FIELD))
    assert port.atom_types == ref.atom_types and port.nonbonded == ref.nonbonded
    assert port.bond_types == ref.bond_types and port.angle_types == ref.angle_types
    assert port.dihedral_types == ref.dihedral_types == [] and port.improper_types == ref.improper_types == []
    assert (port.lj14_scale, port.coulomb14_scale) == (ref.lj14_scale, ref.coulomb14_scale) == (0.5, 0.833333)
    assert list(port.templates) == list(ref.templates) == ["HOH"]
    tp, tr = port.templates["HOH"], ref.templates["HOH"]
    assert [(a.name, a.type, a.charge) for a in tp.atoms] == [(a.name, a.type, a.charge) for a in tr.atoms]
    np.testing.assert_array_equal(tp.adjacency, tr.adjacency)
    assert tp.canonical_masses == tr.canonical_masses
    assert port._template_index == ref._template_index


def test_system_matches_reference(water8):
    """Names, residues, spans, positions, masses, bonds, ff types and
    charges; `lj_params(10)` bit for bit; `exclusions(coulomb=True)`."""
    port, ref = water8["port"], water8["ref"]
    assert len(port) == len(ref) == 1536 and port.count_residues() == ref.count_residues() == 512
    for name in ("names", "resnames", "residue_spans", "bonds", "ff_types"):
        assert getattr(port, name) == getattr(ref, name), name
    for name in ("positions", "velocities", "masses", "charges", "box_lengths"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    got, want = port.lj_params(10.0, device="cpu"), jax.device_get(ref.lj_params(10.0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g.numpy()), bits(w))
    for g, w in zip(port.exclusions(coulomb=True), ref.exclusions(coulomb=True)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_bonded_tables_match_reference(water8):
    """Every `build_bonded_system` table at length_scale 10 equals the
    reference's (atom ids as int64 there int32, the rest bit for bit), on
    the CPU as asked."""
    got = build_bonded_system(water8["port"], length_scale=10.0, device="cpu")
    want = jax.device_get(jbuild_bonded(water8["ref"], length_scale=10.0))
    assert got.torsions is None and want.torsions is None and got.impropers is None and want.impropers is None
    for family in ("bonds", "angles"):
        g, w = getattr(got, family), getattr(want, family)
        for field in g._fields:
            a = getattr(g, field)
            assert a.device.type == "cpu"
            np.testing.assert_array_equal(bits(a.numpy()), bits(np.asarray(getattr(w, field)).astype(a.numpy().dtype)),
                                          err_msg=f"{family}.{field}")


def test_system_matches_the_hand_built_box(water8):
    """The System's tables equal `tools/water.py`'s hand-built ones: types
    (as LJ after the unit change), charges, exclusion pairs and scales,
    bonds and angles; masses per pdb_aliases.json (O 15.999)."""
    water.check_system(water8["port"], build_bonded_system(water8["port"], length_scale=10.0, device="cpu"),
                       water8["box"])
    with pytest.raises(AssertionError, match="charges"):
        water.check_system(water8["port"], None, {**water8["box"], "charges": -water8["box"]["charges"]})


def test_system_entry_points_default_to_the_card(water8):
    """With no device named, the System's bridge, the bonded tables and
    `dense_sim_from_system` build on the CUDA card; with no card they raise
    rather than return CPU tensors."""
    system = water8["port"]
    calls = [
        lambda: system.make_state().positions,
        lambda: system.lj_params(10.0).half_sigma,
        lambda: build_bonded_system(system, length_scale=10.0).bonds.atoms,
        lambda: tmol.dense_sim_from_system(system, **SIM_KW)[0].positions,
    ]
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


# ---------------------------------------------------------------------------
# dense_sim_from_system
# ---------------------------------------------------------------------------

SIM_KW = dict(cutoff=7.0, switch=6.0, skin=1.0, dt=5e-4, coulomb_alpha=0.2, length_scale=10.0)
CHUNK, CHUNKS, REBIN = 6, 2, 3


@pytest.fixture(scope="module")
def sims(water8):
    vel = water8["box"]["velocities"]
    port = tmol.dense_sim_from_system(water8["port"], **SIM_KW, velocities=vel, device="cpu")
    ref = jmol.dense_sim_from_system(water8["ref"], **SIM_KW, velocities=vel, backend="xla")
    return port, ref


def test_dense_sim_from_system_config_state_energy(sims):
    """The config (M = 3, the capacity raised to the start's occupancy) and
    the initial slot state bit for bit; `energy(state)`: PE within 3e-4
    relative, the virial within 5e-3, KE within 1e-6 (module docstring)."""
    (ts, _, tenergy, tcfg), (js, _, jenergy, jcfg) = sims
    assert tcfg == jcfg and tcfg.cells_per_dim == 3
    assert_states_bitequal(js, ts)
    assert ts.charges is not None and ts.positions.device.type == "cpu"
    pe_t, vir_t, ke_t = (float(x) for x in tenergy(ts))
    pe_j, vir_j, ke_j = (float(x) for x in jenergy(js))
    assert pe_t == pytest.approx(pe_j, rel=PE_REL)
    assert ke_t == pytest.approx(ke_j, rel=1e-6)
    assert vir_t == pytest.approx(vir_j, rel=VIR_REL, abs=50.0)


def test_dense_sim_from_system_first_forces(sims, water8):
    """The first forces — the pair pass with the System's exclusion tags
    plus its bonded terms, in atom order — within 2e-4 of the force scale
    of the reference's."""
    (ts, _, _, cfg), (js, _, _, _) = sims
    n = len(water8["port"])
    pairs, ljs, cs = water8["port"].exclusions(coulomb=True)
    tabs = jmol.build_exclusion_tables(n, pairs, ljs, cs)
    aux = jmol.make_exclusion_aux_fn(n, *tabs)(js)
    jcoul = DSFCoulomb.create(7.0, 0.2, KJMOL_ANGSTROM)
    fj = np.asarray(jcd.cell_dense_forces(js, JModel.create(7.0, 6.0), cfg, jcoul, excl=aux)[0])
    fj = _by_atom(np.asarray(js.atom_id), np.asarray(js.valid), fj, n)
    pos_j, _ = jcd.gather_dense_atoms(js, n)
    fj += np.asarray(jb.bonded_forces_analytic(pos_j, cfg.box, jbuild_bonded(water8["ref"], length_scale=10.0)))
    tmodel = TModel.create(7.0, 6.0, device="cpu")
    tcoul = coulomb_from_numpy(jax.device_get(jcoul), "cpu")
    ttabs = tmol.build_exclusion_tables(n, pairs, ljs, cs)
    ft = tcd.cell_dense_forces(ts, tmodel, cfg, tcoul, tmol.make_exclusion_aux_fn(n, *ttabs)(ts))[0].numpy()
    ft = _by_atom(ts.atom_id.numpy(), ts.valid.numpy(), ft, n)
    pos_t, _ = tcd.gather_dense_atoms(ts, n)
    bonded = build_bonded_system(water8["port"], length_scale=10.0, device="cpu")
    ft += tb.bonded_forces_analytic(torch.from_numpy(pos_t), torch.tensor(cfg.box, dtype=torch.float32),
                                    bonded).numpy()
    scale = np.abs(fj).max()
    assert scale > 100.0
    assert np.abs(ft - fj).max() <= FORCE_GATE * scale


def _by_atom(atom_id, valid, per_slot, n):
    out = np.zeros((n,) + per_slot.shape[2:], per_slot.dtype)
    out[atom_id[valid]] = per_slot[valid]
    return out


def test_run_dense_simulation_matches_reference(sims, water8, tmp_path):
    """`run_dense_simulation`, 2 chunks of 6 steps at rebin every 3, with
    trajectory dumps, on each side from the same state: positions and
    velocities within 2e-4 (tests/test_torch_molecular.py:224-240), each
    chunk's energies within the tolerances of the first energies, the
    frames within 2e-4; a checkpoint of the port's run loads back."""
    (ts, troll, tenergy, _), (js, jroll, jenergy, _) = sims
    n = len(water8["port"])
    runs = {}
    for side, (run, cfg_cls, st, roll, energy) in {
        "port": (run_dense_simulation, RunnerConfig, ts, troll, tenergy),
        "ref": (jrun, JRunnerConfig, js, jroll, jenergy),
    }.items():
        traj = tmp_path / f"{side}.xyz"
        cfg = cfg_cls(total_steps=CHUNK * CHUNKS, chunk_steps=CHUNK, trajectory_path=str(traj), log=False,
                      checkpoint_path=str(tmp_path / side) if side == "port" else None)
        runs[side] = run(st, roll, energy, cfg, n, names=water8["port"].names, rebin_every=REBIN) + (traj,)
    (tf, th, ttraj), (jf, jh, jtraj) = runs["port"], runs["ref"]
    assert int(tf.step) == int(jf.step) == CHUNK * CHUNKS and len(th) == len(jh) == CHUNKS
    pt, vt = tcd.gather_dense_atoms(tf, n)
    pj, vj = jcd.gather_dense_atoms(jf, n)
    assert np.abs(pt - pj).max() <= 2e-4 and np.abs(vt - vj).max() <= 2e-4
    for a, b in zip(th, jh):
        assert a["step"] == b["step"]
        assert a["kinetic"] == pytest.approx(b["kinetic"], rel=1e-6)
        for key in ("potential", "total"):
            assert a[key] == pytest.approx(b[key], rel=PE_REL), key
        assert a["virial"] == pytest.approx(b["virial"], rel=VIR_REL, abs=50.0)
    from emdee_tpu.io.xyz import read_xyz

    lines = ttraj.read_text().splitlines()
    assert lines.count(str(n)) == CHUNKS and len(lines) == CHUNKS * (n + 2)
    assert lines[1] == "step 6" and lines[n + 3] == "step 12"
    names, first, _ = read_xyz(str(ttraj))
    assert names == water8["port"].names
    assert np.abs(first - read_xyz(str(jtraj))[1]).max() <= 2e-4
    from emdee_tpu_torch.utils.checkpoint import load_state

    restored, meta = load_state(str(tmp_path / "port"), tf)
    assert meta["step"] == CHUNK * CHUNKS and torch.equal(restored.positions, tf.positions)


# ---------------------------------------------------------------------------
# solvate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_res,box,seed", [(1, 14.0, 0), (3, 20.0, 1), (6, 28.0, 2)])
def test_solvated_polyalanine_text_is_the_references(n_res, box, seed):
    got = build_solvated_polyalanine(n_res=n_res, box=box, seed=seed)
    want = jsolvate(n_res=n_res, box=box, seed=seed)
    assert got == want
    assert got[1] == 10 * n_res + 3 and got[2] > 0
