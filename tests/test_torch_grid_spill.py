"""Spill configs on the port's grid-sharded engine (the spill pass K7-G on
the CPU: its plain version `rebin_window_kernel.spill_halo_plain`) against
the JAX package's grid engine on `backend="xla"` (8 virtual CPU devices,
tests/conftest.py), whose per-shard rebin runs the XLA spill pass
`_route_axis_pass` with `spill_eps`.

The rebin's fixture is tests/test_cell_dense.py's spill lattice (1,728
atoms, M = 4, C = 32) squeezed toward 26 atoms a cell, the runs' the
random fluid of tests/test_torch_spill.py (1,500 atoms, M = 4) squeezed
toward 24; the port starts from the JAX init (`to_port`), so the two
packages' seam-spill storage at init does not separate them.  One rebin (a one-step rollout at dt = 0) of a drifted
state is bit for bit JAX's on (1,1,1), (2,2,2) and (2,2,1), with spills and
hold-backs firing across shard faces and the periodic seam, and its flag is
JAX's where the drift overfills a cell; on one shard the plain pass's three
passes equal the one-card spill route's plain version (K7's,
`compact_kernel.spill_route_plain`), and on every shape the one-launch
form's plain version (`spill_grid_rebin_plain`, over the shard layout's
row permutation `grid_cells`) equals the three passes in every slot and
the flag, drifted and with the y pass overflowing; a 60-step NVE rollout holds JAX's at
tests/test_cell_dense.py:333-335's tolerances (positions 2e-5, velocities
2e-4, equal atom ids), and the decompositions are bitwise equal among
themselves; CSVR on shared draws, the charged fixture (DSF + exclusion
tags), `reconfigure_grid_state` and a two-rank gloo `DistMesh` run on spill
configs as on plain ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.distributed import grid_sharded as jgs
from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.neighbors import cell_dense_molecular as jmol
from emdee_tpu.potentials.coulomb import DSFCoulomb as JCoulomb
from emdee_tpu.potentials.lennard_jones import LennardJonesModel as JModel
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom as jlj
from emdee_tpu_torch import BerendsenBarostatConfig, CSVRConfig, LangevinConfig, LennardJonesModel
from emdee_tpu_torch.distributed import dryrun
from emdee_tpu_torch.distributed import grid_sharded as gs
from emdee_tpu_torch.distributed.mesh import LocalMesh, make_grid_mesh
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.neighbors import compact_kernel, rebin_window_kernel
from emdee_tpu_torch.tools import fixtures
from emdee_tpu.utils.lattice import maxwell_boltzmann
from torch_port_utils import bits, random_fluid, spill_lattice_setup, to_port

torch.set_num_threads(2)
SHAPES = [(1, 1, 1), (2, 2, 2), (2, 2, 1)]
MODEL = LennardJonesModel.create(2.5, 2.0, device="cpu")


def _spill_lattice():
    """(JAX init state, config, JAX model, n): the spill lattice at target 26."""
    pos, vel, params, config, jmodel = spill_lattice_setup()
    config = config._replace(spill_target=26)
    n = len(pos)
    st = jcd.cell_dense_init(pos, vel, np.ones(n), params, config)
    assert not bool(st.overflow)
    return st, config, jmodel, n


def _spill_fixture():
    """(JAX init state, config, JAX model, n): tests/test_torch_spill.py's
    random fluid (1,500 atoms at ρ = 0.75, 0.85σ apart at least) on its
    spill config (M = 4, C = 32) squeezed toward 24 atoms a cell, so that
    every rebin spills and holds back atoms (the lattice's cells all hold
    27, which leaves no room to spill into)."""
    pos, box = random_fluid(1500, 0.75, 0.85, 0)
    n = len(pos)
    config = jcd.suggest_cell_dense_config(n, box, 2.5, 2.0, 0.3, spill=True)._replace(spill_target=24)
    st = jcd.cell_dense_init(pos, maxwell_boltzmann(n, 1.0, seed=1), np.ones(n), jlj(np.ones(n), np.ones(n)), config)
    assert not bool(st.overflow) and config.cells_per_dim == 4
    return st, config, JModel.create(2.5, 2.0), n


def _held(state, config):
    """Atoms stored one cell above their true cells along some axis (a
    state compared with itself counts each such atom as a hold)."""
    end = tcd.state_to_numpy(state)
    return fixtures.spill_census(end, end, config)["holds"]


def _drifted(st, amp):
    """Every atom moved by a uniform draw in [−amp, amp] per axis (seed 3),
    unwrapped, as a rebin finds a block's end state: at 0.7 spills and
    hold-backs fire in every axis without overfilling a cell, at 0.9 a
    cell overfills."""
    d = np.random.default_rng(3).uniform(-amp, amp, np.asarray(st.positions).shape).astype(np.float32)
    return st._replace(positions=jnp.where(st.valid[..., None], st.positions + d, 0.0))


def _port_run(st, config, shape, steps, rebin_every, dt=0.002, **kw):
    mesh = make_grid_mesh(shape, device="cpu")
    rollout, energy = gs.make_grid_sharded_sim(config, MODEL, dt, mesh, **kw)
    out = rollout(gs.distribute_grid(st, config, mesh), num_steps=steps, rebin_every=rebin_every)
    return out, gs.gather_grid_state(out, config, mesh), energy


@pytest.fixture(scope="module")
def rebins():
    """The drifted states (amp 0.7 and 0.9) and JAX's grid rebin of each on
    (2,2,2): a one-step rollout at dt = 0, which leaves the rebinned state
    as it is."""
    st, config, jmodel, n = _spill_lattice()
    jmesh = jgs.make_grid_mesh((2, 2, 2))
    jroll, _ = jgs.make_grid_sharded_sim(config, jmodel, 0.0, jmesh, backend="xla")
    out = {}
    for amp in (0.7, 0.9):
        drifted = _drifted(st, amp)
        out[amp] = drifted, jax.device_get(jroll(jgs.distribute_grid(drifted, config, jmesh), num_steps=1,
                                                 rebin_every=1))
    return config, out


@pytest.mark.parametrize("shape", SHAPES)
def test_spill_rebin_matches_jax(rebins, shape):
    config, runs = rebins
    drifted, ref = runs[0.7]
    _, whole, _ = _port_run(to_port(drifted), config, shape, 1, 1, dt=0.0)
    got = tcd.state_to_numpy(gs._grid_leaves(whole, config))
    want = ref._asdict()
    assert not bool(ref.overflow)
    for name in got:
        np.testing.assert_array_equal(bits(got[name]), bits(want[name]), err_msg=name)
    census = fixtures.spill_census(tcd.state_to_numpy(to_port(drifted)), tcd.state_to_numpy(whole), config, shape)
    assert census["spills"] > 20 and census["holds"] > 0 and census["seam"] > 0, census
    if shape != (1, 1, 1):
        assert census["faces"] > 0, census


def test_spill_rebin_flag_matches_jax(rebins):
    config, runs = rebins
    drifted, ref = runs[0.9]
    out, _, _ = _port_run(to_port(drifted), config, (2, 2, 2), 1, 1, dt=0.0)
    assert bool(ref.overflow) and bool(out.overflow)


@pytest.mark.parametrize("amp", [0.7, 0.9])
def test_spill_halo_plain_equals_spill_route_plain(rebins, amp):
    """On one shard (no halo planes: the far layers are the shard's own),
    three `spill_halo_plain` passes on the raw fields — strided position
    and velocity views, parked and wrapped by the first pass — against
    `compact_kernel.spill_route_plain` on the same slots: the live slots
    bit for bit, every slot of every field but the positions (whose fill
    differs: the sentinel against 0), and the flag."""
    config, runs = rebins
    st = to_port(runs[amp][0])
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    spill = tcd._spill_params(config)
    mesh = LocalMesh((1, 1, 1), "cpu")
    sh = gs.distribute_grid(st, config, mesh)
    p3, v3 = sh.positions.movedim(-1, 0), sh.velocities.movedim(-1, 0)
    x = [p3[i] for i in range(3)] + [v3[i] for i in range(3)] + [sh.inv_masses, torch.where(sh.valid, sh.atom_id, ns)]
    flag = None
    for axis in range(3):
        lo, hi = rebin_window_kernel.halo_planes(x, mesh, axis, depth=2)
        assert lo is None and hi is None
        b = rebin_window_kernel.global_coords(mesh, (m, m, m), axis)
        x, flag = rebin_window_kernel.spill_halo_pass(x, lo, hi, b, config.box, axis, m, c, ns, spill, raw=axis == 0,
                                                      flag=flag)
    fields = ([st.positions[..., i] for i in range(3)] + [st.velocities[..., i] for i in range(3)]
              + [st.inv_masses, torch.where(st.valid, st.atom_id, ns)])
    ref, valid, ovf = compact_kernel.spill_route_plain(fields, config.box, m, c, ns, spill, st.valid)
    got = x.reshape(len(fields), m**3, c)
    assert bool(flag) == bool(ovf) == (amp == 0.9)
    assert torch.equal(got[-1] < ns, valid)
    for i, r in enumerate(ref):
        r = r.view(torch.int32)
        mask = valid if i < 3 else torch.ones_like(valid)
        assert torch.equal(got[i][mask], r[mask]), f"field {i}"


def _grid_fields(sh, ns):
    """A grid-sharded state's fields as the grid's rebin reads them:
    positions and velocities (strided component views), 1/m, atom id (ns
    in empty slots)."""
    p3, v3 = sh.positions.movedim(-1, 0), sh.velocities.movedim(-1, 0)
    return [p3[i] for i in range(3)] + [v3[i] for i in range(3)] + [sh.inv_masses, torch.where(sh.valid, sh.atom_id, ns)]


def _crowded(st, config):
    """The state with every atom of the cells at y = 0 moved one cell up y:
    the y pass, between the other two, overflows."""
    m = config.cells_per_dim
    crowd = ((torch.arange(m**3) // m) % m == 0)[:, None] & st.valid
    pos = st.positions.clone()
    pos[..., 1] += torch.where(crowd, float(config.cell_side), 0.0)
    return st._replace(positions=pos)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", ["drifted", "crowded"])
def test_spill_grid_rebin_plain_equals_three_passes(rebins, case, shape):
    """The one-launch form's plain version (`spill_grid_rebin_plain`: the
    shards' rows gathered into the whole grid, K7's three plain passes
    there, K6's fill, the rows scattered back) against three
    `spill_halo_plain` passes over the halo planes, bit for bit in every
    slot of every field and in the flag, on the drifted state (amp 0.7)
    and on it crowded so that the y pass overflows; `spill_grid_rebin` on
    the CPU gives the three passes' result."""
    config, runs = rebins
    st = to_port(runs[0.7][0])
    if case == "crowded":
        st = _crowded(st, config)
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    spill = tcd._spill_params(config)
    mesh = LocalMesh(shape, "cpu")
    local = tuple(m // s for s in shape)
    fields = _grid_fields(gs.distribute_grid(st, config, mesh), ns)
    coords = [rebin_window_kernel.global_coords(mesh, local, axis) for axis in range(3)]
    x, raised = fields, []
    for axis in range(3):
        lo, hi = rebin_window_kernel.halo_planes(x, mesh, axis, depth=2)
        x, ovf = rebin_window_kernel.spill_halo_plain(x, lo, hi, coords[axis], config.box, axis, m, c, ns, spill,
                                                      raw=axis == 0)
        raised.append(bool(ovf))
    if case == "crowded":
        assert raised[:2] == [False, True]  # the y pass is the first to overflow
    else:
        assert not any(raised)
    got, ovf = rebin_window_kernel.spill_grid_rebin_plain(fields, config.box, m, c, ns, spill)
    assert got.dtype == torch.int32 and got.shape == x.shape
    assert torch.equal(got, x) and bool(ovf) == any(raised)
    routed, flag = rebin_window_kernel.spill_grid_rebin(fields, mesh, coords, config.box, m, c, ns, spill)
    assert torch.equal(routed, x) and bool(flag) == any(raised)
    moved = int((gs.gather_grid_state(gs.distribute_grid(st, config, mesh)._replace(atom_id=x[-1]), config,
                                      mesh).atom_id != st.atom_id).sum())
    assert moved > 50


@pytest.mark.parametrize("shape", SHAPES + [(2, 4, 1)])
def test_grid_cells_maps_rows_to_cells_and_back(shape):
    """`grid_cells`, the shard layout's row permutation (M = 8): a
    permutation of the M³ cells whose z, y, x coordinates are each row's
    `global_coords`, the order `distribute_grid` lays the cells out in, and
    gathering rows into cells by it and scattering them back is the
    identity."""
    m, c = 8, 3
    local = tuple(m // s for s in shape)
    mesh = LocalMesh(shape, "cpu")
    cells = rebin_window_kernel.grid_cells(shape, local)
    assert torch.equal(torch.sort(cells).values, torch.arange(m**3))
    for axis, coord in enumerate((cells // m**2, cells // m % m, cells % m)):
        assert torch.equal(coord, rebin_window_kernel.global_coords(mesh, local, axis).reshape(-1).long())
    config = tcd.CellDenseConfig(box=8.0, cells_per_dim=m, capacity=c, cutoff=0.5, switch=0.4, skin=0.1,
                                 num_atoms=m**3 * c)
    ids = torch.arange(m**3 * c, dtype=torch.int32).reshape(m**3, c)
    st = tcd.CellDenseState(*(None,) * len(tcd.CellDenseState._fields))._replace(atom_id=ids)
    laid = gs.distribute_grid(st, config, mesh).atom_id.reshape(-1, c)
    assert torch.equal(laid, ids[cells])
    rows = torch.randn(m**3, c)
    assert torch.equal(rows[torch.argsort(cells)][cells], rows)


@pytest.fixture(scope="module")
def rollouts():
    """60-step NVE spill runs (dt 0.002, rebin every 5): JAX's grid on
    (2,2,2) and the port's on every shape."""
    st, config, jmodel, n = _spill_fixture()
    jmesh = jgs.make_grid_mesh((2, 2, 2))
    jroll, _ = jgs.make_grid_sharded_sim(config, jmodel, 0.002, jmesh, backend="xla")
    ref = jroll(jgs.distribute_grid(st, config, jmesh), num_steps=60, rebin_every=5)
    runs = {shape: _port_run(to_port(st), config, shape, 60, 5) for shape in SHAPES}
    return st, config, n, ref, runs


def test_spill_rollout_matches_jax(rollouts):
    st, config, n, ref, runs = rollouts
    out, whole, _ = runs[(2, 2, 2)]
    assert not bool(ref.overflow) and not bool(out.overflow) and int(out.step) == 60
    np.testing.assert_array_equal(tcd.state_to_numpy(gs._grid_leaves(whole, config))["atom_id"],
                                  np.asarray(ref.atom_id))
    p_ref, v_ref = jgs.gather_grid_atoms(ref, config, n)
    p, v = tcd.gather_dense_atoms(whole, n)
    np.testing.assert_allclose(p, p_ref, atol=2e-5)
    np.testing.assert_allclose(v, v_ref, atol=2e-4)
    # The init stores every atom in its true cell; the run ends with atoms
    # stored one cell above: the rebins spilled and held them.
    assert _held(to_port(st), config) == 0 and _held(whole, config) > 20


def test_spill_decompositions_bitwise_equal(rollouts):
    *_, runs = rollouts
    first = tcd.state_to_numpy(runs[SHAPES[0]][1])
    for shape in SHAPES[1:]:
        got = tcd.state_to_numpy(runs[shape][1])
        for name, want in first.items():
            np.testing.assert_array_equal(bits(got[name]), bits(want), err_msg=f"{shape} {name}")


def test_spill_csvr_matches_jax_on_shared_draws(monkeypatch):
    """CSVR on (2,2,2) against JAX's grid CSVR with its normal and gamma
    draws fixed, the port's `csvr_draws` returning the same values (as
    tests/test_torch_grid_sharded.py's plain-config case): 20 steps within
    2e-4."""
    st, config, jmodel, n = _spill_fixture()
    r1, half_sum_r2 = np.float32(0.7), np.float32(2200.0)  # Σ R_i² = 4400 over 4497 dofs
    csvr = dict(temperature=1.0, tau=0.2)
    jmesh = jgs.make_grid_mesh((2, 2, 2))
    jroll, _ = jgs.make_grid_sharded_sim(config, jmodel, 0.002, jmesh, backend="xla", thermostat=jcd.CSVRConfig(**csvr))
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=np.float32: jnp.full(shape, r1, dtype))
        mp.setattr(jax.random, "gamma", lambda key, a, shape=(), dtype=np.float32: jnp.full(shape, half_sum_r2, dtype))
        ref = jroll(jgs.distribute_grid(st, config, jmesh), num_steps=20, rebin_every=5, rng=jax.random.PRNGKey(0))
        p_ref, v_ref = jgs.gather_grid_atoms(ref, config, n)

    from emdee_tpu_torch.dynamics import bussi as tbussi

    monkeypatch.setattr(tbussi, "csvr_draws", lambda rng, ndof, like: (
        torch.tensor(float(r1)), 2.0 * torch.tensor(float(half_sum_r2))))
    mesh = make_grid_mesh((2, 2, 2), device="cpu")
    rollout, _ = gs.make_grid_sharded_sim(config, MODEL, 0.002, mesh, thermostat=CSVRConfig(**csvr))
    out = rollout(gs.distribute_grid(to_port(st), config, mesh), num_steps=20, rebin_every=5, rng=torch.Generator())
    assert not bool(ref.overflow) and not bool(out.overflow)
    p, v = gs.gather_grid_atoms(out, config, n, mesh)
    np.testing.assert_allclose(p, p_ref, atol=2e-4)
    np.testing.assert_allclose(v, v_ref, atol=2e-4)
    v0 = tcd.gather_dense_atoms(to_port(st), n)[1]
    assert np.abs(v).sum() > 1.02 * np.abs(v0).sum()  # the fixed draws heat the fixture


@pytest.mark.parametrize("backend", ["torch", "torch_streaming"])
@pytest.mark.parametrize("ensemble", ["langevin", "npt"])
def test_spill_ensembles_run(backend, ensemble):
    """Langevin and Berendsen NPT take spill configs on both plain
    families: 10 steps on (2,2,2) with no flag, and bitwise equal to the
    (1,1,1) run."""
    st, config, _, n = _spill_fixture()
    kw = dict(thermostat=LangevinConfig(temperature=1.0, friction=1.0)) if ensemble == "langevin" else dict(
        barostat=BerendsenBarostatConfig(pressure=1.0, tau=0.5, kappa=0.1))
    runs = []
    for shape in [(1, 1, 1), (2, 2, 2)]:
        mesh = make_grid_mesh(shape, device="cpu")
        rollout, _ = gs.make_grid_sharded_sim(config, MODEL, 0.002, mesh, backend=backend, **kw)
        out = rollout(gs.distribute_grid(to_port(st), config, mesh), num_steps=10, rebin_every=5,
                      rng=torch.Generator().manual_seed(4))
        assert not bool(out.overflow)
        runs.append(gs.gather_grid_atoms(out, config, n, mesh))
    if backend == "torch":
        for a, b in zip(*runs):
            np.testing.assert_array_equal(bits(a), bits(b))
    else:  # the fold adds boundary reactions in another order on (2,2,2)
        for a, b in zip(*runs):
            np.testing.assert_allclose(a, b, atol=2e-4)


def test_spill_charged_matches_jax():
    """The grid's charged fixture (DSF + exclusion tags, tests/
    test_grid_sharded.py:150-202) on a spill config (M = 8, C = 12, squeezed
    toward 6 atoms a cell) on
    (2,2,2): energy within rel 1e-5 / abs 1e-2 and 20 steps within 2e-4 of
    JAX's grid engine."""
    a = fixtures.grid_charged_arrays()
    n = a["n"]
    config = jcd.suggest_cell_dense_config(n, a["box"], cutoff=2.5, switch=2.0, skin=0.3, spill=True)
    config = config._replace(cells_per_dim=8, capacity=12, spill_target=6)  # M even, ~4 atoms a cell
    assert float(config.cell_side) - 2.5 - 0.3 > 0
    st = jcd.cell_dense_init(a["pos"], a["vel"], np.ones(n), jlj(np.ones(n), np.ones(n)), config, charges=a["q"])
    assert not bool(st.overflow)
    jmesh = jgs.make_grid_mesh((2, 2, 2))
    jroll, jenergy = jgs.make_grid_sharded_sim(
        config, JModel.create(2.5, 2.0), 0.002, jmesh, backend="xla",
        coulomb=JCoulomb.create(2.5, alpha=0.25, coulomb_constant=1.0),
        excl_tables=jmol.build_exclusion_tables(n, a["pairs"], a["ljs"], a["cs"]))
    jst = jgs.distribute_grid(st, config, jmesh)
    out, whole, energy = _port_run(to_port(st), config, (2, 2, 2), 20, 5, **fixtures.grid_charged_kwargs("cpu"))
    mesh = make_grid_mesh((2, 2, 2), device="cpu")
    pe = float(energy(gs.distribute_grid(to_port(st), config, mesh))[0])
    assert pe == pytest.approx(float(jenergy(jst)[0]), rel=1e-5, abs=1e-2)
    ref = jroll(jst, num_steps=20, rebin_every=5)
    assert not bool(ref.overflow) and not bool(out.overflow)
    p_ref, v_ref = jgs.gather_grid_atoms(ref, config, n)
    p, v = tcd.gather_dense_atoms(whole, n)
    np.testing.assert_allclose(p, p_ref, atol=2e-4)
    np.testing.assert_allclose(v, v_ref, atol=2e-4)
    assert _held(whole, config) > 0


def test_reconfigure_grid_state_keeps_spill():
    """After the box grows by 1.4 (positions with it), the re-derived
    geometry is JAX's, still a spill config, and the new state holds every
    atom exactly and runs without a flag (the spill lattice)."""
    st, config, _, n = _spill_lattice()
    grow = np.float32(1.4)
    box = float(np.float32(config.box) * grow)
    jst = st._replace(positions=st.positions * grow, box=jnp.float32(box))
    jmesh = jgs.make_grid_mesh((2, 1, 1))
    _, jcfg = jgs.reconfigure_grid_state(jgs.distribute_grid(jst, config, jmesh), config, jmesh)
    mesh = make_grid_mesh((2, 1, 1), device="cpu")
    port = to_port(st)
    port = port._replace(positions=port.positions * float(grow), box=torch.tensor(box, dtype=torch.float32))
    sh = gs.distribute_grid(port, config, mesh)
    p0, v0 = gs.gather_grid_atoms(sh, config, n, mesh)
    new, cfg = gs.reconfigure_grid_state(sh, config, mesh)
    assert cfg == jcfg and cfg.spill
    assert not bool(new.overflow)
    p1, v1 = gs.gather_grid_atoms(new, cfg, n, mesh)
    np.testing.assert_array_equal(bits(v1), bits(v0))
    wrap = lambda p: p - np.floor(p / np.float32(box)) * np.float32(box)  # noqa: E731  seam spills hold p − L
    np.testing.assert_allclose(wrap(p1), wrap(p0), atol=1e-4)
    roll, _ = gs.make_grid_sharded_sim(cfg, MODEL, 0.002, mesh)
    assert not bool(roll(new, num_steps=4, rebin_every=2).overflow)


def test_spill_gloo_dist_mesh_bitwise_equals_local_mesh():
    """Two gloo ranks, (2,1,1): the depth-2 halo planes cross ranks."""
    st, config, _, _ = _spill_fixture()
    port = to_port(st)
    runs = dryrun.run_ranks(2, dryrun.grid_job, ((2, 1, 1), tcd.state_to_numpy(port), config, 30, 5), timeout=240)
    out, whole, energy = _port_run(port, config, (2, 1, 1), 30, 5)
    want = tcd.state_to_numpy(whole)
    energies = tuple(float(x) for x in energy(out))
    for got, got_e in runs:
        for name in want:
            np.testing.assert_array_equal(bits(got[name]), bits(want[name]), err_msg=name)
        np.testing.assert_allclose(got_e, energies, rtol=1e-6)
