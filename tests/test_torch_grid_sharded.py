"""The port's grid-sharded engine (`emdee_tpu_torch.distributed`) on the CPU
against the JAX package's (`emdee_tpu/distributed/grid_sharded.py`, XLA
backend, on the 8 virtual CPU devices of tests/conftest.py), at the JAX
tests' sizes and tolerances (tests/test_grid_sharded.py): the config checks,
the layout round trip, energies on (2,2,2), (2,4,1) and (4,1,1), 30-step
rollouts and CSVR on shared fixed draws on (2,2,2) and (2,4,1); and on the
port's side alone: the ghost
forces' plain version bit for bit equal to the one-card plain forces, the
decompositions bitwise equal to each other, CSVR NVT against the one-card
engine, a 2-rank gloo `DistMesh` run bitwise equal to `LocalMesh` (2,1,1),
and a mesh that needs a card refused without one.  The molecular options
are tests/test_torch_grid_molecular.py's, spill configs
tests/test_torch_grid_spill.py's.  The streaming family (K5s) is tests/test_torch_grid_streaming.py's,
Langevin, NPT and `reconfigure_grid_state` tests/test_torch_grid_ensembles.py's."""

import jax
import numpy as np
import pytest
import torch

from emdee_tpu.distributed import grid_sharded as jgs
from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.potentials.lennard_jones import LennardJonesModel as JaxModel
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom as jax_lj_atom
from emdee_tpu.utils.lattice import cubic_lattice, maxwell_boltzmann
from emdee_tpu_torch import CSVRConfig, LennardJonesModel, make_cell_dense_sim
from emdee_tpu_torch.distributed import dryrun
from emdee_tpu_torch.distributed import grid_sharded as gs
from emdee_tpu_torch.distributed.mesh import make_grid_mesh, validate_grid_config
from emdee_tpu_torch.neighbors import cell_dense as tcd
from torch_port_utils import bits, to_port

torch.set_num_threads(2)
SHAPES = [(1, 1, 1), (2, 2, 2), (2, 4, 1), (4, 1, 1)]


def _setup(n, density, T=0.9, seed=21):
    """tests/test_grid_sharded.py's `_setup`: (JAX state, config, JAX model, n)."""
    pos, box = cubic_lattice(n, density, jitter=0.1, seed=seed)
    vel = maxwell_boltzmann(n, T, seed=seed + 1)
    params = jax_lj_atom(np.ones(n), np.ones(n))
    config = jcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.3)
    config = config._replace(cells_per_dim=max((config.cells_per_dim // 8) * 8, 8))
    st = jcd.cell_dense_init(pos, vel, np.ones(n), params, config)
    assert not bool(st.overflow)
    return st, config, JaxModel.create(2.5, 2.0), n


@pytest.fixture(scope="module")
def energy_case():
    return _setup(4096, 0.25)


@pytest.fixture(scope="module")
def rollout_case():
    """The rollout fixture and the port's 30-step runs, by mesh shape."""
    st, config, jmodel, n = _setup(2048, 0.09)
    model = LennardJonesModel.create(2.5, 2.0, device="cpu")
    runs = {}
    for shape in SHAPES:
        mesh = make_grid_mesh(shape, device="cpu")
        rollout, _ = gs.make_grid_sharded_sim(config, model, 0.002, mesh)
        out = rollout(gs.distribute_grid(to_port(st), config, mesh), num_steps=30, rebin_every=5)
        runs[shape] = (out, gs.gather_grid_state(out, config, mesh))
    return st, config, jmodel, n, runs


def test_validate_grid_config_matches_reference(energy_case):
    _, config, _, _ = energy_case
    m = config.cells_per_dim
    assert validate_grid_config(config, make_grid_mesh((2, 2, 2), device="cpu")) == (m // 2,) * 3
    for cfg, shape, match in ((config._replace(cells_per_dim=m + 1), (2, 2, 2), "divide"),
                              (config, (8, 1, 1), "need ≥ 2")):
        with pytest.raises(ValueError, match=match) as ours:
            validate_grid_config(cfg, make_grid_mesh(shape, device="cpu"))
        with pytest.raises(ValueError) as theirs:
            jgs.validate_grid_config(cfg, jgs.make_grid_mesh(shape))
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 4, 1)])
def test_distribute_gather_round_trip(energy_case, shape):
    st, config, _, n = energy_case
    port = to_port(st)
    mesh = make_grid_mesh(shape, device="cpu")
    sharded = gs.distribute_grid(port, config, mesh)
    assert tuple(sharded.positions.shape) == shape + validate_grid_config(config, mesh) + (config.capacity, 3)
    back = gs.gather_grid_state(sharded, config, mesh)
    for a, b in zip(back, port):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    ref = jax.device_get(jgs.distribute_grid(st, config, jgs.make_grid_mesh(shape)))
    np.testing.assert_array_equal(bits(tcd.state_to_numpy(gs._grid_leaves(back, config))["positions"]),
                                  bits(ref.positions))
    p, v = gs.gather_grid_atoms(sharded, config, n, mesh)
    pr, vr = tcd.gather_dense_atoms(port, n)
    np.testing.assert_array_equal(p, pr)
    np.testing.assert_array_equal(v, vr)


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 4, 1), (4, 1, 1)])
def test_grid_energy_matches_reference_and_single_chip(energy_case, shape):
    st, config, jmodel, _ = energy_case
    mesh = make_grid_mesh(shape, device="cpu")
    _, energy = gs.make_grid_sharded_sim(config, LennardJonesModel.create(2.5, 2.0, device="cpu"), 0.002, mesh)
    pe, vir, ke = (float(x) for x in energy(gs.distribute_grid(to_port(st), config, mesh)))

    jmesh = jgs.make_grid_mesh(shape)
    _, jenergy = jgs.make_grid_sharded_sim(config, jmodel, 0.002, jmesh, backend="xla")
    jpe, jvir, jke = (float(x) for x in jenergy(jgs.distribute_grid(st, config, jmesh)))
    _, e_ref, w_ref = jcd.cell_dense_forces(st, jmodel, config, compute_energy=True)
    valid = np.asarray(st.valid)
    for got, grid_ref, single in ((pe, jpe, np.asarray(e_ref)[valid].sum()),
                                  (vir, jvir, np.asarray(w_ref)[valid].sum())):
        np.testing.assert_allclose(got, grid_ref, rtol=1e-5, atol=1e-2)
        np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(ke, jke, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 4, 1)])
def test_grid_rollout_matches_reference(rollout_case, shape):
    st, config, jmodel, n, runs = rollout_case
    jmesh = jgs.make_grid_mesh(shape)
    rollout, _ = jgs.make_grid_sharded_sim(config, jmodel, 0.002, jmesh, backend="xla")
    ref = rollout(jgs.distribute_grid(st, config, jmesh), num_steps=30, rebin_every=5)
    assert not bool(ref.overflow)
    out, whole = runs[shape]
    assert not bool(out.overflow) and int(out.step) == 30
    p_ref, v_ref = jgs.gather_grid_atoms(ref, config, n)
    p_out, v_out = tcd.gather_dense_atoms(whole, n)
    np.testing.assert_allclose(p_out, p_ref, atol=2e-4)
    np.testing.assert_allclose(v_out, v_ref, atol=2e-4)


def test_decompositions_bitwise_equal(rollout_case):
    _, _, _, _, runs = rollout_case
    first = tcd.state_to_numpy(runs[SHAPES[0]][1])
    for shape in SHAPES[1:]:
        got = tcd.state_to_numpy(runs[shape][1])
        for name, want in first.items():
            np.testing.assert_array_equal(bits(got[name]), bits(want), err_msg=f"{shape} {name}")


@pytest.mark.parametrize("shape,uniform", [((1, 1, 1), False), ((2, 2, 2), False), ((2, 4, 1), True)])
def test_plain_ghost_forces_equal_single_card_plain(energy_case, shape, uniform):
    st, config, _, _ = energy_case
    port = to_port(st)
    v = port.velocities
    port = port._replace(positions=torch.where(port.valid[..., None], port.positions + (0.45 * 0.3 / float(v.abs().max())) * v, 0.0))
    model = LennardJonesModel.create(2.5, 2.0, device="cpu")
    uni = (0.5, 2.0) if uniform else None
    f_ref, e_ref, w_ref = tcd._dense_forces(port.positions, port.half_sigma, port.twice_sqrt_eps, port.valid,
                                            model, config, config.box, True)
    mesh = make_grid_mesh(shape, device="cpu")
    sh = gs.distribute_grid(port, config, mesh)
    rollout, _ = gs.make_grid_sharded_sim(config, model, 0.002, mesh, uniform_params=uni)
    f, e, w = rollout.forces(sh, compute_energy=True)
    back = gs.gather_grid_state(sh._replace(positions=f, half_sigma=e, twice_sqrt_eps=w), config, mesh)
    assert torch.equal(back.positions.view(torch.int32), f_ref.view(torch.int32))
    assert torch.equal(back.half_sigma.view(torch.int32), e_ref.view(torch.int32))
    assert torch.equal(back.twice_sqrt_eps.view(torch.int32), w_ref.view(torch.int32))


def test_csvr_matches_single_card_engine(rollout_case):
    st, config, _, n, _ = rollout_case
    model = LennardJonesModel.create(2.5, 2.0, device="cpu")
    csvr = CSVRConfig(temperature=1.0, tau=0.2)
    mesh = make_grid_mesh((2, 2, 2), device="cpu")
    rollout, energy = gs.make_grid_sharded_sim(config, model, 0.002, mesh, thermostat=csvr)
    with pytest.raises(ValueError, match="rng"):
        rollout(gs.distribute_grid(to_port(st), config, mesh), num_steps=2)
    out = rollout(gs.distribute_grid(to_port(st), config, mesh), num_steps=20, rebin_every=5,
                  rng=torch.Generator().manual_seed(3))
    one, _ = make_cell_dense_sim(config, model, dt=0.002, backend="torch", thermostat=csvr)
    ref = one(to_port(st), num_steps=20, rebin_every=5, rng=torch.Generator().manual_seed(3))
    assert not bool(out.overflow) and not bool(ref.overflow)
    p, v = gs.gather_grid_atoms(out, config, n, mesh)
    pr, vr = tcd.gather_dense_atoms(ref, n)
    np.testing.assert_allclose(p, pr, atol=2e-4)
    np.testing.assert_allclose(v, vr, atol=2e-4)
    assert not np.array_equal(v, tcd.gather_dense_atoms(to_port(st), n)[1])


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 4, 1)])
def test_csvr_matches_reference_on_shared_draws(rollout_case, shape, monkeypatch):
    """CSVR against JAX's grid CSVR (grid_sharded.py:1150-1177) on the same
    draws: the reference's own `_csvr_alpha2` with its normal and gamma
    draws fixed, the port's with `csvr_draws` returning the same values.
    Each step's α² then depends only on the kinetic energy summed over the
    shards, and moves the velocities ~0.3% a step."""
    st, config, jmodel, n, _ = rollout_case
    r1, half_sum_r2 = np.float32(0.7), np.float32(3050.0)  # Σ R_i² = 6100 over 6140 dofs
    csvr = dict(temperature=1.0, tau=0.2)
    jmesh = jgs.make_grid_mesh(shape)
    jroll, _ = jgs.make_grid_sharded_sim(config, jmodel, 0.002, jmesh, backend="xla", thermostat=jcd.CSVRConfig(**csvr))
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=np.float32: jax.numpy.full(shape, r1, dtype))
        mp.setattr(jax.random, "gamma", lambda key, a, shape=(), dtype=np.float32: jax.numpy.full(shape, half_sum_r2, dtype))
        ref = jroll(jgs.distribute_grid(st, config, jmesh), num_steps=20, rebin_every=5, rng=jax.random.PRNGKey(0))
        p_ref, v_ref = jgs.gather_grid_atoms(ref, config, n)

    from emdee_tpu_torch.dynamics import bussi as tbussi

    monkeypatch.setattr(tbussi, "csvr_draws", lambda rng, ndof, like: (
        torch.tensor(float(r1)), 2.0 * torch.tensor(float(half_sum_r2))))
    mesh = make_grid_mesh(shape, device="cpu")
    rollout, _ = gs.make_grid_sharded_sim(config, LennardJonesModel.create(2.5, 2.0, device="cpu"), 0.002, mesh,
                                          thermostat=CSVRConfig(**csvr))
    out = rollout(gs.distribute_grid(to_port(st), config, mesh), num_steps=20, rebin_every=5, rng=torch.Generator())
    assert not bool(ref.overflow) and not bool(out.overflow)
    p, v = gs.gather_grid_atoms(out, config, n, mesh)
    np.testing.assert_allclose(p, p_ref, atol=2e-4)
    np.testing.assert_allclose(v, v_ref, atol=2e-4)
    v0 = tcd.gather_dense_atoms(to_port(st), n)[1]
    assert np.abs(v).sum() > 1.02 * np.abs(v0).sum()  # the fixed draws heat the fixture


def test_gloo_dist_mesh_bitwise_equals_local_mesh(rollout_case):
    st, config, _, _, _ = rollout_case
    port = to_port(st)
    runs = dryrun.run_ranks(2, dryrun.grid_job, ((2, 1, 1), tcd.state_to_numpy(port), config, 30, 5), timeout=240)
    mesh = make_grid_mesh((2, 1, 1), device="cpu")
    rollout, energy = gs.make_grid_sharded_sim(config, LennardJonesModel.create(2.5, 2.0, device="cpu"), 0.002, mesh)
    out = rollout(gs.distribute_grid(port, config, mesh), num_steps=30, rebin_every=5)
    want = tcd.state_to_numpy(gs.gather_grid_state(out, config, mesh))
    energies = tuple(float(x) for x in energy(out))
    for got, got_e in runs:
        for name in want:
            np.testing.assert_array_equal(bits(got[name]), bits(want[name]), err_msg=name)
        np.testing.assert_allclose(got_e, energies, rtol=1e-6)


def test_refused_modes_raise(energy_case):
    if not torch.cuda.is_available():  # the mesh builds on the card unless told otherwise
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_grid_mesh((1, 1, 1))


def test_bitwise_determinism_grid_sharded():
    """tests/test_fidelity.py's grid gate: two 20-step rollouts on (2,2,2)
    are bitwise equal."""
    pos, box = cubic_lattice(2048, 0.25, jitter=0.1, seed=5)
    config = tcd.suggest_cell_dense_config(2048, box, cutoff=2.5, switch=2.0, skin=0.3)
    config = config._replace(cells_per_dim=max((config.cells_per_dim // 2) * 2, 4))
    params = tcd.lj_params_from_numpy(jax_lj_atom(np.ones(2048), np.ones(2048)), "cpu")
    st = tcd.cell_dense_init(pos, maxwell_boltzmann(2048, 0.9, seed=6), np.ones(2048), params, config, device="cpu")
    mesh = make_grid_mesh((2, 2, 2), device="cpu")
    rollout, _ = gs.make_grid_sharded_sim(config, LennardJonesModel.create(2.5, 2.0, device="cpu"), 0.002, mesh)
    a = rollout(gs.distribute_grid(st, config, mesh), num_steps=20, rebin_every=5)
    b = rollout(gs.distribute_grid(st, config, mesh), num_steps=20, rebin_every=5)
    for name in ("positions", "velocities", "atom_id"):
        np.testing.assert_array_equal(bits(getattr(a, name).numpy()), bits(getattr(b, name).numpy()), err_msg=name)
