"""The grid-sharded engine's Langevin thermostat, Berendsen barostat and
`reconfigure_grid_state` (ROADMAP item 11.1) on the CPU, against the JAX
package's grid engine (emdee_tpu/distributed/grid_sharded.py, `xla`, 8
virtual CPU devices): NPT on the triatomic fixture of
tests/test_grid_sharded_pallas.py:143-170 on shared fixed CSVR draws, on the
resident plain pass and on `torch_streaming` (its energy pass feeds the
pressure); Langevin on shared fixed noise; the geometry re-derive.  On the
port's side alone: Langevin on a 2-rank gloo `DistMesh` bitwise equal to
`LocalMesh` (the global noise field cut to each rank's shard), and against
the one-card engine drawing the same noise.  The relaxation gates of
tests/test_grid_sharded.py:306-400 run in the full tier, as there."""

import jax
import numpy as np
import pytest
import torch

from emdee_tpu.distributed import grid_sharded as jgs
from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.neighbors import cell_dense_molecular as jmol
from emdee_tpu.potentials.coulomb import DSFCoulomb as JCoulomb
from emdee_tpu.potentials.lennard_jones import LennardJonesModel as JModel
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom as jlj
from emdee_tpu.utils.lattice import cubic_lattice, fcc_lattice, maxwell_boltzmann
from emdee_tpu_torch import BerendsenBarostatConfig, CSVRConfig, LangevinConfig, LennardJonesModel
from emdee_tpu_torch import make_cell_dense_sim
from emdee_tpu_torch.distributed import dryrun
from emdee_tpu_torch.distributed import grid_sharded as gs
from emdee_tpu_torch.distributed.mesh import make_grid_mesh
from emdee_tpu_torch.dynamics import bussi as tbussi
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.tools import fixtures
from torch_port_utils import bits, jax_triatomic_bonded, to_port

torch.set_num_threads(2)
JMODEL = JModel.create(2.5, 2.0)
R1, HALF_SUM_R2 = np.float32(0.7), np.float32(555.0)  # Σ R_i² = 1110 over the triatomic's 1121 dofs
NOISE = 0.3  # the Langevin tests' fixed noise


def _model():
    return LennardJonesModel.create(2.5, 2.0, device="cpu")


def _lj_setup(n=1024, density=0.12, T=0.9, seed=21):
    """tests/test_grid_sharded.py's `_setup` at the streaming test's size:
    (JAX state, config, n)."""
    pos, box = cubic_lattice(n, density, jitter=0.1, seed=seed)
    config = jcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.3)
    config = config._replace(cells_per_dim=max((config.cells_per_dim // 8) * 8, 8))
    st = jcd.cell_dense_init(pos, maxwell_boltzmann(n, T, seed=seed + 1), np.ones(n), jlj(np.ones(n), np.ones(n)), config)
    assert not bool(st.overflow)
    return st, config, n


NPT = dict(thermostat=dict(temperature=0.4, tau=0.2), barostat=dict(pressure=0.2, tau=0.5, kappa=1.0))


@pytest.fixture(scope="module")
def npt_reference():
    """JAX's grid NPT (CSVR + Berendsen, `xla`) on the triatomic fixture,
    (2,2,2), 6 steps at rebin 3, with its CSVR draws fixed."""
    fx = fixtures.triatomic_arrays()
    n = fx["n"]
    config = jcd.suggest_cell_dense_config(n, fx["box"], cutoff=2.5, switch=2.0, skin=0.3)
    params = jlj(np.ones(n), np.ones(n))
    tabs, leftover = jmol.build_exclusion_tables(n, fx["pairs"], fx["ljs"], fx["cs"], band_e=1)
    st = jcd.cell_dense_init(fx["pos"], fx["vel"], np.ones(n), params, config, charges=fx["q"])
    jkw = dict(coulomb=JCoulomb.create(2.5, alpha=0.25, coulomb_constant=1.0), excl_tables=tabs,
               bonded=jax_triatomic_bonded(fx), excl_leftover=leftover, atom_params=params, atom_charges=fx["q"],
               thermostat=jcd.CSVRConfig(**NPT["thermostat"]),
               barostat=jcd.BerendsenBarostatConfig(**NPT["barostat"]))
    jmesh = jgs.make_grid_mesh((2, 2, 2))
    jroll, _ = jgs.make_grid_sharded_sim(config, JMODEL, 1e-3, jmesh, backend="xla", **jkw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=np.float32: jax.numpy.full(shape, R1, dtype))
        mp.setattr(jax.random, "gamma",
                   lambda key, a, shape=(), dtype=np.float32: jax.numpy.full(shape, HALF_SUM_R2, dtype))
        ref = jroll(jgs.distribute_grid(st, config, jmesh), num_steps=6, rebin_every=3, rng=jax.random.PRNGKey(5))
        assert not bool(ref.overflow)
        p_ref, _ = jgs.gather_grid_atoms(ref, config, n)
    return st, config, n, float(ref.box), p_ref


@pytest.mark.parametrize("backend", ["torch", "torch_streaming"])
def test_grid_npt_matches_reference_on_shared_draws(npt_reference, backend, monkeypatch):
    """Berendsen NPT + CSVR on the triatomic fixture (DSF, tags, bonded
    rows, leftover pairs), the pressure from the force pass's energy mode
    (the resident plain pass, or the streaming plain pass and its fold),
    against JAX's on the same CSVR draws: box within rel 1e-5 and positions
    within 1e-4 after 6 steps (tests/test_grid_sharded_pallas.py's gate)."""
    st, config, n, box_ref, p_ref = npt_reference
    monkeypatch.setattr(tbussi, "csvr_draws", lambda rng, ndof, like: (
        torch.tensor(float(R1)), 2.0 * torch.tensor(float(HALF_SUM_R2))))
    mesh = make_grid_mesh((2, 2, 2), device="cpu")
    roll, _ = gs.make_grid_sharded_sim(config, _model(), 1e-3, mesh, backend=backend,
                                       thermostat=CSVRConfig(**NPT["thermostat"]),
                                       barostat=BerendsenBarostatConfig(**NPT["barostat"]),
                                       **fixtures.triatomic_grid_kwargs("cpu"))
    out = roll(gs.distribute_grid(to_port(st), config, mesh), num_steps=6, rebin_every=3, rng=torch.Generator())
    assert not bool(out.overflow) and out.box is not None and out.box.dim() == 0
    assert float(out.box) == pytest.approx(box_ref, rel=1e-5)
    assert float(out.box) != pytest.approx(config.box, rel=1e-6)  # the barostat moved the box
    p, _ = gs.gather_grid_atoms(out, config, n, mesh)
    np.testing.assert_allclose(p, p_ref, atol=1e-4)


def test_grid_langevin_matches_reference_on_shared_noise(monkeypatch):
    """BAOAB Langevin (T* = 1, friction 2) on (2,2,2) against JAX's grid
    Langevin (grid_sharded.py:1119-1146) with every normal draw fixed to
    0.3 on both sides: 20 steps within 2e-4."""
    st, config, n = _lj_setup()
    lang = dict(temperature=1.0, friction=2.0)
    jmesh = jgs.make_grid_mesh((2, 2, 2))
    jroll, _ = jgs.make_grid_sharded_sim(config, JMODEL, 0.002, jmesh, backend="xla",
                                         thermostat=jcd.LangevinConfig(**lang))
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=np.float32: jax.numpy.full(shape, NOISE, dtype))
        ref = jroll(jgs.distribute_grid(st, config, jmesh), num_steps=20, rebin_every=5, rng=jax.random.PRNGKey(1))
        p_ref, v_ref = jgs.gather_grid_atoms(ref, config, n)
    mesh = make_grid_mesh((2, 2, 2), device="cpu")
    roll, _ = gs.make_grid_sharded_sim(config, _model(), 0.002, mesh, thermostat=LangevinConfig(**lang))
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None, dtype=None, device=None: torch.full(
        shape, NOISE, dtype=dtype, device=device))
    out = roll(gs.distribute_grid(to_port(st), config, mesh), num_steps=20, rebin_every=5, rng=torch.Generator())
    assert not bool(ref.overflow) and not bool(out.overflow)
    p, v = gs.gather_grid_atoms(out, config, n, mesh)
    np.testing.assert_allclose(p, p_ref, atol=2e-4)
    np.testing.assert_allclose(v, v_ref, atol=2e-4)
    v0 = jgs.gather_grid_atoms(jgs.distribute_grid(st, config, jmesh), config, n)[1]
    assert np.abs(v - v0).max() > 0.05  # the fixed noise moved the velocities


def test_grid_langevin_gloo_bitwise_equals_local_mesh_and_matches_single_card():
    """Langevin on two gloo ranks, (2,1,1), each drawing the global noise
    field from a generator seeded alike and keeping its shard's part:
    bitwise the LocalMesh run; and the LocalMesh run within 2e-4 of the
    one-card engine drawing the same field from the same seed."""
    st, config, n = _lj_setup()
    port = to_port(st)
    kwargs = {"thermostat": LangevinConfig(temperature=1.0, friction=2.0)}
    runs = dryrun.run_ranks(2, dryrun.grid_job, ((2, 1, 1), tcd.state_to_numpy(port), config, 10, 5, "cpu", None,
                                                 kwargs, 7), timeout=240)
    mesh = make_grid_mesh((2, 1, 1), device="cpu")
    rollout, energy = gs.make_grid_sharded_sim(config, _model(), 0.002, mesh, **kwargs)
    out = rollout(gs.distribute_grid(port, config, mesh), num_steps=10, rebin_every=5,
                  rng=torch.Generator().manual_seed(7))
    want = tcd.state_to_numpy(gs.gather_grid_state(out, config, mesh))
    energies = tuple(float(x) for x in energy(out))
    for got, got_e in runs:
        for name in want:
            np.testing.assert_array_equal(bits(got[name]), bits(want[name]), err_msg=name)
        np.testing.assert_allclose(got_e, energies, rtol=1e-6)
    one, _ = make_cell_dense_sim(config, _model(), dt=0.002, backend="torch", **kwargs)
    ref = one(port, num_steps=10, rebin_every=5, rng=torch.Generator().manual_seed(7))
    assert not bool(out.overflow) and not bool(ref.overflow)
    p, v = gs.gather_grid_atoms(out, config, n, mesh)
    pr, vr = tcd.gather_dense_atoms(ref, n)
    np.testing.assert_allclose(p, pr, atol=2e-4)
    np.testing.assert_allclose(v, vr, atol=2e-4)


def _npt_fixture():
    """tests/test_grid_sharded.py's NPT fixture: FCC 7³ at ρ 0.85 (1,372
    atoms, M = 4): (JAX state, config, n)."""
    pos, box = fcc_lattice(7, density=0.85)
    n = pos.shape[0]
    config = jcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.35)
    assert config.cells_per_dim == 4
    st = jcd.cell_dense_init(pos, maxwell_boltzmann(n, 1.0, seed=31), np.ones(n), jlj(np.ones(n), np.ones(n)), config)
    return st, config, n


def test_reconfigure_grid_state_matches_reference():
    """After the box grows by 1.5 (positions with it), the re-derived
    geometry is JAX's (M = 6 on (2,1,1), the capacity, the box), the
    state holds every atom in its true cell with no flag, and every atom's
    position and velocity come back exactly."""
    st, config, n = _npt_fixture()
    grow = np.float32(1.5)
    box = float(np.float32(config.box) * grow)
    jst = st._replace(positions=st.positions * grow, box=jax.numpy.float32(box))
    jmesh = jgs.make_grid_mesh((2, 1, 1))
    _, jcfg = jgs.reconfigure_grid_state(jgs.distribute_grid(jst, config, jmesh), config, jmesh)
    mesh = make_grid_mesh((2, 1, 1), device="cpu")
    port = to_port(st)
    port = port._replace(positions=port.positions * float(grow), box=torch.tensor(box, dtype=torch.float32))
    sh = gs.distribute_grid(port, config, mesh)
    p0, v0 = gs.gather_grid_atoms(sh, config, n, mesh)
    new, cfg = gs.reconfigure_grid_state(sh, config, mesh)
    assert cfg == jcfg and cfg.cells_per_dim == 6
    assert not bool(new.overflow) and tuple(new.positions.shape[:6]) == (2, 1, 1, 3, 6, 6)
    p1, v1 = gs.gather_grid_atoms(new, cfg, n, mesh)
    np.testing.assert_array_equal(bits(p1), bits(p0))
    np.testing.assert_array_equal(bits(v1), bits(v0))
    roll, _ = gs.make_grid_sharded_sim(cfg, _model(), 0.002, mesh)
    assert not bool(roll(new, num_steps=4, rebin_every=2).overflow)


# ---------------------------------------------------------------------------
# The full tier: the relaxation gates of tests/test_grid_sharded.py
# ---------------------------------------------------------------------------


@pytest.mark.full
@pytest.mark.parametrize("kind", ["csvr", "langevin"])
def test_grid_thermostat_relaxes_to_target(kind):
    """From T* = 0.2, 500 steps on (2,2,2) heat the fixture to the target
    (0.8 < T* < 1.25); NVE rollouts are unchanged by an rng."""
    st, config, n = _lj_setup(T=0.2)
    mesh = make_grid_mesh((2, 2, 2), device="cpu")
    thermostat = CSVRConfig(temperature=1.0, tau=0.2) if kind == "csvr" else LangevinConfig(1.0, 2.0)
    r_nvt, _ = gs.make_grid_sharded_sim(config, _model(), 0.004, mesh, thermostat=thermostat)
    sh = gs.distribute_grid(to_port(st), config, mesh)
    out = r_nvt(sh, num_steps=500, rebin_every=5, rng=torch.Generator().manual_seed(4))
    assert not bool(out.overflow)
    v = out.velocities[out.valid].numpy()
    assert 0.8 < float((v**2).sum()) / (3.0 * n - 3.0) < 1.25
    r_nve, _ = gs.make_grid_sharded_sim(config, _model(), 0.004, mesh)
    a = r_nve(sh, num_steps=20, rebin_every=5)
    b = r_nve(sh, num_steps=20, rebin_every=5, rng=torch.Generator().manual_seed(9))
    assert torch.equal(a.positions, b.positions)


@pytest.mark.full
@pytest.mark.parametrize("backend", ["torch", "torch_streaming"])
def test_grid_npt_relaxes_pressure(backend):
    """From the compressed FCC liquid (P* > 1.5 after 300 CSVR steps),
    600 NPT steps on (2,1,1) grow the box by more than 1% and close half
    the gap to P* = 0.5."""
    st, config, n = _npt_fixture()
    mesh = make_grid_mesh((2, 1, 1), device="cpu")
    csvr = CSVRConfig(temperature=1.0, tau=0.2)
    nvt, energy = gs.make_grid_sharded_sim(config, _model(), 0.004, mesh, backend=backend, thermostat=csvr)
    npt, _ = gs.make_grid_sharded_sim(config, _model(), 0.004, mesh, backend=backend, thermostat=csvr,
                                      barostat=BerendsenBarostatConfig(pressure=0.5, tau=0.4, kappa=1.0))

    def pressure(state):
        _, vir, ke = (float(x) for x in energy(state))
        b = config.box if state.box is None else float(state.box)
        return (2.0 * ke + vir) / (3.0 * b**3)

    sh = nvt(gs.distribute_grid(to_port(st), config, mesh), num_steps=300, rebin_every=5,
             rng=torch.Generator().manual_seed(7))
    assert not bool(sh.overflow)
    p0 = pressure(sh)
    assert p0 > 1.5
    out = npt(sh, num_steps=600, rebin_every=5, rng=torch.Generator().manual_seed(13))
    assert not bool(out.overflow)
    assert float(out.box) > config.box * 1.01
    assert abs(pressure(out) - 0.5) < 0.5 * abs(p0 - 0.5)
