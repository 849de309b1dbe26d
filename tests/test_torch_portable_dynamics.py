"""The portable engine's dynamics (`emdee_tpu_torch.dynamics`: velocity
Verlet, CSVR, Langevin BAOAB, Berendsen NPT, FIRE, the observables) against
the JAX package's, on the CPU, and the port's dense engine against the
port's all-pairs rollout (tests/test_cell_dense.py:32, :60, :210).

Both sides start from the same numpy inputs (`state_from_numpy` carries a
JAX `State` across bit for bit).  Random draws cannot cross the packages (a
`jax.random` key against a `torch.Generator`), so the stochastic steps run
their pure halves (`baoab_step`, `csvr_rescale`) on JAX's own draws, split
from the state's key as the reference splits it.  Tolerances: forces rtol
1e-4, atol 5e-4; short trajectories atol 5e-4 (tests/test_cell_dense.py:
80-81); the records rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.core.types import make_state as jax_make_state
from emdee_tpu.dynamics import bussi as jbussi
from emdee_tpu.dynamics import langevin as jlangevin
from emdee_tpu.dynamics import minimize as jmin
from emdee_tpu.dynamics import npt as jnpt
from emdee_tpu.dynamics import observables as jobs
from emdee_tpu.dynamics import verlet as jverlet
from emdee_tpu.neighbors import api as japi
from emdee_tpu.neighbors.allpairs import compute_nonbonded_allpairs as jax_allpairs
from emdee_tpu.potentials.lennard_jones import LennardJonesModel as JModel
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom as jlj
from emdee_tpu.utils.lattice import cubic_lattice, maxwell_boltzmann
from emdee_tpu_torch.core.types import ENERGIES, FORCES, VIRIALS, make_state, state_from_numpy, state_to_numpy
from emdee_tpu_torch.dynamics import bussi as tbussi
from emdee_tpu_torch.dynamics import langevin as tlangevin
from emdee_tpu_torch.dynamics import minimize as tmin
from emdee_tpu_torch.dynamics import npt as tnpt
from emdee_tpu_torch.dynamics import observables as tobs
from emdee_tpu_torch.dynamics import verlet as tverlet
from emdee_tpu_torch.neighbors import api as tapi
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.neighbors.allpairs import compute_nonbonded_allpairs
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel as TModel
from emdee_tpu_torch.potentials.lennard_jones import lennard_jones_atom as tlj

torch.set_num_threads(2)

ATOL = 5e-4


def _system(n, density, method, temperature=1.0, seed=4, jitter=0.05, **cfg):
    """(JAX state, port state, JAX bundle, port bundle) of a jittered
    lattice with MB velocities; the JAX state carries a PRNG key."""
    pos, box = cubic_lattice(n, density, jitter=jitter, seed=seed)
    vel = maxwell_boltzmann(n, temperature, seed=seed + 1)
    js = jax_make_state(pos, vel, box=box)._replace(rng=jax.random.PRNGKey(seed))
    ts = state_from_numpy(jax.device_get(js)._asdict(), "cpu", rng=torch.Generator().manual_seed(seed))
    kw = dict(cutoff=2.5, switch=2.0, method=method, **cfg)
    jnb = japi.make_force_fn(japi.NonbondedConfig(**kw), jlj(np.ones(n), np.ones(n)), box, n)
    tnb = tapi.make_force_fn(tapi.NonbondedConfig(**kw), tlj(np.ones(n), np.ones(n), device="cpu"), box, n,
                             device="cpu")
    return js, ts, jnb, tnb


def _assert_states_close(ts, js, atol=ATOL):
    got, want = state_to_numpy(ts), jax.device_get(js)
    assert int(got["step"]) == int(want.step)
    np.testing.assert_allclose(got["box"], np.asarray(want.box), rtol=1e-6)
    np.testing.assert_allclose(got["positions"], np.asarray(want.positions), atol=atol)
    np.testing.assert_allclose(got["velocities"], np.asarray(want.velocities), atol=atol)


def _energy_fns(jnb, tnb):
    def jfn(p, a):
        out = jnb.compute(p, a, outputs=ENERGIES | VIRIALS)
        return jnp.sum(out.energies), jnp.sum(out.virials)

    def tfn(p, a):
        out = tnb.compute(p, a, outputs=ENERGIES | VIRIALS)
        return torch.sum(out.energies), torch.sum(out.virials)

    return jfn, tfn


def test_state_crosses_bit_for_bit():
    js, ts, _, _ = _system(64, 0.4, "allpairs")
    for name, a in state_to_numpy(ts).items():
        w = np.asarray(getattr(js, name))
        assert a.dtype == w.dtype and a.shape == w.shape, name
        np.testing.assert_array_equal(a, w, err_msg=name)
    pos, box = cubic_lattice(27, 0.3, seed=1)
    direct = make_state(pos, box=box, step=3, device="cpu")
    for name, a in state_to_numpy(direct).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jax_make_state(pos, box=box, step=3), name)), name)


@pytest.mark.parametrize("method,n,skin", [("allpairs", 216, 0.0), ("neighbor_list", 1000, 0.4)])
def test_verlet_step_and_recorded_rollout_match_jax(method, n, skin):
    """One velocity-Verlet step, then a 40-step rollout with a record every
    10 (E_kin, E_pot and W through `energy_fn`), against JAX's."""
    js, ts, jnb, tnb = _system(n, 0.7, method, skin=skin)
    jaux, taux = jnb.init(js.positions), tnb.init(ts.positions)
    jf, jaux = jnb.force_fn(js.positions, js.box, jaux)
    tf, taux = tnb.force_fn(ts.positions, ts.box, taux)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-4, atol=ATOL)
    j1, jf1, _ = jverlet.velocity_verlet_step(js, jf, jaux, jnb.force_fn, 0.002)
    t1, tf1, _ = tverlet.velocity_verlet_step(ts, tf, taux, tnb.force_fn, 0.002)
    _assert_states_close(t1, j1)
    np.testing.assert_allclose(tf1.numpy(), np.asarray(jf1), rtol=1e-4, atol=ATOL)

    jfn, tfn = _energy_fns(jnb, tnb)
    jend, _, jtraj = jverlet.nve_rollout(js, jnb.init(js.positions), jnb.force_fn, 0.002, 40, record_every=10,
                                         energy_fn=jfn)
    tend, taux, ttraj = tverlet.nve_rollout(ts, tnb.init(ts.positions), tnb.force_fn, 0.002, 40, record_every=10,
                                            energy_fn=tfn)
    _assert_states_close(tend, jend)
    np.testing.assert_array_equal(ttraj.step.numpy(), np.asarray(jtraj.step))
    for name in ("kinetic_energy", "potential_energy", "virial"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(), np.asarray(getattr(jtraj, name)), rtol=1e-4,
                                   err_msg=name)
    if method == "neighbor_list":
        assert not bool(taux.overflow)
    _, _, none = tverlet.nve_rollout(ts, tnb.init(ts.positions), tnb.force_fn, 0.002, 3)
    assert none is None
    with pytest.raises(ValueError, match="multiple of record_every"):
        tverlet.nve_rollout(ts, tnb.init(ts.positions), tnb.force_fn, 0.002, 25, record_every=10)


def test_langevin_step_on_jax_draws():
    """`baoab_step` on the noise JAX's `langevin_baoab_step` draws
    (langevin.py:47-48), against that step; and `nvt_rollout` records."""
    js, ts, jnb, tnb = _system(216, 0.7, "allpairs")
    jf, _ = jnb.force_fn(js.positions, js.box, ())
    tf, _ = tnb.force_fn(ts.positions, ts.box, ())
    want, jf1, _ = jlangevin.langevin_baoab_step(js, jf, (), jnb.force_fn, 0.004, 2.0, 1.0)
    _, sub = jax.random.split(js.rng)
    noise = jax.random.normal(sub, js.velocities.shape, jnp.float32)
    got, tf1, _ = tlangevin.baoab_step(ts, tf, (), tnb.force_fn, 0.004, 2.0, 1.0, torch.from_numpy(np.array(noise)))
    _assert_states_close(got, want)
    np.testing.assert_allclose(tf1.numpy(), np.asarray(jf1), rtol=1e-4, atol=ATOL)
    _, _, traj = tlangevin.nvt_rollout(ts, (), tnb.force_fn, 0.004, 2.0, 1.0, 20, record_every=5)
    assert traj.kinetic_energy.shape == (4,) and traj.potential_energy is None


def test_csvr_step_on_jax_draws():
    """`csvr_rescale` on the draws JAX's `bussi_step` makes (bussi.py:
    37-40, 93), after the port's velocity-Verlet step, against that step."""
    js, ts, jnb, tnb = _system(216, 0.7, "allpairs", temperature=0.6)
    jf, _ = jnb.force_fn(js.positions, js.box, ())
    tf, _ = tnb.force_fn(ts.positions, ts.box, ())
    want, _, _ = jbussi.bussi_step(js, jf, (), jnb.force_fn, 0.004, 0.2, 1.0)
    _, sub = jax.random.split(js.rng)
    k1, k2 = jax.random.split(sub)
    ndof = 3 * 216 - 3
    r1 = torch.tensor(float(jax.random.normal(k1, (), jnp.float32)))
    sum_r2 = torch.tensor(float(2.0 * jax.random.gamma(k2, 0.5 * (ndof - 1.0), dtype=jnp.float32)))
    got, _, _ = tverlet.velocity_verlet_step(ts, tf, (), tnb.force_fn, 0.004)
    got = tbussi.csvr_rescale(got, r1, sum_r2, 0.004, 0.2, 1.0)
    _assert_states_close(got, want, atol=1e-5)
    assert not np.allclose(want.velocities, jverlet.velocity_verlet_step(js, jf, (), jnb.force_fn, 0.004)[0].velocities)
    end, _ = tbussi.csvr_rollout(ts, (), tnb.force_fn, 0.004, 0.2, 1.0, 5)
    assert int(end.step) == 5


def test_berendsen_npt_step_matches_jax():
    """Berendsen NPT on the all-pairs path (the box as the force pass's
    operand): three steps and the boxes against JAX's `npt_rollout`."""
    n = 216
    js, ts, _, _ = _system(n, 0.9, "allpairs")
    jmodel, jparams = JModel.create(2.5, 2.0), jlj(np.ones(n), np.ones(n))
    tmodel, tparams = TModel.create(2.5, 2.0, device="cpu"), tlj(np.ones(n), np.ones(n), device="cpu")

    def jforce(p, b, aux):
        return jax_allpairs(p, b, jmodel, jparams, outputs=1).forces, aux

    def jvirial(p, b, aux):
        return jnp.sum(jax_allpairs(p, b, jmodel, jparams, outputs=4).virials)

    def tforce(p, b, aux):
        return compute_nonbonded_allpairs(p, b, tmodel, tparams, outputs=FORCES).forces, aux

    def tvirial(p, b, aux):
        return torch.sum(compute_nonbonded_allpairs(p, b, tmodel, tparams, outputs=VIRIALS).virials)

    p0 = float(tnpt.instantaneous_pressure(ts, tvirial(ts.positions, ts.box, ())))
    assert p0 == pytest.approx(float(jnpt.instantaneous_pressure(js, jvirial(js.positions, js.box, ()))), rel=1e-5)
    want, _, jboxes = jnpt.npt_rollout(js, (), jforce, jvirial, 0.004, 0.5, 1.0, 3, kappa=0.3)
    got, _, tboxes = tnpt.npt_rollout(ts, (), tforce, tvirial, 0.004, 0.5, 1.0, 3, kappa=0.3)
    _assert_states_close(got, want)
    np.testing.assert_allclose(tboxes.numpy(), np.asarray(jboxes), rtol=1e-6)
    assert float(tboxes[-1]) > float(ts.box)  # compressed start: the box grows


def test_fire_matches_jax():
    """50 FIRE steps (best-visited positions, the max-|F| history) against
    JAX's `fire_minimize`."""
    js, ts, jnb, tnb = _system(216, 0.8, "allpairs", jitter=0.12, temperature=0.0)
    config = jmin.FireConfig(dt_start=0.001, dt_max=0.008)
    want, _, jhist = jmin.fire_minimize(js, (), jnb.force_fn, 50, config)
    got, _, thist = tmin.fire_minimize(ts, (), tnb.force_fn, 50, tmin.FireConfig(dt_start=0.001, dt_max=0.008))
    np.testing.assert_allclose(thist.numpy(), np.asarray(jhist), rtol=1e-4, atol=ATOL)
    _assert_states_close(got, want)
    assert float(thist[-1]) < 0.5 * float(thist[0])


def test_observables_match_jax():
    js, ts, jnb, tnb = _system(216, 0.7, "allpairs")
    out, jout = tnb.compute(ts.positions, ()), jnb.compute(js.positions, ())
    w, pe = out.virials.sum(), out.energies.sum()
    jw, jpe = jnp.sum(jout.virials), jnp.sum(jout.energies)
    pairs = ((tobs.kinetic_energy(ts), jobs.kinetic_energy(js)), (tobs.temperature(ts), jobs.temperature(js)),
             (tobs.pressure(ts, w), jobs.pressure(js, jw)), (tobs.total_energy(ts, pe), jobs.total_energy(js, jpe)))
    for got, want in pairs:
        assert float(got) == pytest.approx(float(want), rel=1e-5)
    e = np.array([-100.0, -100.2, -99.9, -100.05], np.float32)
    assert float(tobs.energy_drift(torch.from_numpy(e))) == pytest.approx(float(jobs.energy_drift(jnp.asarray(e))))


def test_stochastic_steps_need_an_rng():
    _, ts, _, tnb = _system(27, 0.3, "allpairs")
    ts = ts._replace(rng=None)
    f, _ = tnb.force_fn(ts.positions, ts.box, ())
    with pytest.raises(ValueError, match="rng"):
        tbussi.bussi_step(ts, f, (), tnb.force_fn, 0.002, 0.5, 1.0)
    with pytest.raises(ValueError, match="rng"):
        tlangevin.langevin_baoab_step(ts, f, (), tnb.force_fn, 0.002, 1.0, 1.0)


# ---------------------------------------------------------------------------
# The port's dense engine against the port's all-pairs
# ---------------------------------------------------------------------------


def _dense_setup(n, density, seed, skin=0.4, spill=False, jitter=0.15):
    pos, box = cubic_lattice(n, density, jitter=jitter, seed=seed)
    vel = maxwell_boltzmann(n, 1.0, seed=seed + 1)
    params = tlj(np.ones(n), np.ones(n), device="cpu")
    config = tcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=skin, spill=spill)
    nb = tapi.make_force_fn(tapi.NonbondedConfig(cutoff=2.5, switch=2.0, method="allpairs"), params, box, n,
                            device="cpu")
    return pos, vel, box, params, config, nb


def test_dense_forces_match_allpairs():
    """tests/test_cell_dense.py:32 on the port: the dense engine's per-slot
    forces, energies and virials by atom against the port's all-pairs."""
    pos, vel, box, params, config, nb = _dense_setup(1728, 0.6, 11)
    n = len(pos)
    st = tcd.cell_dense_init(pos, vel, np.ones(n), params, config, device="cpu")
    assert not bool(st.overflow)
    forces, e, w = tcd.cell_dense_forces(st, TModel.create(2.5, 2.0, device="cpu"), config, compute_energy=True)
    ref = nb.compute(torch.from_numpy(pos.astype(np.float32)), ())
    ids = st.atom_id.reshape(-1)[st.valid.reshape(-1)].long()
    for got, want in ((forces, ref.forces), (e, ref.energies), (w, ref.virials)):
        by_atom = torch.zeros_like(want)
        by_atom[ids] = got.reshape((-1,) + tuple(want.shape[1:]))[st.valid.reshape(-1)]
        np.testing.assert_allclose(by_atom.numpy(), want.numpy(), rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("spill", [False, True])
def test_dense_rollout_matches_allpairs_trajectory(spill):
    """tests/test_cell_dense.py:60 (1,000 atoms, 50 steps) and :210 (the
    spill config, 1,728 atoms, 60 steps, rebin every 5) on the port: the
    dense engine against `nve_rollout` on the port's all-pairs, the same
    step count on both sides, positions modulo L and velocities at 5e-4."""
    if spill:
        pos, vel, box, params, config, nb = _dense_setup(1728, 0.75, 9, skin=0.3, spill=True, jitter=0.12)
        steps, kw = 60, dict(rebin_every=5)
        assert config.spill and config.cell_side > 2.5 + config.skin
    else:
        pos, vel, box, params, config, nb = _dense_setup(1000, 0.5, 11)
        steps, kw = 50, {}
    n = len(pos)
    rollout, _ = tcd.make_cell_dense_sim(config, TModel.create(2.5, 2.0, device="cpu"), dt=0.002)
    st = tcd.cell_dense_init(pos, vel, np.ones(n), params, config, device="cpu")
    assert not bool(st.overflow)
    st = rollout(st, num_steps=steps, **kw)
    assert not bool(st.overflow) and int(st.valid.sum()) == n
    pos_d, vel_d = tcd.gather_dense_atoms(st, n)
    ref, _, _ = tverlet.nve_rollout(make_state(pos, vel, box=box, device="cpu"), (), nb.force_fn, 0.002, steps)
    assert int(ref.step) == steps == int(st.step)
    np.testing.assert_allclose(pos_d % box, ref.positions.numpy() % box, atol=5e-4)
    np.testing.assert_allclose(vel_d, ref.velocities.numpy(), atol=5e-4)
