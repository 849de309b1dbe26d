"""The slice as a whole: the port's `make_cell_dense_sim` against the JAX
package's over 24 steps with a rebin every 6 — the stacked per-atom
leapfrog (the README quickstart) against JAX's XLA backend, and the
component carry (bench.py's path) against JAX's interpret-mode kernels —
plus the energy closure and bitwise reruns.  Tolerances are those of
tests/test_cell_dense.py:333-335: the two packages run the same integrator
op for op, with the force pass's rounding differing at float32 roundoff."""

import numpy as np
import pytest
import torch

from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel
from torch_port_utils import lj_setup, to_port

torch.set_num_threads(2)

STEPS, REBIN_EVERY, DT = 24, 6, 0.004


def _compare(jax_sim, port_sim, st, n):
    (jroll, jenergy), (troll, tenergy) = jax_sim, port_sim
    ja = jroll(st, num_steps=STEPS, rebin_every=REBIN_EVERY)
    ta = troll(to_port(st), num_steps=STEPS, rebin_every=REBIN_EVERY)
    assert not bool(ja.overflow) and not bool(ta.overflow)
    assert int(ta.step) == int(ja.step) == STEPS
    np.testing.assert_array_equal(ta.atom_id.numpy(), np.asarray(ja.atom_id))
    pj, vj = jcd.gather_dense_atoms(ja, n)
    pt, vt = tcd.gather_dense_atoms(ta, n)
    np.testing.assert_allclose(pt, pj, atol=2e-5)
    np.testing.assert_allclose(vt, vj, atol=2e-4)
    # Energy closure on the final states, and on the identical start state.
    for js, ts in ((ja, ta), (st, to_port(st))):
        pe_j, vir_j, ke_j = (float(x) for x in jenergy(js))
        pe_t, vir_t, ke_t = (float(x) for x in tenergy(ts))
        assert abs(pe_t - pe_j) / abs(pe_j) < 1e-5
        assert abs(ke_t - ke_j) / abs(ke_j) < 1e-5
        assert abs(vir_t - vir_j) / abs(vir_j) < 1e-4
    # Two port rollouts from the same state are bitwise equal.
    tb = troll(to_port(st), num_steps=STEPS, rebin_every=REBIN_EVERY)
    for name in ta._fields:
        if getattr(ta, name) is not None or getattr(tb, name) is not None:
            assert torch.equal(getattr(ta, name), getattr(tb, name)), name


def test_stacked_per_atom_matches_jax_xla():
    pos, vel, params, config, model = lj_setup(1000, 0.6, seed=11, varied=True, skin=0.4)
    st = jcd.cell_dense_init(pos, vel, np.ones(len(pos)), params, config)
    _compare(
        jcd.make_cell_dense_sim(config, model, dt=DT, backend="xla"),
        tcd.make_cell_dense_sim(config, LennardJonesModel.create(2.5, 2.0, device="cpu"), dt=DT),
        st, len(pos),
    )


def test_component_carry_matches_jax_kernels():
    pos, vel, params, config, model = lj_setup(1000, 0.6, seed=11, skin=0.4)
    st = jcd.cell_dense_init(pos, vel, np.ones(len(pos)), params, config)
    uni = jcd.detect_uniform_params(params)
    _compare(
        jcd.make_cell_dense_sim(
            config, model, dt=DT, backend="pallas_interpret", uniform_params=uni, uniform_mass=1.0
        ),
        tcd.make_cell_dense_sim(
            config, LennardJonesModel.create(2.5, 2.0, device="cpu"), dt=DT, uniform_params=uni, uniform_mass=1.0
        ),
        st, len(pos),
    )


def test_unported_options_raise():
    """What the port still refuses: `dense_sim_from_system` on a System
    without a periodic box or with a non-cubic one (as the reference does),
    and the straggler engine on a spill config; an unknown backend, rebin,
    thermostat or barostat is a ValueError.  A state's charges now cross
    from JAX bit for bit."""
    from emdee_tpu_torch.modelling.system import System
    from emdee_tpu_torch.neighbors import cell_dense_molecular as tmol
    from emdee_tpu_torch.neighbors import cell_dense_straggler as tsd

    pos, vel, params, config, _ = lj_setup(864, 0.5, seed=3)
    model = LennardJonesModel.create(2.5, 2.0, device="cpu")
    system = System(names=["AR"] * 4, resnames=["UNK"], residue_spans=[(0, 4)], positions=np.eye(4, 3),
                    velocities=np.zeros((4, 3)), masses=np.ones(4), bonds=[], ff_types=[""] * 4,
                    charges=np.zeros(4), box_lengths=None)
    with pytest.raises(ValueError, match="no periodic box"):
        tmol.dense_sim_from_system(system, cutoff=2.5, switch=2.0, dt=DT, device="cpu")
    system.box_lengths = np.array([10.0, 10.0, 12.0])
    with pytest.raises(NotImplementedError, match="non-cubic"):
        tmol.dense_sim_from_system(system, cutoff=2.5, switch=2.0, dt=DT, device="cpu")
    for kw in ({"backend": "pallas"}, {"rebin": "shift_xla"}, {"thermostat": object()},
               {"barostat": object()}):
        with pytest.raises(ValueError):
            tcd.make_cell_dense_sim(config, model, dt=DT, **kw)
    with pytest.raises(ValueError, match="spill"):
        tcd.make_cell_dense_sim(config._replace(spill=True), model, dt=DT,
                                barostat=tcd.BerendsenBarostatConfig(0.5, 0.4))
    q = np.where(np.arange(len(pos)) % 2 == 0, 0.3, -0.3).astype(np.float32)
    js = jcd.cell_dense_init(pos, vel, np.ones(len(pos)), params, config, charges=q)
    st = to_port(js)
    np.testing.assert_array_equal(tcd.state_to_numpy(st)["charges"], np.asarray(js.charges))
    sconfig = tsd.StragglerConfig(config._replace(spill=True), config.capacity + 8, 64, 32)
    with pytest.raises(ValueError, match="spill"):
        tsd.make_straggler_sim(sconfig, model, dt=DT, uniform_params=(0.5, 2.0))


@pytest.mark.full
def test_nve_drift_1e6_f64_measured():
    """tests/test_fidelity.py's full-tier gate on the port's dense engine
    (the plain stacked leapfrog, `backend="torch"`), from the port's own
    start and settle: FCC 14³ = 10,976 atoms at T* 0.7, settled 300 steps
    at dt = 0.004, then 500 at dt = 0.002; NVE drift ≤ 1e-6 of KE with the
    energies measured in float64 by tests/oracle.py's all-pairs sum over
    the float32 trajectory."""
    from tests.oracle import allpairs_oracle

    from emdee_tpu_torch.utils.lattice import fcc_lattice, maxwell_boltzmann

    pos, box = fcc_lattice(14, density=0.8442)
    n = pos.shape[0]
    vel = maxwell_boltzmann(n, 0.7, seed=0)
    config = tcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.3)
    model = LennardJonesModel.create(2.5, 2.0, device="cpu")
    params = tcd.lj_params_from_numpy((0.5 * np.ones(n), 2.0 * np.ones(n)), "cpu")
    settle, _ = tcd.make_cell_dense_sim(config, model, dt=0.004, backend="torch")
    state = settle(tcd.cell_dense_init(pos, vel, np.ones(n), params, config, device="cpu"), num_steps=300,
                   rebin_every=3)
    assert not bool(state.overflow)

    def e_f64(st):
        p, v = tcd.gather_dense_atoms(st, n)
        _, e, _ = allpairs_oracle(p.astype(np.float64), float(box), 2.5, 2.0, 0.5 * np.ones(n), 2.0 * np.ones(n))
        return float(e.sum()), 0.5 * float((v.astype(np.float64) ** 2).sum())

    run, _ = tcd.make_cell_dense_sim(config, model, dt=0.002, backend="torch")
    pe0, ke0 = e_f64(state)
    out = run(state, num_steps=500, rebin_every=4)
    assert not bool(out.overflow)
    pe1, ke1 = e_f64(out)
    drift = abs((pe1 + ke1) - (pe0 + ke0)) / ke0
    assert drift < 1.0e-6, drift
