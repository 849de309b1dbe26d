"""The slice as a whole: the port's `make_cell_dense_sim` against the JAX
package's over 24 steps with a rebin every 6 — the stacked per-atom
leapfrog (the README quickstart) against JAX's XLA backend, and the
component carry (bench.py's path) against JAX's interpret-mode kernels —
plus the energy closure and bitwise reruns.  Tolerances are those of
tests/test_cell_dense.py:333-335: the two packages run the same integrator
op for op, with the force pass's rounding differing at float32 roundoff."""

import jax
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
        assert torch.equal(getattr(ta, name), getattr(tb, name)), name


def test_stacked_per_atom_matches_jax_xla():
    pos, vel, params, config, model = lj_setup(1000, 0.6, seed=11, varied=True, skin=0.4)
    st = jcd.cell_dense_init(pos, vel, np.ones(len(pos)), params, config)
    _compare(
        jcd.make_cell_dense_sim(config, model, dt=DT, backend="xla"),
        tcd.make_cell_dense_sim(config, LennardJonesModel.create(2.5, 2.0), dt=DT),
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
            config, LennardJonesModel.create(2.5, 2.0), dt=DT, uniform_params=uni, uniform_mass=1.0
        ),
        st, len(pos),
    )


def test_unported_options_raise():
    pos, vel, params, config, _ = lj_setup(864, 0.5, seed=3)
    model = LennardJonesModel.create(2.5, 2.0)
    for kw in ({"thermostat": jcd.CSVRConfig(1.0, 0.1)}, {"coulomb": object()},
               {"aux_fn": len}, {"barostat": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP item"):
            tcd.make_cell_dense_sim(config, model, dt=DT, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP item"):
        tcd.make_cell_dense_sim(config._replace(spill=True), model, dt=DT)
    roll, _ = tcd.make_cell_dense_sim(config, model, dt=DT)
    st = to_port(jcd.cell_dense_init(pos, vel, np.ones(len(pos)), params, config))
    with pytest.raises(NotImplementedError, match="ROADMAP item"):
        roll(st, num_steps=6, record=True)
    with pytest.raises(ValueError):
        tcd.make_cell_dense_sim(config, model, dt=DT, backend="pallas")
    with pytest.raises(NotImplementedError):
        tcd.state_from_numpy({**jax.device_get(st)._asdict(), "charges": np.zeros(3)}, "cpu")
