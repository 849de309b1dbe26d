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
    """What the port still refuses: the atom-space exclusion correction
    (ROADMAP item 3), `dense_sim_from_system` (item 9) and the straggler
    engine on a spill config; an unknown backend, rebin, thermostat or
    barostat is a ValueError.  A state's charges now cross from JAX bit for bit."""
    from emdee_tpu_torch.neighbors import cell_dense_molecular as tmol
    from emdee_tpu_torch.neighbors import cell_dense_straggler as tsd

    pos, vel, params, config, _ = lj_setup(864, 0.5, seed=3)
    model = LennardJonesModel.create(2.5, 2.0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
        tmol.make_molecular_dense_sim(config, model, DT, len(pos), params=params,
                                      exclusion_pairs=np.array([[0, 1]]), exclusion_mode="correction")
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        tmol.dense_sim_from_system(None, cutoff=2.5, switch=2.0, dt=DT)
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
