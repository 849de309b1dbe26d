"""The slice as a whole: the port's `make_cell_dense_sim` against the JAX
package's over 24 steps with a rebin every 6 — the stacked per-atom
leapfrog (the README quickstart) against JAX's XLA backend, and the
component carry (bench.py's path) against JAX's interpret-mode kernels —
plus the energy closure and bitwise reruns.  Tolerances are those of
tests/test_cell_dense.py:333-335: the two packages run the same integrator
op for op, with the force pass's rounding differing at float32 roundoff."""

import os

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


# The line-fit drift window: 2,000 steps at dt = 0.002, sampled every 20.
WINDOW, EVERY = 2000, 20


def _total_f64(p, v, box):
    """Total energy (unit LJ, rc 2.5σ, switch 2.0σ, unit masses) in float64:
    tests/oracle.py's minimum image and pair math over the pairs that a
    periodic k-d tree finds within the cutoff (a pair beyond it adds an
    exact 0 in the oracle), and the kinetic energy.  Returns (total, ke)."""
    from scipy.spatial import cKDTree

    from tests.oracle import lj_interaction_f64

    p = np.asarray(p, np.float64)
    w = p - box * np.floor(p / box)
    w = np.where(w >= box, w - box, w)
    i, j = cKDTree(w, boxsize=box).query_pairs(2.5, output_type="ndarray").T
    s = p / box
    ds = s[i] - s[j]
    rv = box * (ds - np.round(ds))
    e, _ = lj_interaction_f64(np.sum(rv * rv, axis=1), 2.5, 2.0, 0.5, 2.0, 0.5, 2.0)
    ke = 0.5 * float(np.sum(np.asarray(v, np.float64) ** 2))
    return float(np.sum(e)) + ke, ke


@pytest.mark.full
def test_nve_drift_line_1e6_f64():
    """The 1e-6 NVE drift target of test_nve_drift_1e6_f64_measured, read
    so that the total energy's swing about its trend does not decide it.

    Both packages start from the reference test's settled state
    (tests/test_fidelity.py:79-90: FCC 14³ = 10,976 atoms at T* 0.7,
    `maxwell_boltzmann(seed=0)`, 300 steps of JAX's `backend="xla"` at dt =
    0.004 rebinning every 3), handed to the port bit for bit.  Each then
    runs 2,000 steps at dt = 0.002 rebinning every 4 — JAX's `xla` and the
    port's plain stacked leapfrog (`backend="torch"`) — in calls of 20
    steps, the float64 total energy sampled after each (`_total_f64`, held
    to tests/oracle.py's all-pairs sum at the start within 1e-12).
    Statistic (`tools.drift.drift_line`): the least-squares line's rise
    over 500 steps (the reference test's window), the end-tenth means'
    difference and the std about the line, as fractions of the start's KE.
    Gates: the port's |rise| ≤ 1e-6, and its swing within a factor 2 of
    JAX's (the same quantity measured on both); the numbers of both
    packages are printed.  The port's torch threads: the host's cores over
    the xdist workers (all of them when run alone, ~10 minutes)."""
    from emdee_tpu.potentials.lennard_jones import LennardJonesModel as JModel
    from emdee_tpu.potentials.lennard_jones import lennard_jones_atom as jlj
    from emdee_tpu.utils.lattice import fcc_lattice, maxwell_boltzmann
    from emdee_tpu_torch.tools.drift import drift_line
    from tests.oracle import allpairs_oracle

    pos, box = fcc_lattice(14, density=0.8442)
    n = pos.shape[0]
    box = float(box)
    config = jcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.3)
    jmodel = JModel.create(2.5, 2.0)
    settle, _ = jcd.make_cell_dense_sim(config, jmodel, dt=0.004, backend="xla")
    start = settle(jcd.cell_dense_init(pos, maxwell_boltzmann(n, 0.7, seed=0), np.ones(n), jlj(np.ones(n), np.ones(n)),
                                       config), num_steps=300, rebin_every=3)
    assert not bool(start.overflow)
    p0, v0 = jcd.gather_dense_atoms(start, n)
    e0, ke0 = _total_f64(p0, v0, box)
    _, e_atoms, _ = allpairs_oracle(p0.astype(np.float64), box, 2.5, 2.0, 0.5 * np.ones(n), 2.0 * np.ones(n))
    assert abs((e0 - ke0) - float(e_atoms.sum())) <= 1e-12 * abs(float(e_atoms.sum()))

    runs = {
        "jax": (jcd.make_cell_dense_sim(config, jmodel, dt=0.002, backend="xla")[0], start, jcd.gather_dense_atoms),
        "port": (tcd.make_cell_dense_sim(config, LennardJonesModel.create(2.5, 2.0, device="cpu"), dt=0.002,
                                         backend="torch")[0], to_port(start), tcd.gather_dense_atoms),
    }
    stats = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(max(threads, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))
    try:
        for name, (run, st, gather) in runs.items():
            steps, energies = [0], [e0]
            for k in range(1, WINDOW // EVERY + 1):
                st = run(st, num_steps=EVERY, rebin_every=4)
                steps.append(k * EVERY)
                energies.append(_total_f64(*gather(st, n), box)[0])
            assert not bool(st.overflow), name
            stats[name] = drift_line(steps, energies, ke0)
    finally:
        torch.set_num_threads(threads)
    print("; ".join(f"{name}: rise over 500 steps {r:.3e}, end-tenth means {m:.3e}, std about the line {s:.3e}"
                    for name, (r, m, s) in stats.items()))
    assert abs(stats["port"][0]) <= 1.0e-6, stats
    assert 0.5 <= stats["port"][2] / stats["jax"][2] <= 2.0, stats
