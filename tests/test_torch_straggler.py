"""The port's C-tight straggler engine (`emdee_tpu_torch.neighbors.
cell_dense_straggler`, K3's plain version in `straggler_kernel`) against the
JAX package's, on the CPU.

Fixture: a jittered simple-cubic lattice of 2,048 atoms at ρ* = 0.8442
(M = 4 cells per side), with C_t two below the largest cell occupancy so
that a real tail parks, as in tests/test_straggler.py:54-66, but without
the JAX equilibration.  The reference's K3 runs only in interpret mode
(Mosaic miscompiles the tile), so the kernel pass is held against
`backend="pallas_interpret", strag_pass="kernel"` and the gather pass
against `("pallas_interpret", "xla")`.  Tolerances are those of
tests/test_torch_cell_dense_sim.py: positions 2e-5, velocities 2e-4, PE and
KE 1e-5 relative; the aux bookkeeping is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.neighbors import cell_dense_straggler as jsd
from emdee_tpu.potentials.lennard_jones import LennardJonesModel as JModel
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom as jlj
from emdee_tpu.utils.lattice import cubic_lattice, maxwell_boltzmann
from emdee_tpu_torch.neighbors import cell_dense_straggler as tsd
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel as TModel
from emdee_tpu_torch.potentials.lennard_jones import lennard_jones_atom as tlj
from torch_port_utils import bits

torch.set_num_threads(2)

N, DT, STEPS, REBIN_EVERY = 2048, 0.003, 24, 6
UNI = (0.5, 2.0)
JMODEL = JModel.create(2.5, 2.0)
TMODEL = TModel.create(2.5, 2.0, device="cpu")


@pytest.fixture(scope="module")
def setup():
    """(positions, velocities, config, JAX state, port state)."""
    pos, box = cubic_lattice(N, 0.8442, jitter=0.1, seed=7)
    vel = maxwell_boltzmann(N, 0.8, seed=8)
    wide = jcd.suggest_cell_dense_config(N, box, cutoff=2.5, switch=2.0, skin=0.35)
    occ = np.asarray(jcd.cell_dense_init(pos, vel, np.ones(N), jlj(np.ones(N), np.ones(N)), wide).valid).sum(1)
    config = jsd.StragglerConfig(
        grid=wide._replace(capacity=int(occ.max()) - 2),
        wide_capacity=wide.capacity + 8,
        aux_capacity=64,
        kn=48,  # at M = 4 a 9-hood spans over half the box
    )
    js = jsd.straggler_init(pos, vel, np.ones(N), jlj(np.ones(N), np.ones(N)), config)
    ts = tsd.straggler_init(pos, vel, np.ones(N), tlj(np.ones(N), np.ones(N), device="cpu"), config, device="cpu")
    return pos, vel, config, js, ts


def _assert_bitequal(jax_state, port_state):
    ref = jax.device_get(jax_state)._asdict()
    got = tsd.straggler_state_to_numpy(port_state)
    for name, a in got["grid"].items():
        np.testing.assert_array_equal(bits(a), bits(getattr(ref["grid"], name)), err_msg=name)
    for name in tsd._AUX_DTYPES:
        np.testing.assert_array_equal(bits(got[name]), bits(ref[name]), err_msg=name)


def _parked(state, config):
    return int((np.asarray(state.aux_cell) < config.grid.num_cells).sum())


def _atom_forces(fg, fa, state, config):
    """Grid (3, M³, C_t) and aux (3, A) forces → (N, 3) in atom order."""
    out = np.zeros((N, 3), np.float32)
    keep = state.grid.valid.numpy().reshape(-1)
    out[state.grid.atom_id.numpy().reshape(-1)[keep]] = fg.permute(1, 2, 0).numpy().reshape(-1, 3)[keep]
    akeep = state.aux_cell.numpy() < config.grid.num_cells
    out[state.aux_atom_id.numpy()[akeep]] = fa.t().numpy()[akeep]
    return out


def test_init_bitexact_and_roundtrip(setup):
    """Every grid and aux field of `straggler_init` equals JAX's bit for bit,
    with a real parked tail; a JAX state crosses to the port and back."""
    _, _, config, js, ts = setup
    _assert_bitequal(js, ts)
    assert _parked(ts, config) >= 5 and not bool(ts.grid.overflow)
    fields = tsd.straggler_state_to_numpy(tsd.straggler_state_from_numpy(jax.device_get(js)._asdict(), "cpu"))
    back = jsd.StragglerState(grid=jcd.CellDenseState(**fields.pop("grid")), **fields)
    _assert_bitequal(back, ts)


@pytest.mark.parametrize("kn", [48, 2])
def test_bindings_match_jax(setup, kn):
    """The (M², Kn) list table equals the reference's one-hot O (argmax over
    A, −1 where a row's list is empty), and the Kn flags agree — tripped at
    Kn = 2."""
    _, _, config, js, ts = setup
    config = config._replace(kn=kn)
    m, nc = config.grid.cells_per_dim, config.grid.num_cells
    o, _, ref_flag = jsd._bindings(
        js.aux_cell, js.aux_cell < nc, config, jnp.asarray(jsd._hood_matrix(m))
    )
    o = np.asarray(o.astype(jnp.float32))
    ref = np.where(o.sum(axis=2) > 0, o.argmax(axis=2), -1)
    table, flag = tsd._bindings(ts.aux_cell, ts.aux_cell < nc, config, tsd._hood_matrix(m, "cpu"))
    np.testing.assert_array_equal(table.numpy(), ref)
    assert bool(flag) == bool(ref_flag) == (kn == 2)
    assert (table.numpy() >= 0).sum() > 0


@pytest.mark.parametrize("strag_pass", ["kernel", "xla"])
def test_forces_match_wide_state(setup, strag_pass):
    """Grid + aux forces of the straggler state, gathered to atom order,
    against the JAX `cell_dense_forces` of its wide state at C_w, elementwise
    within 1e-4 of the force scale (measured: 1.1e-5 for both passes).  The
    reference's own gate probes forces through a dt difference at 5e-3."""
    _, _, config, js, ts = setup
    roll, _ = tsd.make_straggler_sim(config, TMODEL, dt=DT, uniform_params=UNI, strag_pass=strag_pass)
    fg, fa, knovf = roll.forces(ts)
    assert not bool(knovf)
    wide = jsd.make_straggler_sim(
        config, JMODEL, dt=DT, uniform_params=UNI, backend="pallas_interpret", strag_pass="kernel"
    )[0].wide_state(js)
    f_ref = np.asarray(jcd.cell_dense_forces(wide, JMODEL, config.wide)[0]).reshape(-1, 3)
    ref = np.zeros((N, 3), np.float32)
    keep = np.asarray(wide.valid).reshape(-1)
    ref[np.asarray(wide.atom_id).reshape(-1)[keep]] = f_ref[keep]
    got = _atom_forces(fg, fa, ts, config)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-4 * scale
    assert (fg[:, ~ts.grid.valid] == 0).all() and (fa[:, ts.aux_cell >= config.grid.num_cells] == 0).all()
    # The port's wide state equals JAX's bit for bit.
    tw = roll.wide_state(ts)
    for name in ("positions", "velocities", "atom_id", "valid"):
        np.testing.assert_array_equal(bits(getattr(tw, name).numpy()), bits(getattr(wide, name)), err_msg=name)


@pytest.mark.parametrize("strag_pass", ["kernel", "xla"])
def test_rollout_matches_jax(setup, strag_pass):
    """24 steps at a rebin every 6 against the matching JAX run: positions,
    velocities, energies within the dense slice's tolerances; grid atom ids
    and the aux bookkeeping exactly equal; two port runs bitwise equal."""
    _, _, config, js, ts = setup
    jroll, jenergy = jsd.make_straggler_sim(
        config, JMODEL, dt=DT, uniform_params=UNI, uniform_mass=1.0,
        backend="pallas_interpret", strag_pass=strag_pass,
    )
    troll, tenergy = tsd.make_straggler_sim(config, TMODEL, dt=DT, uniform_params=UNI, strag_pass=strag_pass)
    ja = jroll(js, num_steps=STEPS, rebin_every=REBIN_EVERY)
    ta = troll(ts, num_steps=STEPS, rebin_every=REBIN_EVERY)
    assert not bool(ja.grid.overflow) and not bool(ta.grid.overflow)
    assert int(ta.grid.step) == int(ja.grid.step) == STEPS
    np.testing.assert_array_equal(ta.grid.atom_id.numpy(), np.asarray(ja.grid.atom_id))
    for name in ("aux_atom_id", "aux_cell", "aux_rank"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(), np.asarray(getattr(ja, name)), err_msg=name)
    assert _parked(ta, config) >= 1
    pj, vj = jsd.gather_straggler_atoms(ja, config, N)
    pt, vt = tsd.gather_straggler_atoms(ta, config, N)
    np.testing.assert_allclose(pt, pj, atol=2e-5)
    np.testing.assert_allclose(vt, vj, atol=2e-4)
    for jst, tst in ((ja, ta), (js, ts)):
        pe_j, vir_j, ke_j = (float(x) for x in jenergy(jst))
        pe_t, vir_t, ke_t = (float(x) for x in tenergy(tst))
        assert abs(pe_t - pe_j) / abs(pe_j) < 1e-5
        assert abs(ke_t - ke_j) / abs(ke_j) < 1e-5
        assert abs(vir_t - vir_j) / abs(vir_j) < 1e-4
    tb = troll(ts, num_steps=STEPS, rebin_every=REBIN_EVERY)
    a, b = tsd.straggler_state_to_numpy(ta), tsd.straggler_state_to_numpy(tb)
    for name in tsd._AUX_DTYPES:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    for name in a["grid"]:
        np.testing.assert_array_equal(a["grid"][name], b["grid"][name], err_msg=name)


def test_flags_trip(setup):
    """Too small a Kn trips the sticky flag in the rollout, and too small an
    A at init, on both sides (the reference checks this in its full tier)."""
    pos, vel, config, _, ts = setup
    roll, _ = tsd.make_straggler_sim(config._replace(kn=2), TMODEL, dt=DT, uniform_params=UNI)
    assert bool(roll(ts, num_steps=2, rebin_every=2).grid.overflow)
    tiny = config._replace(aux_capacity=2)
    j = jsd.straggler_init(pos, vel, np.ones(N), jlj(np.ones(N), np.ones(N)), tiny)
    t = tsd.straggler_init(pos, vel, np.ones(N), tlj(np.ones(N), np.ones(N), device="cpu"), tiny, device="cpu")
    assert bool(j.grid.overflow) and bool(t.grid.overflow)
    _assert_bitequal(j, t)


def test_config_and_options():
    """`suggest_straggler_config` equals JAX's; the resident TPU backend and
    an unknown pass are refused, the reference's streaming name is taken
    with the gather pass only."""
    for args in ((100_000, 48.7, 2.5, 2.0), (97_556, 48.37, 2.5, 2.0, 0.35, None, None, 64, 16)):
        cfg = tsd.suggest_straggler_config(*args)
        assert cfg == jsd.suggest_straggler_config(*args)
        assert cfg.sentinel == cfg.wide.num_slots and cfg.grid.capacity < cfg.wide_capacity
    cfg = tsd.suggest_straggler_config(2048, 13.4, 2.5, 2.0)
    tsd.make_straggler_sim(cfg, TMODEL, dt=DT, uniform_params=UNI, backend="pallas_streaming")
    with pytest.raises(ValueError, match="resident"):
        tsd.make_straggler_sim(cfg, TMODEL, dt=DT, uniform_params=UNI, backend="pallas_streaming", strag_pass="kernel")
    for kw in ({"backend": "pallas"}, {"strag_pass": "tile"}):
        with pytest.raises(ValueError):
            tsd.make_straggler_sim(cfg, TMODEL, dt=DT, uniform_params=UNI, **kw)
    with pytest.raises(ValueError, match="spill"):
        tsd.make_straggler_sim(cfg._replace(grid=cfg.grid._replace(spill=True)), TMODEL, dt=DT, uniform_params=UNI)


@pytest.mark.parametrize("backend", ["cuda_streaming", "streaming", "pallas_streaming_interpret"])
def test_streaming_backends_refused(setup, backend):
    """Every streaming backend name builds the engine, whose 'auto' pass is
    the gather pass, and refuses the K3 pass with the reference's
    ValueError; on the CPU a name that may run plain runs, and
    `cuda_streaming` refuses CPU tensors."""
    config, ts = setup[2], setup[4]
    with pytest.raises(ValueError, match="resident"):
        tsd.make_straggler_sim(config, TMODEL, dt=DT, uniform_params=UNI, backend=backend, strag_pass="kernel")
    roll, _ = tsd.make_straggler_sim(config, TMODEL, dt=DT, uniform_params=UNI, backend=backend)
    if backend == "cuda_streaming":
        with pytest.raises(ValueError, match="CUDA"):
            roll.forces(ts)
    else:
        fg, fa, knovf = roll.forces(ts)
        ref = tsd.make_straggler_sim(config, TMODEL, dt=DT, uniform_params=UNI, strag_pass="xla")[0].forces(ts)
        scale = float(ref[0].abs().max())
        assert not bool(knovf) and float((fg - ref[0]).abs().max()) <= 1e-5 * scale
        assert float((fa - ref[1]).abs().max()) <= 1e-5 * scale


@pytest.fixture(scope="module")
def streaming_run(setup):
    """The port's 24-step run on the streaming family's plain version
    ('pallas_streaming_interpret' → 'torch_streaming')."""
    _, _, config, _, ts = setup
    roll, _ = tsd.make_straggler_sim(config, TMODEL, dt=DT, uniform_params=UNI, backend="pallas_streaming_interpret")
    return roll(ts, num_steps=STEPS, rebin_every=REBIN_EVERY)


@pytest.fixture(scope="module")
def melt():
    """tests/test_straggler.py's melt: the 2,048-atom FCC lattice at ρ* =
    0.8442 started hot (T* = 1.44) and run 120 steps on the wide config
    (the port's plain dense engine, dt 0.005, rebin every 2) into liquid
    occupancy, then a straggler config with C_t two below the fullest
    cell, C_w + 8, A = 64, Kn = 48: (state, config)."""
    from emdee_tpu_torch.neighbors import cell_dense as tcd
    from emdee_tpu_torch.utils.lattice import fcc_lattice
    from emdee_tpu_torch.utils.lattice import maxwell_boltzmann as tmb

    pos, box = fcc_lattice(8, density=0.8442)
    n = len(pos)
    wide = tcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.35)
    params = tlj(np.ones(n), np.ones(n), device="cpu")
    st = tcd.cell_dense_init(pos, tmb(n, 1.44, seed=5), np.ones(n), params, wide, device="cpu")
    roll, _ = tcd.make_cell_dense_sim(wide, TMODEL, dt=0.005, backend="torch", uniform_params=UNI, uniform_mass=1.0)
    st = roll(st, num_steps=120, rebin_every=2)
    assert not bool(st.overflow)
    p, v = tcd.gather_dense_atoms(st, n)
    config = jsd.StragglerConfig(grid=wide._replace(capacity=int(st.valid.sum(1).max()) - 2),
                                 wide_capacity=wide.capacity + 8, aux_capacity=64, kn=48)
    ts = tsd.straggler_init(p, v, np.ones(n), params, config, device="cpu")
    assert not bool(ts.grid.overflow) and _parked(ts, config) >= 5
    return ts, config


def test_streaming_nve_holds_energy_and_matches_wide(melt):
    """tests/test_straggler.py:102-140's streaming case on the port
    ('pallas_streaming_interpret': the plain streaming pass): 24 NVE steps
    at dt 0.005 hold the energy to 1e-4, the tail re-parks, and the
    trajectory is the wide engine's (the port's plain dense engine at C_w)
    within that test's 1e-3 / 1e-2."""
    from emdee_tpu_torch.neighbors.cell_dense import gather_dense_atoms, make_cell_dense_sim

    ts, config = melt
    n = config.grid.num_atoms
    roll, energy = tsd.make_straggler_sim(config, TMODEL, dt=0.005, uniform_params=UNI,
                                          backend="pallas_streaming_interpret")
    out = roll(ts, num_steps=24, rebin_every=6)
    pe0, _, ke0 = (float(x) for x in energy(ts))
    pe1, _, ke1 = (float(x) for x in energy(out))
    assert not bool(out.grid.overflow) and int(out.grid.step) == 24
    assert abs((pe1 + ke1) - (pe0 + ke0)) / abs(pe0 + ke0) < 1e-4
    assert _parked(out, config) >= 1
    w_roll, _ = make_cell_dense_sim(config.wide, TMODEL, dt=0.005, backend="torch", uniform_params=UNI,
                                    uniform_mass=1.0)
    w_out = w_roll(roll.wide_state(ts), num_steps=24, rebin_every=6)
    assert not bool(w_out.overflow)
    p_s, v_s = tsd.gather_straggler_atoms(out, config, n)
    p_w, v_w = gather_dense_atoms(w_out, n)
    np.testing.assert_allclose(p_s, p_w, atol=1e-3)
    np.testing.assert_allclose(v_s, v_w, atol=1e-2)


def _assert_rollouts_match(ja, ta, config):
    """test_rollout_matches_jax's tolerances: atom ids and the aux
    bookkeeping equal, positions 2e-5, velocities 2e-4."""
    assert not bool(ja.grid.overflow) and not bool(ta.grid.overflow)
    np.testing.assert_array_equal(ta.grid.atom_id.numpy(), np.asarray(ja.grid.atom_id))
    for name in ("aux_atom_id", "aux_cell", "aux_rank"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(), np.asarray(getattr(ja, name)), err_msg=name)
    pj, vj = jsd.gather_straggler_atoms(ja, config, N)
    pt, vt = tsd.gather_straggler_atoms(ta, config, N)
    np.testing.assert_allclose(pt, pj, atol=2e-5)
    np.testing.assert_allclose(vt, vj, atol=2e-4)


@pytest.mark.parametrize("jax_backend", [
    "pallas_interpret",
    # The reference keeps its own streaming straggler case full-tier (≈45 s).
    pytest.param("pallas_streaming_interpret", marks=pytest.mark.full),
])
def test_streaming_matches_jax(setup, streaming_run, jax_backend):
    """The port's streaming run against JAX's gather-pass straggler on the
    resident interpret kernel (quick) and on its streaming kernel (full),
    at test_rollout_matches_jax's tolerances."""
    _, _, config, js, _ = setup
    jroll, _ = jsd.make_straggler_sim(config, JMODEL, dt=DT, uniform_params=UNI, uniform_mass=1.0,
                                      backend=jax_backend, strag_pass="xla")
    _assert_rollouts_match(jroll(js, num_steps=STEPS, rebin_every=REBIN_EVERY), streaming_run, config)


@pytest.mark.parametrize("width", [1, 28])
def test_fixed_order_fold_matches_index_add(width):
    """The gather pass's reaction fold (`core/scatter.py`): the fixed-order
    add equals `index_add` within float32 rounding, on targets with many,
    one and no rows; it is the same whatever the device's scheduling, since
    no float atomics run."""
    from emdee_tpu_torch.core.scatter import add_plan, fixed_add

    rng = np.random.default_rng(width)
    target = torch.from_numpy(np.concatenate([rng.integers(0, 40, 1500), np.full(300, 7), [63]]))
    rows = torch.from_numpy(rng.normal(size=(target.numel(), width)).astype(np.float32))
    base = torch.from_numpy(rng.normal(size=(64, width)).astype(np.float32))
    got = fixed_add(base, add_plan(target, 64), rows)
    want = base.index_add(0, target, rows)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)
    untouched = np.setdiff1d(np.arange(64), target.numpy())
    assert torch.equal(got[untouched], base[untouched])
