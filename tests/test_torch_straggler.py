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
    """`suggest_straggler_config` equals JAX's; the TPU-only backends are
    refused, streaming naming its ROADMAP item."""
    for args in ((100_000, 48.7, 2.5, 2.0), (97_556, 48.37, 2.5, 2.0, 0.35, None, None, 64, 16)):
        cfg = tsd.suggest_straggler_config(*args)
        assert cfg == jsd.suggest_straggler_config(*args)
        assert cfg.sentinel == cfg.wide.num_slots and cfg.grid.capacity < cfg.wide_capacity
    cfg = tsd.suggest_straggler_config(2048, 13.4, 2.5, 2.0)
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        tsd.make_straggler_sim(cfg, TMODEL, dt=DT, uniform_params=UNI, backend="pallas_streaming")
    for kw in ({"backend": "pallas"}, {"strag_pass": "tile"}):
        with pytest.raises(ValueError):
            tsd.make_straggler_sim(cfg, TMODEL, dt=DT, uniform_params=UNI, **kw)
    with pytest.raises(ValueError, match="spill"):
        tsd.make_straggler_sim(cfg._replace(grid=cfg.grid._replace(spill=True)), TMODEL, dt=DT, uniform_params=UNI)
