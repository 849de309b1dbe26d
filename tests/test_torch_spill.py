"""The boundary-spill capacity mode of the port against the JAX package:
the spill config, the spill init (bit-exact, except that the port stores a
seam spill's coordinate coherent with its stored cell), one spill shift
rebin (bit-exact), a 60-step spill rollout and the squeeze →
`shrink_capacity` flow of tests/test_cell_dense.py at the rollout
tolerances of tests/test_cell_dense.py:333-335 (positions 2e-5,
velocities 2e-4, equal atom ids)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.neighbors.pallas_cell_kernel import pallas_cell_forces
from emdee_tpu.potentials.lennard_jones import LennardJonesModel, lennard_jones_atom
from emdee_tpu.utils.lattice import cubic_lattice, maxwell_boltzmann
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.potentials import lennard_jones as tlj
from torch_port_utils import assert_states_bitequal, bits, random_fluid, spill_lattice_setup, to_jax, to_port

torch.set_num_threads(2)

TMODEL = tlj.LennardJonesModel.create(2.5, 2.0, device="cpu")


@pytest.mark.parametrize(
    "n,density,skin", [(1728, 0.75, 0.3), (97556, 0.8442, 0.35), (1000188, 0.8442, 0.35)]
)
def test_spill_config_matches_jax(n, density, skin):
    box = (n / density) ** (1.0 / 3.0)
    got = tcd.suggest_cell_dense_config(n, box, 2.5, 2.0, skin, spill=True)
    assert got == jcd.suggest_cell_dense_config(n, box, 2.5, 2.0, skin, spill=True)
    assert got.spill and got.cell_side > 2.5 + skin
    if n == 97556:  # the melt's spill geometry: M = 16, C = 32, ε = 0.194σ
        assert (got.cells_per_dim, got.capacity) == (16, 32)
        assert abs(got.cell_side - 2.5 - skin - 0.194) < 1e-3


def _seam_fixture():
    """1,500 atoms placed at random at ρ = 0.75 (0.85σ apart at least) on
    their spill config with capacity cut to 28, one below the fullest cell:
    the init spills two atoms, both across the periodic seam."""
    n = 1500
    pos, box = random_fluid(n, 0.75, 0.85, 0)
    vel = maxwell_boltzmann(n, 1.0, seed=1)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    config = jcd.suggest_cell_dense_config(n, box, 2.5, 2.0, 0.3, spill=True)._replace(capacity=28)
    return pos, vel, params, config


def test_spill_init_stores_seam_spills_coherently():
    pos, vel, params, config = _seam_fixture()
    n = len(pos)
    js = jcd.cell_dense_init(pos, vel, np.ones(n), params, config)
    ts = tcd.cell_dense_init(pos, vel, np.ones(n), tcd.lj_params_from_numpy(params, "cpu"), config, device="cpu")
    assert not bool(js.overflow) and not bool(ts.overflow)
    p64 = pos - np.floor(pos / config.box) * config.box
    cells, _, seam, ok = tcd._spill_assign_np(p64, config)
    free = tcd._spill_assign_np(p64, config._replace(capacity=10**6))[0]
    assert ok and int((cells != free).sum()) >= 1 and int(seam.sum()) >= 1

    assert_states_bitequal(js, ts, [k for k in tcd.state_to_numpy(ts) if k not in ("positions", "ref_positions")])
    ref = np.asarray(js.positions)
    got = ts.positions.numpy()
    moved = bits(got) != bits(ref)
    # Exactly the seam spills differ, each by exactly −L, below 0 (cell 0's frame).
    assert int(moved.sum()) == int(seam.sum())
    np.testing.assert_array_equal(got[moved], ref[moved] - np.float32(config.box))
    assert (got[moved] < 0).all()
    np.testing.assert_array_equal(ts.ref_positions.numpy(), got)

    # Forces at init: the port's plain version equals the reference's XLA
    # forces (which min-image every difference) within 2e-5 of the scale.
    fj = np.asarray(jcd.cell_dense_forces(js, LennardJonesModel.create(2.5, 2.0), config)[0])
    ft = tcd.cell_dense_forces(ts, TMODEL, config)[0].numpy()
    v = np.asarray(js.valid)
    scale = np.abs(fj[v]).max()
    assert np.abs(ft[v] - fj[v]).max() <= 2e-5 * scale
    # A kernel that takes the periodic shift from the cell index (the
    # reference's Pallas kernel, interpret mode) is right on the port's
    # state and wrong on the reference's own.
    model = LennardJonesModel.create(2.5, 2.0)
    fk_port = np.asarray(pallas_cell_forces(to_jax(ts), model, config, interpret=True)[0])
    fk_ref = np.asarray(pallas_cell_forces(js, model, config, interpret=True)[0])
    assert np.abs(fk_port[v] - fj[v]).max() <= 2e-5 * scale
    assert np.abs(fk_ref[v] - fj[v]).max() > 0.1 * scale


def _drifted_spill_state():
    """The seam fixture at its suggested capacity, squeezed toward 24 atoms a
    cell (about the mean), every atom moved 0.4σ per axis along its
    velocity's sign, unwrapped, as a rebin finds a block's end state."""
    pos, vel, params, config = _seam_fixture()
    n = len(pos)
    config = jcd.suggest_cell_dense_config(n, config.box, 2.5, 2.0, 0.3, spill=True)._replace(spill_target=24)
    st = jcd.cell_dense_init(pos, vel, np.ones(n), params, config)
    assert not bool(st.overflow)
    return st._replace(positions=jnp.where(st.valid[..., None], st.positions + 0.4 * jnp.sign(st.velocities), 0.0)), config


@pytest.mark.parametrize("with_forces", [False, True])
def test_spill_rebin_shift_bitexact(with_forces):
    st, config = _drifted_spill_state()
    f = jnp.where(st.valid[..., None], 0.1 * st.positions, 0.0) if with_forces else None
    ref = jcd._rebin_shift(st, config, forces=f, backend="xla")
    got = tcd._rebin_shift(to_port(st), config, None if f is None else torch.from_numpy(np.array(f)))
    if with_forces:
        (ref, ref_f), (got, got_f) = ref, got
        np.testing.assert_array_equal(bits(got_f.numpy()), bits(np.asarray(ref_f)))
    assert not bool(ref.overflow)
    assert_states_bitequal(ref, got)
    # Atoms stored off their true cell: the spills and hold-backs fired.
    assert int((got.atom_id != to_port(st).atom_id).sum()) > 100


@pytest.mark.parametrize("carry", ["stacked", "component"])
def test_spill_rollout_matches_jax(carry):
    """tests/test_cell_dense.py's 60-step spill rollout (dt 0.002, rebin
    every 5) against the reference's XLA rollout."""
    pos, vel, params, config, model = spill_lattice_setup()
    n = len(pos)
    st = jcd.cell_dense_init(pos, vel, np.ones(n), params, config)
    assert not bool(st.overflow)
    ref = jcd.make_cell_dense_sim(config, model, dt=0.002, backend="xla")[0](st, num_steps=60, rebin_every=5)
    kw = {"uniform_params": (0.5, 2.0), "uniform_mass": 1.0} if carry == "component" else {}
    roll, _ = tcd.make_cell_dense_sim(config, TMODEL, dt=0.002, **kw)
    got = roll(to_port(st), num_steps=60, rebin_every=5)
    _assert_rollouts_close(ref, got, n)


def _assert_rollouts_close(ref, got, n):
    assert not bool(ref.overflow) and not bool(got.overflow)
    assert int(got.step) == int(ref.step)
    np.testing.assert_array_equal(got.atom_id.numpy(), np.asarray(ref.atom_id))
    pj, vj = jcd.gather_dense_atoms(ref, n)
    pt, vt = tcd.gather_dense_atoms(got, n)
    np.testing.assert_allclose(pt, pj, atol=2e-5)
    np.testing.assert_allclose(vt, vj, atol=2e-4)


def test_squeeze_then_shrink_capacity_matches_jax():
    """tests/test_cell_dense.py's squeeze flow: 40 steps at capacity + 16
    squeezed toward the tight capacity, `shrink_capacity`, 30 steps at the
    tight capacity — the same configs, atom ids and trajectory."""
    pos, box = cubic_lattice(1728, 0.75, jitter=0.12, seed=21)
    n = len(pos)
    vel = maxwell_boltzmann(n, 1.0, seed=22)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    tight = jcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.3, spill=True)
    squeeze = tight._replace(capacity=tight.capacity + 16, spill_target=tight.capacity)
    model = LennardJonesModel.create(2.5, 2.0)
    js = jcd.cell_dense_init(pos, vel, np.ones(n), params, squeeze)
    ts = to_port(js)
    js = jcd.make_cell_dense_sim(squeeze, model, dt=0.002, backend="xla")[0](js, num_steps=40, rebin_every=4)
    ts = tcd.make_cell_dense_sim(squeeze, TMODEL, dt=0.002)[0](ts, num_steps=40, rebin_every=4)
    assert not bool(ts.overflow) and int(ts.valid[:, tight.capacity:].sum()) == 0
    js, jcfg = jcd.shrink_capacity(js, squeeze, tight.capacity)
    ts, tcfg = tcd.shrink_capacity(ts, squeeze, tight.capacity)
    assert tcfg == jcfg and ts.positions.shape == tuple(np.asarray(js.positions).shape)
    with pytest.raises(ValueError, match="squeeze"):
        tcd.shrink_capacity(ts, tcfg, tight.capacity - 8)
    js = jcd.make_cell_dense_sim(jcfg, model, dt=0.002, backend="xla")[0](js, num_steps=30, rebin_every=5)
    ts = tcd.make_cell_dense_sim(tcfg, TMODEL, dt=0.002)[0](ts, num_steps=30, rebin_every=5)
    _assert_rollouts_close(js, ts, n)
    assert int(ts.valid.sum()) == n
    jax.clear_caches()
