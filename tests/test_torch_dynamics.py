"""The dense engine's dynamics of the port against the JAX package: the sort
rebin (bit-exact) and shift ≡ sort, the synced kick-drift-kick rollout with
records, the CSVR rescaling factor on the reference's own draws, the
thermostats in their deterministic limits (CSVR at τ = ∞ rescales by
exactly 1, Langevin at zero friction adds exactly no noise), Berendsen NPT
on the dynamic box, and `reconfigure_dense_state`.

Random draws cannot match across the packages (a `jax.random` key against a
`torch.Generator`), so the thermostats are compared in those limits; their
statistical relaxation gates, like the reference's, are full tier.
Tolerances are the rollout tolerances of tests/test_cell_dense.py:333-335
(positions 2e-5, velocities 2e-4, equal atom ids)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.dynamics.bussi import _csvr_alpha2 as jax_csvr_alpha2
from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.potentials.lennard_jones import LennardJonesModel, lennard_jones_atom
from emdee_tpu.utils.lattice import cubic_lattice, fcc_lattice, maxwell_boltzmann
from emdee_tpu_torch.dynamics import bussi as tbussi
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.potentials import lennard_jones as tlj
from torch_port_utils import assert_states_bitequal, bits, drifted_state, lj_setup, to_port

torch.set_num_threads(2)

TMODEL = tlj.LennardJonesModel.create(2.5, 2.0, device="cpu")


def _assert_close(ref, got, n):
    assert not bool(ref.overflow) and not bool(got.overflow)
    assert int(got.step) == int(ref.step)
    np.testing.assert_array_equal(got.atom_id.numpy(), np.asarray(ref.atom_id))
    pj, vj = jcd.gather_dense_atoms(ref, n)
    pt, vt = tcd.gather_dense_atoms(got, n)
    np.testing.assert_allclose(pt, pj, atol=2e-5)
    np.testing.assert_allclose(vt, vj, atol=2e-4)


@pytest.mark.parametrize("with_forces", [False, True])
def test_sort_rebin_bitexact_and_equal_to_shift(with_forces):
    st, config, _ = drifted_state(1000, seed=5, varied=True)
    f = jnp.where(st.valid[..., None], 0.1 * st.positions, 0.0) if with_forces else None
    ref = jcd._rebin(st, config, forces=f)
    tf = None if f is None else torch.from_numpy(np.array(f))
    got = tcd._rebin(to_port(st), config, tf)
    shift = tcd._rebin_shift(to_port(st), config, tf)
    if with_forces:
        (ref, ref_f), (got, got_f), (shift, shift_f) = ref, got, shift
        np.testing.assert_array_equal(bits(got_f.numpy()), bits(np.asarray(ref_f)))
    assert not bool(ref.overflow)
    assert_states_bitequal(ref, got)
    # Shift ≡ sort (tests/test_cell_dense.py:123): the same cell for every
    # atom and the same payloads, bit for bit (both transports are moves;
    # the order inside a cell may differ).
    n = int(got.valid.sum())
    cells = torch.arange(config.num_cells)[:, None].expand_as(got.valid)

    def by_atom(s, a):
        out = torch.zeros((n,) + tuple(a.shape[2:]), dtype=a.dtype)
        out[s.atom_id[s.valid].long()] = a[s.valid]
        return out

    assert torch.equal(by_atom(shift, cells), by_atom(got, cells))
    for name in ("positions", "velocities", "inv_masses", "half_sigma", "twice_sqrt_eps"):
        assert torch.equal(by_atom(shift, getattr(shift, name)), by_atom(got, getattr(got, name))), name
    if with_forces:
        assert torch.equal(by_atom(shift, shift_f), by_atom(got, got_f))


def test_kdk_record_matches_jax_and_leapfrog():
    """The synced path (record=True) against the reference's, records at
    rtol 1e-5; and the leapfrog NVE path against it (tests/test_cell_dense.py:277)."""
    pos, vel, params, config, model = lj_setup(1000, 0.5, seed=11, skin=0.4)
    n = len(pos)
    st = jcd.cell_dense_init(pos, vel, np.ones(n), params, config)
    ref, ref_rec = jcd.make_cell_dense_sim(config, model, dt=0.002, backend="xla")[0](
        st, num_steps=32, rebin_every=5, record=True
    )
    roll, energy = tcd.make_cell_dense_sim(config, TMODEL, dt=0.002)
    got, rec = roll(to_port(st), num_steps=32, rebin_every=5, record=True)
    _assert_close(ref, got, n)
    assert all(r.shape == (6,) for r in rec)  # the six full blocks, not the remainder
    np.testing.assert_array_equal(rec[0].numpy(), np.asarray(ref_rec[0]))
    for r, j in zip(rec[1:], ref_rec[1:]):
        np.testing.assert_allclose(r.numpy(), np.asarray(j), rtol=1e-5)

    lf = roll(to_port(st), num_steps=32, rebin_every=5)
    p_lf, v_lf = tcd.gather_dense_atoms(lf, n)
    p_kdk, v_kdk = tcd.gather_dense_atoms(got, n)
    np.testing.assert_allclose(p_lf, p_kdk, atol=5e-4)
    np.testing.assert_allclose(v_lf, v_kdk, atol=5e-4)
    pe0, _, ke0 = (float(x) for x in energy(to_port(st)))
    pe1, _, ke1 = (float(x) for x in energy(lf))
    assert abs((pe1 + ke1) - (pe0 + ke0)) / max(abs(pe0 + ke0), 1.0) < 2e-4


@pytest.mark.parametrize("tau", [0.2, 0.05, 3.0, float("inf")])
def test_csvr_alpha2_on_jax_draws(tau):
    """The port's pure α² on the normal and gamma draws that the reference's
    `_csvr_alpha2` makes from its key (emdee_tpu/dynamics/bussi.py:37-40)."""
    ndof, kT, dt = 2589.0, 1.0, 0.004
    for i, kin in enumerate((1294.5, 700.0, 2100.0)):
        key = jax.random.PRNGKey(i)
        k1, k2 = jax.random.split(key)
        r1 = jax.random.normal(k1, (), jnp.float32)
        sum_r2 = 2.0 * jax.random.gamma(k2, 0.5 * (jnp.float32(ndof) - 1.0), dtype=jnp.float32)
        ref = float(jax_csvr_alpha2(key, jnp.float32(kin), jnp.float32(ndof), jnp.float32(kT),
                                    jnp.float32(dt), jnp.float32(tau), jnp.float32))
        got = tbussi._csvr_alpha2(torch.tensor(float(r1)), torch.tensor(float(sum_r2)),
                                  torch.tensor(kin, dtype=torch.float32), ndof, kT, dt, tau)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), ref, rtol=1e-6)
        if tau == float("inf"):
            assert float(got) == 1.0


def _thermo_setup(t_init=0.8, density=0.7):
    """tests/test_dense_thermostats.py's fixture: FCC 6³ (864 atoms)."""
    pos, box = fcc_lattice(6, density=density)
    n = pos.shape[0]
    vel = maxwell_boltzmann(n, t_init, seed=11)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    config = jcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.35)
    st = jcd.cell_dense_init(pos, vel, np.ones(n), params, config)
    assert not bool(st.overflow)
    return st, config, n


@pytest.mark.parametrize(
    "jax_thermo,port_thermo",
    [(jcd.CSVRConfig(1.0, float("inf")), tcd.CSVRConfig(1.0, float("inf"))),
     (jcd.LangevinConfig(1.0, 0.0), tcd.LangevinConfig(1.0, 0.0))],
    ids=["csvr_tau_inf", "langevin_friction_0"],
)
def test_thermostat_deterministic_limits_match_jax(jax_thermo, port_thermo):
    st, config, n = _thermo_setup()
    model = LennardJonesModel.create(2.5, 2.0)
    ref = jcd.make_cell_dense_sim(config, model, dt=0.004, backend="xla", thermostat=jax_thermo)[0](
        st, num_steps=24, rebin_every=6, rng=jax.random.PRNGKey(3)
    )
    roll, _ = tcd.make_cell_dense_sim(config, TMODEL, dt=0.004, thermostat=port_thermo)
    got = roll(to_port(st), num_steps=24, rebin_every=6, rng=torch.Generator().manual_seed(3))
    _assert_close(ref, got, n)


def test_berendsen_npt_matches_jax():
    """Berendsen coupling alone (no thermostat) from the NPT gate's FCC start
    at ρ = 0.85: the dynamic box and the state over 24 steps (4 rescales)."""
    st, config, n = _thermo_setup(t_init=1.0, density=0.85)
    model = LennardJonesModel.create(2.5, 2.0)
    baro = dict(pressure=0.5, tau=0.4, kappa=1.0)
    ref = jcd.make_cell_dense_sim(config, model, dt=0.004, backend="xla",
                                  barostat=jcd.BerendsenBarostatConfig(**baro))[0](st, num_steps=24, rebin_every=6)
    roll, _ = tcd.make_cell_dense_sim(config, TMODEL, dt=0.004, barostat=tcd.BerendsenBarostatConfig(**baro))
    got = roll(to_port(st), num_steps=24, rebin_every=6)
    assert got.box.dtype == torch.float32 and got.box.dim() == 0
    np.testing.assert_allclose(float(got.box), float(ref.box), rtol=1e-6)
    assert abs(float(got.box) / config.box - 1.0) > 1e-3  # the box moved (the cold lattice is under tension)
    _assert_close(ref, got, n)


def test_reconfigure_matches_jax():
    """tests/test_reconfigure.py's grown box (×1.4, step 123): the same new
    config, the same re-init state bit for bit, the step carried over."""
    pos, box = cubic_lattice(864, 0.4, jitter=0.08, seed=3)
    params = lennard_jones_atom(np.full(864, 1.01), np.full(864, 0.97))
    config = jcd.suggest_cell_dense_config(864, box, cutoff=2.5, switch=2.0, skin=0.3)
    st = jcd.cell_dense_init(pos, maxwell_boltzmann(864, 0.9, seed=4), np.linspace(1.0, 2.0, 864), params, config)
    mu = 1.4
    st = st._replace(positions=st.positions * mu, ref_positions=st.ref_positions * mu,
                     box=jnp.float32(config.box * mu), step=jnp.asarray(123, jnp.int32))
    ref, ref_cfg = jcd.reconfigure_dense_state(st, config)
    got, cfg = tcd.reconfigure_dense_state(to_port(st), config)
    assert cfg == ref_cfg and cfg.cells_per_dim > config.cells_per_dim
    assert int(got.step) == 123 and got.box is None
    assert_states_bitequal(ref, got)


def test_rng_contract():
    """A thermostatted rollout without an rng raises ValueError naming it;
    NVE ignores a generator bit for bit."""
    st, config, _ = _thermo_setup()
    roll, _ = tcd.make_cell_dense_sim(config, TMODEL, dt=0.004, thermostat=tcd.CSVRConfig(1.0, 0.2))
    with pytest.raises(ValueError, match="rng"):
        roll(to_port(st), num_steps=4, rebin_every=2)
    nve, _ = tcd.make_cell_dense_sim(config, TMODEL, dt=0.004)
    a = nve(to_port(st), num_steps=12, rebin_every=6)
    b = nve(to_port(st), num_steps=12, rebin_every=6, rng=torch.Generator().manual_seed(9))
    assert torch.equal(a.positions, b.positions) and torch.equal(a.velocities, b.velocities)


def _temperature(state, n):
    v = state.velocities[state.valid].double()
    return float((v**2).sum()) / (3.0 * n - 3.0)


@pytest.mark.full
@pytest.mark.parametrize(
    "thermostat", [tcd.CSVRConfig(1.0, 0.2), tcd.LangevinConfig(1.0, 2.0)], ids=["csvr", "langevin"]
)
def test_dense_thermostat_relaxes_to_target(thermostat):
    """tests/test_dense_thermostats.py's relaxation gate on the port: from
    T* = 0.2 to within 15% of 1.0 in 600 steps, held over 300 more."""
    st, config, n = _thermo_setup(t_init=0.2)
    roll, _ = tcd.make_cell_dense_sim(config, TMODEL, dt=0.004, thermostat=thermostat)
    out = roll(to_port(st), num_steps=600, rebin_every=5, rng=torch.Generator().manual_seed(3))
    assert not bool(out.overflow) and 0.85 < _temperature(out, n) < 1.15
    out = roll(out, num_steps=300, rebin_every=5, rng=torch.Generator().manual_seed(5))
    assert 0.85 < _temperature(out, n) < 1.15


@pytest.mark.full
def test_dense_npt_relaxes_pressure():
    """tests/test_dense_thermostats.py's NPT gate on the port: the box grows
    by more than 1% and most of the pressure gap closes."""
    st, config, n = _thermo_setup(t_init=1.0, density=0.85)
    thermo = tcd.CSVRConfig(1.0, 0.2)
    nvt, energy = tcd.make_cell_dense_sim(config, TMODEL, dt=0.004, thermostat=thermo)
    npt, _ = tcd.make_cell_dense_sim(config, TMODEL, dt=0.004, thermostat=thermo,
                                     barostat=tcd.BerendsenBarostatConfig(0.5, 0.4, 1.0))

    def pressure(s):
        _, vir, ke = (float(x) for x in energy(s))
        b = config.box if s.box is None else float(s.box)
        return (2.0 * ke + vir) / (3.0 * b**3)

    s = nvt(to_port(st), num_steps=400, rebin_every=5, rng=torch.Generator().manual_seed(7))
    p0 = pressure(s)
    assert not bool(s.overflow) and p0 > 1.5
    out = npt(s, num_steps=800, rebin_every=5, rng=torch.Generator().manual_seed(13))
    assert not bool(out.overflow) and float(out.box) > config.box * 1.01
    assert abs(pressure(out) - 0.5) < 0.5 * abs(p0 - 0.5)
