"""Shared helpers for the differential tests of the PyTorch port
(`emdee_tpu_torch`) against the JAX package: inputs are made with numpy from
a seed, and states cross between the two packages as numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np

from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.potentials.lennard_jones import LennardJonesModel, lennard_jones_atom
from emdee_tpu.utils.lattice import cubic_lattice, maxwell_boltzmann
from emdee_tpu_torch.neighbors import cell_dense as tcd


def to_port(jax_state):
    """JAX CellDenseState → port state on the CPU, bit for bit."""
    return tcd.state_from_numpy(jax.device_get(jax_state)._asdict(), "cpu")


def bits(a):
    """Array as raw integer bits (float32 viewed as int32), for bit-exact checks."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_states_bitequal(jax_state, port_state, names=None):
    ref = jax.device_get(jax_state)._asdict()
    got = tcd.state_to_numpy(port_state)
    for name in names or got:
        np.testing.assert_array_equal(bits(got[name]), bits(ref[name]), err_msg=name)


def lj_setup(n, density, seed, jitter=0.15, varied=False, skin=0.3, temperature=1.0):
    """A jittered cubic lattice with MB velocities: (positions, velocities,
    JAX LJParams, config, JAX model)."""
    pos, box = cubic_lattice(n, density, jitter=jitter, seed=seed)
    vel = maxwell_boltzmann(n, temperature, seed=seed + 1)
    rng = np.random.default_rng(seed)
    if varied:
        params = lennard_jones_atom(rng.uniform(0.8, 1.2, n), rng.uniform(0.9, 1.1, n))
    else:
        params = lennard_jones_atom(np.ones(n), np.ones(n))
    config = jcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=skin)
    return pos, vel, params, config, LennardJonesModel.create(2.5, 2.0)


def drifted_state(n, seed, varied=False, density=0.65):
    """A binned JAX state whose atoms then drift 0.45·skin along their
    velocities in slot space, so a real fraction crosses cell faces and the
    periodic seam, as between rebins (built like tests/test_pallas_rebin.py)."""
    pos, vel, params, config, model = lj_setup(
        n, density, seed, jitter=0.2, varied=varied, skin=0.35, temperature=1.3
    )
    st = jcd.cell_dense_init(pos, vel, np.ones(n), params, config)
    assert not bool(st.overflow)
    vmax = float(jnp.max(jnp.abs(st.velocities)))
    drift = (0.45 * config.skin / vmax) * st.velocities
    st = st._replace(positions=jnp.where(st.valid[..., None], st.positions + drift, 0.0))
    return st, config, model
