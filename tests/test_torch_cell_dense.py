"""The port's slot binning and plain force pass against the JAX package:
`cell_dense_init` bit for bit, `cell_dense_forces` within the tolerances of
tests/test_pallas_kernel.py."""

import jax
import numpy as np
import pytest
import torch

from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.potentials import lennard_jones as jlj
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.potentials import lennard_jones as tlj
from torch_port_utils import assert_states_bitequal, lj_setup, to_port

torch.set_num_threads(2)


@pytest.mark.parametrize("varied", [False, True])
def test_init_bitexact(varied):
    """Same numpy inputs on both sides, each side forming its own LJ params:
    every field of the slot state is bit-identical, including the wrap of
    out-of-box inputs (binned raw, stored wrapped)."""
    pos, vel, _, config, _ = lj_setup(1000, 0.65, seed=11, jitter=0.2, skin=0.35)
    n = len(pos)
    rng = np.random.default_rng(2)
    eps, sig = (rng.uniform(0.8, 1.2, n), rng.uniform(0.9, 1.1, n)) if varied else (np.ones(n), np.ones(n))
    masses = rng.uniform(1.0, 2.0, n)
    pos = pos.copy()
    pos[::7, 0] += config.box
    pos[3::11, 2] -= config.box
    j = jcd.cell_dense_init(pos, vel, masses, jlj.lennard_jones_atom(eps, sig), config)
    t = tcd.cell_dense_init(pos, vel, masses, tlj.lennard_jones_atom(eps, sig), config, device="cpu")
    assert_states_bitequal(j, t)
    assert not bool(t.overflow)


def test_init_overflow_and_roundtrip():
    pos, vel, params, config, _ = lj_setup(1000, 0.65, seed=5)
    tight = config._replace(capacity=8)
    j = jcd.cell_dense_init(pos, vel, np.ones(len(pos)), params, tight)
    t = tcd.cell_dense_init(
        pos, vel, np.ones(len(pos)), tcd.lj_params_from_numpy(jax.device_get(params), "cpu"), tight
    )
    assert bool(j.overflow) and bool(t.overflow)
    assert_states_bitequal(j, t)
    # JAX state → port → numpy → JAX state again, bit for bit.
    back = jcd.CellDenseState(**tcd.state_to_numpy(to_port(j)))
    assert_states_bitequal(back, t)


@pytest.mark.parametrize("varied", [False, True])
def test_forces_match_jax(varied):
    pos, vel, params, config, model = lj_setup(1000, 0.6, seed=3, varied=varied)
    j = jcd.cell_dense_init(pos, vel, np.ones(len(pos)), params, config)
    t = to_port(j)
    f_ref, e_ref, w_ref = (np.asarray(a) for a in jcd.cell_dense_forces(j, model, config, compute_energy=True))
    f, e, w = (a.numpy() for a in tcd.cell_dense_forces(
        t, tlj.LennardJonesModel.create(2.5, 2.0), config, compute_energy=True
    ))
    valid = t.valid.numpy()
    scale = np.abs(f_ref[valid]).max()
    np.testing.assert_allclose(f[valid], f_ref[valid], atol=2e-5 * max(scale, 1.0))
    np.testing.assert_allclose(e[valid], e_ref[valid], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(w[valid], w_ref[valid], rtol=1e-4, atol=2e-3)
    assert (f[~valid] == 0).all() and (e[~valid] == 0).all() and (w[~valid] == 0).all()
    f_only = tcd.cell_dense_forces(t, tlj.LennardJonesModel.create(2.5, 2.0), config)
    assert f_only[1] is None and torch.equal(f_only[0], torch.from_numpy(f))


def test_gather_matches_jax():
    pos, vel, params, config, _ = lj_setup(864, 0.5, seed=8, varied=True)
    j = jcd.cell_dense_init(pos, vel, np.linspace(1.0, 2.0, len(pos)), params, config)
    t = to_port(j)
    for a, b in zip(jcd.gather_dense_atoms(j, len(pos)), tcd.gather_dense_atoms(t, len(pos))):
        np.testing.assert_array_equal(b, a)
    ref = jcd.gather_dense_fields(j, len(pos))
    got = tcd.gather_dense_fields(t, len(pos))
    for name, a in got.items():
        np.testing.assert_array_equal(a, ref[name], err_msg=name)
