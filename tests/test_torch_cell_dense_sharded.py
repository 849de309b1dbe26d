"""The port's slab-sharded dense-cell engine
(`emdee_tpu_torch.distributed.cell_dense_sharded`) on the CPU against the
JAX package's (`emdee_tpu/distributed/cell_dense_sharded.py`, on the 8
virtual CPU devices of tests/conftest.py), at
tests/test_cell_dense_sharded.py's sizes and tolerances: the config check
and its errors, energies on (4, 1, 1) against JAX's and the port's one-card
`cell_dense_forces`, the slot layout after the first rebin bit for bit, a
30-step rollout against JAX's and the port's dense engine; and on the
port's side alone: a 2-rank gloo `DistMesh` run bitwise equal to
`LocalMesh`, and (`full`) the energy conservation gate."""

import jax
import numpy as np
import pytest
import torch

from emdee_tpu.distributed import cell_dense_sharded as jcs
from emdee_tpu.distributed.mesh import make_mesh as jax_mesh
from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.potentials.lennard_jones import LennardJonesModel as JaxModel
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom as jax_lj_atom
from emdee_tpu.utils.lattice import cubic_lattice, maxwell_boltzmann
from emdee_tpu_torch import LennardJonesModel, make_cell_dense_sim
from emdee_tpu_torch.distributed import cell_dense_sharded as tcs
from emdee_tpu_torch.distributed import dryrun
from emdee_tpu_torch.distributed.mesh import make_grid_mesh, make_mesh
from emdee_tpu_torch.neighbors import cell_dense as tcd
from torch_port_utils import bits, to_port

torch.set_num_threads(2)


def _setup(n=4096, density=0.25, T=0.9, seed=21, ndev=4):
    """tests/test_cell_dense_sharded.py's `_setup`: (JAX state, config, n)."""
    pos, box = cubic_lattice(n, density, jitter=0.1, seed=seed)
    vel = maxwell_boltzmann(n, T, seed=seed + 1)
    config = jcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.3)
    config = config._replace(cells_per_dim=(config.cells_per_dim // ndev) * ndev)
    assert config.cells_per_dim >= 2 * ndev
    return jcd.cell_dense_init(pos, vel, np.ones(n), jax_lj_atom(np.ones(n), np.ones(n)), config), config, n


def _model():
    return LennardJonesModel.create(2.5, 2.0, device="cpu")


@pytest.fixture(scope="module")
def rollout_case():
    """The rollout fixture (2,048 atoms, ρ 0.09, (4, 1, 1)) and JAX's
    30-step slab rollout."""
    st, config, n = _setup(n=2048, density=0.09)
    rollout, _ = jcs.make_sharded_cell_dense_sim(config, JaxModel.create(2.5, 2.0), 0.002, jax_mesh(4))
    ref = rollout(jcs.distribute_cell_dense(st, jax_mesh(4)), num_steps=30, rebin_every=5)
    return st, config, n, ref


def test_validate_config_matches_reference():
    _, config, _ = _setup(n=2048, density=0.09)
    assert tcs.validate_sharded_config(config, 4) == jcs.validate_sharded_config(config, 4) >= 2
    for cfg, ndev, match in ((config._replace(cells_per_dim=10), 4, "divide evenly"),
                             (config._replace(cells_per_dim=8), 8, "need ≥ 2")):
        with pytest.raises(ValueError, match=match) as ours:
            tcs.validate_sharded_config(cfg, ndev)
        with pytest.raises(ValueError) as theirs:
            jcs.validate_sharded_config(cfg, ndev)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match=r"\(D, 1, 1\)"):
        tcs.make_sharded_cell_dense_sim(config, _model(), 0.002, make_grid_mesh((2, 2, 1), device="cpu"))


def test_energy_matches_reference_and_single_card():
    st, config, _ = _setup()
    mesh = make_mesh(4, device="cpu")
    _, energy = tcs.make_sharded_cell_dense_sim(config, _model(), 0.002, mesh)
    port = to_port(st)
    pe, vir, ke = (float(x) for x in energy(tcs.distribute_cell_dense(port, mesh)))
    _, jenergy = jcs.make_sharded_cell_dense_sim(config, JaxModel.create(2.5, 2.0), 0.002, jax_mesh(4))
    jpe, jvir, jke = (float(x) for x in jenergy(jcs.distribute_cell_dense(st, jax_mesh(4))))
    _, e_ref, w_ref = tcd.cell_dense_forces(port, _model(), config, compute_energy=True)
    for got, slab, single in ((pe, jpe, float(e_ref[port.valid].sum())), (vir, jvir, float(w_ref[port.valid].sum()))):
        np.testing.assert_allclose(got, slab, rtol=1e-5, atol=1e-2)
        np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(ke, jke, rtol=1e-5)


def test_layout_after_first_rebin_matches_reference(rollout_case):
    """One step at dt = 0 keeps the state the first rebin made: every field
    bit for bit JAX's."""
    st, config, _, _ = rollout_case
    jroll, _ = jcs.make_sharded_cell_dense_sim(config, JaxModel.create(2.5, 2.0), 0.0, jax_mesh(4))
    want = jax.device_get(jroll(jcs.distribute_cell_dense(st, jax_mesh(4)), num_steps=1, rebin_every=1))
    mesh = make_mesh(4, device="cpu")
    roll, _ = tcs.make_sharded_cell_dense_sim(config, _model(), 0.0, mesh)
    got = tcd.state_to_numpy(roll(tcs.distribute_cell_dense(to_port(st), mesh), num_steps=1, rebin_every=1))
    assert int(got["step"]) == 1
    for name, value in got.items():
        np.testing.assert_array_equal(bits(value), bits(np.asarray(getattr(want, name))), err_msg=name)


def test_rollout_matches_reference_and_dense_engine(rollout_case):
    st, config, n, ref = rollout_case
    mesh = make_mesh(4, device="cpu")
    rollout, _ = tcs.make_sharded_cell_dense_sim(config, _model(), 0.002, mesh)
    out = rollout(tcs.distribute_cell_dense(to_port(st), mesh), num_steps=30, rebin_every=5)
    assert not bool(out.overflow) and not bool(ref.overflow) and int(out.step) == 30
    p, v = tcd.gather_dense_atoms(out, n)
    for pr, vr in (jcd.gather_dense_atoms(ref, n),
                   tcd.gather_dense_atoms(make_cell_dense_sim(config, _model(), dt=0.002, backend="torch")[0](
                       to_port(st), num_steps=30, rebin_every=5), n)):
        np.testing.assert_allclose(p, pr, atol=2e-4)
        np.testing.assert_allclose(v, vr, atol=2e-4)


def test_gloo_dist_mesh_bitwise_equals_local_mesh(rollout_case):
    st, config, _, _ = rollout_case
    fields = tcd.state_to_numpy(to_port(st))
    runs = dryrun.run_ranks(2, dryrun.slab_job, (fields, config, 12, 5), timeout=240)
    want, energies = dryrun.slab_run(make_mesh(2, device="cpu"), fields, config, 12, 5)
    assert int(want["step"]) == 12 and not bool(want["overflow"])
    for got, got_e in runs:
        for name, value in want.items():
            np.testing.assert_array_equal(bits(got[name]), bits(value), err_msg=name)
        np.testing.assert_allclose(got_e, energies, rtol=1e-6)


@pytest.mark.full
def test_sharded_energy_conservation():
    """tests/test_cell_dense_sharded.py's `full` gate: 4,096 atoms at ρ 0.25
    on (4, 1, 1), 100 settling steps, then 200 within 5e-4 of KE."""
    st, config, _ = _setup(n=4096, density=0.25, T=0.8)
    mesh = make_mesh(4, device="cpu")
    rollout, energy = tcs.make_sharded_cell_dense_sim(config, _model(), 0.002, mesh)
    sh = rollout(tcs.distribute_cell_dense(to_port(st), mesh), num_steps=100, rebin_every=2)
    sh = sh._replace(overflow=torch.zeros((), dtype=torch.bool))
    pe0, _, ke0 = (float(x) for x in energy(sh))
    sh = rollout(sh, num_steps=200, rebin_every=5)
    assert not bool(sh.overflow)
    pe1, _, ke1 = (float(x) for x in energy(sh))
    assert abs((pe1 + ke1) - (pe0 + ke0)) / max(ke0, 1.0) < 5e-4
