"""The force kernel's wrappers (`cell_kernel.cell_forces`,
`cell_forces_split`) on CPU tensors — where they run the plain version —
against the TPU kernel in interpret mode, on tests/test_pallas_kernel.py's
864-atom setup and on a state drifted across the periodic seam, at that
file's tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.neighbors.pallas_cell_kernel import pallas_cell_forces, pallas_cell_forces_split
from emdee_tpu_torch.neighbors import cell_kernel
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel
from torch_port_utils import drifted_state, lj_setup, to_port

torch.set_num_threads(2)

TMODEL = LennardJonesModel.create(2.5, 2.0)


def _states():
    pos, vel, params, config, model = lj_setup(864, 0.5, seed=3, varied=True)
    st = jcd.cell_dense_init(pos, vel, np.ones(len(pos)), params, config)
    return {"lattice": (st, config, model), "drifted": drifted_state(1000, seed=11, varied=True)}


STATES = _states()


def _assert_forces_close(f, f_ref, valid):
    scale = np.abs(f_ref[valid]).max()
    np.testing.assert_allclose(f[valid], f_ref[valid], atol=2e-5 * max(scale, 1.0))
    assert (f[~valid] == 0).all()


@pytest.mark.parametrize(
    "which,compute_energy", [("lattice", True), ("drifted", True), ("drifted", False)]
)
def test_cell_forces_matches_pallas(which, compute_energy):
    st, config, model = STATES[which]
    ref = pallas_cell_forces(st, model, config, compute_energy=compute_energy, interpret=True)
    got = cell_kernel.cell_forces(to_port(st), TMODEL, config, compute_energy=compute_energy)
    valid = np.asarray(st.valid)
    _assert_forces_close(got[0].numpy(), np.asarray(ref[0]), valid)
    if not compute_energy:
        assert got[1] is None and got[2] is None
        return
    e, w = got[1].numpy(), got[2].numpy()
    np.testing.assert_allclose(e[valid], np.asarray(ref[1])[valid], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(w[valid], np.asarray(ref[2])[valid], rtol=1e-4, atol=2e-3)
    assert (e[~valid] == 0).all() and (w[~valid] == 0).all()


def test_cell_forces_split_matches_pallas():
    """Uniform-parameter split entry on the seam-drifted state, with an
    explicit box, against `pallas_cell_forces_split` in interpret mode."""
    st, config, _ = drifted_state(1000, seed=11)
    px, py, pz = (st.positions[..., i] for i in range(3))
    ref = pallas_cell_forces_split(
        px, py, pz, st.valid, config, uniform_params=(0.5, 2.0), interpret=True,
        box=jnp.float32(config.box),
    )
    t = to_port(st)
    comps = [t.positions[..., i].contiguous() for i in range(3)]
    got = cell_kernel.cell_forces_split(*comps, t.valid, config, uniform_params=(0.5, 2.0), box=config.box)
    valid = np.asarray(st.valid)
    f_ref = np.stack([np.asarray(a) for a in ref], -1)
    _assert_forces_close(torch.stack(got, -1).numpy(), f_ref, valid)
    # The uniform entry equals the stacked per-atom entry on a one-type state.
    stacked = cell_kernel.cell_forces(t, TMODEL, config)[0]
    assert torch.equal(torch.stack(got, -1), stacked)


def test_backend_resolution():
    st, config, _ = STATES["lattice"]
    t = to_port(st)
    with pytest.raises(ValueError, match="CUDA"):
        cell_kernel.cell_forces(t, TMODEL, config, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        cell_kernel.cell_forces(t, TMODEL, config, backend="xla")
    before = cell_kernel.LAUNCHES
    a = cell_kernel.cell_forces(t, TMODEL, config, backend="auto")[0]
    b = cell_kernel.cell_forces(t, TMODEL, config, backend="torch")[0]
    assert torch.equal(a, b) and cell_kernel.LAUNCHES == before  # the plain version launched nothing
