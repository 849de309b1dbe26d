"""The window routing pass (`rebin_window_kernel.rebin_window_pass`, K6) on
CPU tensors — where it runs its plain version — against the TPU kernel
`rebin_window_pass_pallas` in interpret mode, on windows from a drifted
state, for all three axes; and, on a one-shard grid, three window passes
against the whole-grid routing's plain version (K4's): bit-exact in every
slot and the flag."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.neighbors.pallas_rebin import rebin_window_pass_pallas
from emdee_tpu_torch.neighbors import rebin_kernel, rebin_window_kernel
from emdee_tpu_torch.neighbors.cell_dense import _PASSES
from torch_port_utils import drifted_state
from test_torch_rebin_kernel import _routing_fields

torch.set_num_threads(2)

DRIFTED = drifted_state(1200, seed=11, varied=True)


def _stacked(fields):
    """(nf, M³, C) int32 from the routing fields (float32 viewed as int32)."""
    return torch.stack([torch.from_numpy(np.array(f)).view(torch.int32) for f in fields])


@pytest.mark.parametrize("axis,jump", [(0, False), (1, False), (2, False), (2, True)])
def test_window_pass_matches_pallas(axis, jump):
    st, config, _ = DRIFTED
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    x, wl, wr, b = rebin_window_kernel.periodic_windows(_stacked(_routing_fields(st, config, jump)), m, axis)
    cf = _PASSES[axis][2]
    got, ovf = rebin_window_kernel.rebin_window_pass(x, wl, wr, b, config.box, cf, m, c, ns)
    ref, ref_ovf = rebin_window_pass_pallas(
        jnp.asarray(x.numpy()), jnp.asarray(wl.numpy()), jnp.asarray(wr.numpy()), jnp.asarray(b.numpy()),
        config.box, cf, m, c, ns, planes=m, interpret=True,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert bool(ovf) == bool(ref_ovf) == jump
    moved = int((got[-1] != x[-1]).sum())
    assert moved > 10, f"fixture too static: only {moved} slots changed"


def test_window_passes_match_whole_grid_routing():
    st, config, _ = DRIFTED
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    fields = _routing_fields(st, config)
    x = _stacked(fields)
    flag = torch.zeros((), dtype=torch.bool)
    for axis, _, cf in _PASSES:
        args = rebin_window_kernel.periodic_windows(x, m, axis)
        out, ovf = rebin_window_kernel.rebin_window_pass(*args, config.box, cf, m, c, ns, backend="torch")
        x, flag = out.reshape(x.shape), flag | ovf
    ref, ref_ovf = rebin_kernel.rebin_routing(tuple(torch.from_numpy(np.array(f)) for f in fields), config.box, m, c, ns)
    for i, r in enumerate(ref):
        np.testing.assert_array_equal(x[i].numpy(), r.view(torch.int32).numpy(), err_msg=f"field {i}")
    assert bool(flag) == bool(ref_ovf) is False
