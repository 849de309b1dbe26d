"""The rebin kernel's wrapper (`rebin_kernel.rebin_routing`) on CPU tensors
— where it runs the plain version — against the TPU kernel in interpret
mode, and the port's `_rebin_shift` against the JAX package's XLA rebin:
bit-exact in every field, including fill lanes and the overflow flag.  The
wrapper takes either parked fields (the reference kernel's input) or raw
positions, any strides, with the valid mask, parking and wrapping them
itself as the card's kernel does in its first pass."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.neighbors.pallas_rebin import SENTINEL_BITS, rebin_routing_pallas
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.neighbors import rebin_kernel
from torch_port_utils import assert_states_bitequal, bits, drifted_state, to_port

torch.set_num_threads(2)

DRIFTED = drifted_state(1200, seed=11, varied=True)


def _routing_fields(st, config, jump=False):
    """The kernel's inputs as `_rebin_shift_core` builds them: wrapped
    positions with the sentinel in empty slots, then velocities, inverse
    masses, LJ params, and atom_id last.  `jump` moves one atom two cells."""
    pos = st.positions
    if jump:
        first = int(np.flatnonzero(np.asarray(st.valid).reshape(-1))[0])
        cell, slot = divmod(first, config.capacity)
        pos = pos.at[cell, slot, 0].add(2.0 * config.cell_side)
    box = jnp.float32(config.box)
    pos = pos - jnp.floor(pos / box) * box
    sent = jax.lax.bitcast_convert_type(jnp.int32(SENTINEL_BITS), jnp.float32)
    fields = [jnp.where(st.valid, pos[..., i], sent) for i in range(3)]
    fields += [st.velocities[..., i] for i in range(3)]
    fields += [st.inv_masses, st.half_sigma, st.twice_sqrt_eps, st.atom_id]
    return tuple(fields)


def _moved(st, config, case):
    """The drifted state with, for `case` 'jump', one atom moved two cells
    along x, and for 'crowded_y' every atom of the cells at y = 0 moved one
    cell up y, so that the y pass — between the other two — overflows the
    cells at y = 1 (two cells' atoms, ~37 on average, for C = 32)."""
    pos = st.positions
    if case == "jump":
        first = int(np.flatnonzero(np.asarray(st.valid).reshape(-1))[0])
        cell, slot = divmod(first, config.capacity)
        pos = pos.at[cell, slot, 0].add(2.0 * config.cell_side)
    elif case == "crowded_y":
        m = config.cells_per_dim
        low = (jnp.arange(m**3) // m) % m == 0
        pos = pos.at[..., 1].add(jnp.where(low[:, None] & st.valid, config.cell_side, 0.0))
    return st._replace(positions=pos)


@pytest.mark.parametrize("jump", [False, True])
def test_rebin_routing_matches_pallas(jump):
    st, config, _ = DRIFTED
    fields = _routing_fields(st, config, jump)
    args = (config.box, config.cells_per_dim, config.capacity, config.num_slots)
    ref, ref_ovf = rebin_routing_pallas(fields, *args, interpret=True)
    got, ovf = rebin_kernel.rebin_routing(tuple(torch.from_numpy(np.array(f)) for f in fields), *args)
    assert bool(ovf) == bool(ref_ovf) == jump
    for i, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(bits(b.numpy()), bits(a), err_msg=f"field {i}")
    moved = int(((got[-1] != torch.from_numpy(np.array(st.atom_id))) & (got[-1] < config.num_slots)).sum())
    assert moved > 10, f"fixture too static: only {moved} slots changed"


@pytest.mark.parametrize("uniform", [False, True])
def test_rebin_shift_matches_jax(uniform):
    st, config, _ = DRIFTED if not uniform else drifted_state(1200, seed=21)
    kw = {"uniform_params": (0.5, 2.0), "uniform_mass": 1.0} if uniform else {}
    ref = jcd._rebin_shift(st, config, backend="xla", **kw)
    got = tcd._rebin_shift(to_port(st), config, backend="auto", **kw)
    assert_states_bitequal(ref, got)
    assert not bool(got.overflow)
    assert int(((got.atom_id != to_port(st).atom_id) & got.valid).sum()) > 10


@pytest.mark.parametrize("case", ["drift", "jump", "crowded_y"])
def test_rebin_routing_parks_raw_strided_fields_as_pallas(case):
    """The wrapper's plain path on raw positions and velocities given as
    strided views of their (M³, C, 3) tensors, with the valid mask and
    wrap=True (`_rebin_shift_core`'s call), against the TPU kernel in
    interpret mode on the parked, wrapped fields: bit-exact in every field
    and the flag — through an illegal two-cell move, and through a y pass
    that overflows between the z and x passes."""
    st, config, _ = DRIFTED
    st = _moved(st, config, case)
    args = (config.box, config.cells_per_dim, config.capacity, config.num_slots)
    ref, ref_ovf = rebin_routing_pallas(_routing_fields(st, config), *args, interpret=True)
    pos = torch.from_numpy(np.array(st.positions))
    vel = torch.from_numpy(np.array(st.velocities))
    fields = [pos[..., i] for i in range(3)] + [vel[..., i] for i in range(3)]
    fields += [torch.from_numpy(np.array(f)) for f in (st.inv_masses, st.half_sigma, st.twice_sqrt_eps, st.atom_id)]
    assert fields[0].stride() == (3 * config.capacity, 3)
    valid = torch.from_numpy(np.array(st.valid))
    got, ovf = rebin_kernel.rebin_routing(tuple(fields), *args, valid=valid, wrap=True)
    assert bool(ovf) == bool(ref_ovf) == (case != "drift")
    for i, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(bits(b.numpy()), bits(a), err_msg=f"field {i}")
    if case == "crowded_y":  # the overflow drops atoms: fewer slots than atoms stay live
        assert int((got[-1] < config.num_slots).sum()) < int(valid.sum())
    with pytest.raises(ValueError, match="wrap needs the valid mask"):
        rebin_kernel.rebin_routing(tuple(fields), *args, wrap=True)
