"""The window compaction (K7) and the spill routing pass of the port against
the JAX package: the plain version of `compact_kernel.compact_stacked`
against `compact_window_pallas` in interpret mode, and one spill routing
pass (`cell_dense._route_axis_pass` with spill) against the reference's XLA
pass.  Both are pure data movement, so every kept slot is compared bit for
bit."""

import jax.numpy as jnp
import numpy as np
import torch

from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.neighbors.pallas_compact import compact_window_pallas
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom
from emdee_tpu.utils.lattice import maxwell_boltzmann
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.neighbors import compact_kernel
from torch_port_utils import bits, random_fluid

torch.set_num_threads(2)


def test_compact_plain_matches_pallas_interpret():
    """tests/test_pallas_compact.py's inputs: kept slots (slot < count) bit
    for bit, int32 kept as int32, and the fill beyond the count."""
    rng = np.random.default_rng(0)
    c, rows = 32, 200
    k = 3 * c
    mask = rng.random((rows, k)) < 0.3
    rank = np.cumsum(mask, axis=1) - mask
    s = np.where(mask, np.arange(k)[None, :] - rank, 0).astype(np.int32)
    f1 = rng.standard_normal((rows, k)).astype(np.float32)
    f2 = rng.integers(0, 1000, (rows, k)).astype(np.int32)

    ref = compact_window_pallas(jnp.asarray(s), [jnp.asarray(f1), jnp.asarray(f2)], c, interpret=True)
    cand = [torch.from_numpy(f1), torch.from_numpy(f2)]
    win = torch.stack([f.view(torch.int32) for f in cand])
    out = compact_kernel.compact_stacked(torch.from_numpy(s), torch.from_numpy(mask), win, c, last_fill=-7)
    got = [o.view(f.dtype) for o, f in zip(out, cand)]
    kept = np.arange(c)[None, :] < mask.sum(axis=1)[:, None]
    assert kept.any() and (~kept).any()
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(bits(g.numpy())[kept], bits(np.asarray(r))[kept])
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert (got[0].numpy()[~kept] == 0).all() and (got[1].numpy()[~kept] == -7).all()


def _pass_fixture(target=24, seed=0):
    """A 1,500-atom random fluid on its spill config with spill_target 24
    (about the mean occupancy, so half the cells shed and half have room),
    every atom then moved 0.4σ per axis along its velocity's sign so that
    many cross a face, some just past it (hold-backs) and some across the
    periodic seam."""
    n = 1500
    pos, box = random_fluid(n, 0.75, 0.85, seed)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    config = jcd.suggest_cell_dense_config(n, box, 2.5, 2.0, 0.3, spill=True)._replace(spill_target=target)
    st = jcd.cell_dense_init(pos, maxwell_boltzmann(n, 1.0, seed=seed + 1), np.ones(n), params, config)
    assert not bool(st.overflow)
    moved = jnp.where(st.valid[..., None], st.positions + 0.4 * jnp.sign(st.velocities), 0.0)
    boxf = jnp.float32(config.box)
    return st._replace(positions=moved - jnp.floor(moved / boxf) * boxf), config


def test_spill_routing_pass_matches_jax():
    """The z pass with spill on the fixture: fields on valid slots, the
    valid mask and the flag equal the reference's XLA pass bit for bit, and
    at least one spill, one hold-back and one seam wrap fire."""
    st, config = _pass_fixture()
    m, c = config.cells_per_dim, config.capacity
    valid = np.asarray(st.valid)
    fields = [st.positions[..., i] for i in range(3)] + [st.velocities[..., i] for i in range(3)]
    fields.append(st.atom_id)
    b = jnp.arange(m**3, dtype=jnp.int32) // (m * m)
    off = (0, 0, 1)
    eps = float(config.cell_side) - config.cutoff - config.skin
    ref_f, ref_v, ref_o = jcd._route_axis_pass(
        list(fields), st.valid, st.overflow, 2, b, m, config, eps,
        lambda x, d: jcd._roll_cells(x, tuple(d * o for o in off), m), box=jnp.float32(config.box),
    )
    got_f, got_v, got_o = tcd._route_axis_pass(
        [torch.from_numpy(np.array(f)) for f in fields], torch.from_numpy(valid.copy()),
        torch.from_numpy(np.array(st.overflow)), 2, torch.from_numpy(np.array(b)).long(), m, c,
        lambda x, d: tcd._roll_cells(x, tuple(d * o for o in off), m),
        torch.full((), config.box, dtype=torch.float32),
        spill=tcd._spill_params(config), last_fill=config.num_slots,
    )
    kept = np.asarray(ref_v)
    np.testing.assert_array_equal(got_v.numpy(), kept)
    assert bool(got_o) == bool(ref_o) is False
    for g, r in zip(got_f, ref_f):
        np.testing.assert_array_equal(bits(g.numpy())[kept], bits(np.asarray(r))[kept])
    assert (got_f[-1].numpy()[~kept] == config.num_slots).all()

    # Classify every atom by its z cell before (b0) and after (b1) the pass
    # and its true z cell t: a spill went from t to t+1, a hold-back stayed
    # in t+1, and a seam wrap left a coordinate below 0.
    cell_b = np.repeat(np.asarray(b), c).reshape(m**3, c)
    z0 = np.asarray(st.positions[..., 2])[valid]
    t = np.clip(np.floor(m * (z0 / config.box - np.floor(z0 / config.box))).astype(int), 0, m - 1)
    before = dict(zip(np.asarray(st.atom_id)[valid], zip(cell_b[valid], t)))
    after = zip(got_f[-1].numpy()[kept], cell_b[kept])
    spills = holds = 0
    for i, b1 in after:
        b0, ti = before[i]
        spills += int(b0 == ti and b1 == (ti + 1) % m)
        holds += int(b0 == (ti + 1) % m and b1 == b0)
    seam = int((got_f[2].numpy()[kept] < 0).sum())
    assert spills >= 1 and holds >= 1 and seam >= 1, (spills, holds, seam)
