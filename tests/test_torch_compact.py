"""The window compaction (K7) and the spill route of the port against the
JAX package: the plain version of `compact_kernel.compact_stacked` against
`compact_window_pallas` in interpret mode, one spill routing pass
(`cell_dense._route_axis_pass` with spill) against the reference's XLA
pass, and the spill route's entry (`compact_kernel.spill_routing`, three
passes on the caller's raw fields) against the reference's park and three
XLA passes.  All are pure data movement, so every kept slot is compared bit
for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.neighbors.pallas_compact import compact_window_pallas
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom
from emdee_tpu.utils.lattice import maxwell_boltzmann
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.neighbors import compact_kernel
from torch_port_utils import bits, random_fluid, spill_lattice_setup, to_port

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


def _pass_fixture(target=24, seed=0, capacity=None):
    """A 1,500-atom random fluid on its spill config with spill_target 24
    (about the mean occupancy, so half the cells shed and half have room),
    every atom then moved 0.4σ per axis along its velocity's sign so that
    many cross a face, some just past it (hold-backs) and some across the
    periodic seam; `capacity` replaces the suggested capacity."""
    n = 1500
    pos, box = random_fluid(n, 0.75, 0.85, seed)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    config = jcd.suggest_cell_dense_config(n, box, 2.5, 2.0, 0.3, spill=True)._replace(spill_target=target)
    if capacity is not None:
        config = config._replace(capacity=capacity)
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


def _reference_spill_route(fields, valid, config, box):
    """The reference's spill rebin (`_rebin_shift_core`'s XLA loop): the
    positions wrapped and parked at 0, then its three `_route_axis_pass`es
    with spill.  Returns (fields, valid, flag)."""
    m = config.cells_per_dim
    ids = jnp.arange(m**3, dtype=jnp.int32)
    eps = float(config.cell_side) - float(config.cutoff) - float(config.skin)
    fields = [jnp.asarray(np.array(f)) for f in fields]
    valid, ovf = jnp.asarray(np.array(valid)), jnp.zeros((), bool)
    for i in range(3):
        fields[i] = jnp.where(valid, fields[i] - jnp.floor(fields[i] / box) * box, 0.0)
    for axis, off, cf in ((0, (0, 0, 1), 2), (1, (0, 1, 0), 1), (2, (1, 0, 0), 0)):
        b = {2: ids % m, 1: (ids // m) % m, 0: ids // (m * m)}[axis]
        nbr = lambda x, d, off=off: jcd._roll_cells(x, tuple(d * o for o in off), m)  # noqa: E731
        fields, valid, ovf = jcd._route_axis_pass(fields, valid, ovf, cf, b, m, config, eps, nbr, box=box)
    return fields, valid, ovf


def _spill_route_case(case):
    """(JAX state, config) of a spill routing case: 'drifted', the
    1,728-atom lattice spill fixture of tests/test_cell_dense.py squeezed
    toward 27 and every atom moved 0.5σ per axis along its velocity's sign;
    'overflow', the same with every atom of the cells at y = 0 moved one
    cell up y, so that the middle (y) pass overflows; 'seam', `_pass_fixture`
    (spills, hold-backs and seam wraps fire); 'c40', the same fluid at
    C = 40 squeezed toward 28 (two chunks of 32 slots a cell)."""
    if case == "seam":
        return _pass_fixture()
    if case == "c40":
        st, config = _pass_fixture(target=28, capacity=40)
        return st, config
    pos, vel, params, config, _ = spill_lattice_setup()
    n = len(pos)
    config = config._replace(spill_target=27)
    st = jcd.cell_dense_init(pos, vel, np.ones(n), params, config)
    assert not bool(st.overflow)
    moved = jnp.where(st.valid[..., None], st.positions + 0.5 * jnp.sign(st.velocities), 0.0)
    if case == "overflow":
        m = config.cells_per_dim
        crowd = ((jnp.arange(m**3) // m) % m == 0)[:, None] & st.valid
        moved = moved.at[..., 1].add(jnp.where(crowd, float(config.cell_side), 0.0))
    return st._replace(positions=moved), config


@pytest.mark.parametrize("case", ["drifted", "overflow", "seam", "c40"])
def test_spill_routing_plain_matches_reference_passes(case):
    """The spill route's entry (`compact_kernel.spill_routing`, on CPU
    tensors its plain version) on the caller's raw fields — positions and
    velocities as strided views of their (M³, C, 3) tensors, unwrapped, the
    valid mask, the wrap — against the reference's park and three spill
    routing passes (JAX on the CPU): every field on the live slots, the
    valid mask and the flag, bit for bit; the fill (0, atom_id num_slots)
    elsewhere."""
    st, config = _spill_route_case(case)
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    ts = to_port(st)
    fields = [ts.positions[..., i] for i in range(3)] + [ts.velocities[..., i] for i in range(3)] + [ts.atom_id]
    got_f, got_v, got_o = compact_kernel.spill_routing(fields, config.box, m, c, ns, tcd._spill_params(config),
                                                       ts.valid)
    ref_f, ref_v, ref_o = _reference_spill_route(fields, ts.valid, config, jnp.float32(config.box))
    kept = np.asarray(ref_v)
    np.testing.assert_array_equal(got_v.numpy(), kept)
    assert bool(got_o) == bool(ref_o) == (case == "overflow")
    for i, (g, r) in enumerate(zip(got_f, ref_f)):
        np.testing.assert_array_equal(bits(g.numpy())[kept], bits(np.asarray(r))[kept], err_msg=f"field {i}")
        assert (g.numpy()[~kept] == (ns if i == len(fields) - 1 else 0)).all()
    moved = int(((got_f[-1] != ts.atom_id) & got_v).sum())
    assert moved > 100, moved
