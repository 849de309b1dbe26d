"""The port's cell list, neighbor list, neighbor-list force pass, exclusion
corrections and `make_force_fn` (`emdee_tpu_torch.neighbors.cell_list`,
`neighbor_list`, `neighbor_force`, `api`) against the JAX package's, on the
CPU.

Both sides get the same numpy inputs.  Cell ids, the stable sort order,
the cell table, the counts and the overflow flags equal JAX's bit for bit
(the box divides as a 0-d tensor, as the reference divides it).  The
neighbor list is compared as sets: the port takes the minimum image as
d − L·round(d/L) on raw differences, the reference as L·(s − round(s)) on
scaled ones, so only pairs within 1e-5 relative of the list cutoff may
differ.  Forces, energies and virials at the reference's tolerances (rtol
1e-4, atol 5e-4: tests/test_cell_dense.py:55-57; the list against
all-pairs with charges at tests/test_coulomb.py:96-99's atol 2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.neighbors import api as japi
from emdee_tpu.neighbors import cell_list as jcl
from emdee_tpu.neighbors import neighbor_force as jnf
from emdee_tpu.neighbors import neighbor_list as jnl
from emdee_tpu.potentials import coulomb as jc
from emdee_tpu.potentials.lennard_jones import LennardJonesModel as JModel
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom as jlj
from emdee_tpu.utils.lattice import cubic_lattice
from emdee_tpu_torch.core.types import ALL_OUTPUTS, NonbondedOutput, make_state
from emdee_tpu_torch.neighbors import api as tapi
from emdee_tpu_torch.neighbors import cell_list as tcl
from emdee_tpu_torch.neighbors import neighbor_force as tnf
from emdee_tpu_torch.neighbors import neighbor_list as tnl
from emdee_tpu_torch.potentials import coulomb as tc
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel as TModel
from emdee_tpu_torch.potentials.lennard_jones import lennard_jones_atom as tlj
from emdee_tpu_torch.tools import fixtures
from tests.oracle import allpairs_oracle

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _sample(n, density, seed, jitter=0.3):
    pos, box = cubic_lattice(n, density, jitter=jitter, seed=seed)
    return pos.astype(np.float32), float(np.float32(box))


def _cell_cases():
    pos, box = _sample(400, 0.5, 0)
    rng = np.random.default_rng(4)
    wild = rng.uniform(-12.0, 22.0, (300, 3)).astype(np.float32)  # far outside [0, L): wrapped
    edges = np.array([[0.0, 0.0, 0.0], [9.99, 9.99, 9.99], [5.0, 0.0, 0.0], [-0.1, 0.0, 0.0],
                      [np.nextafter(np.float32(10.0), np.float32(0.0))] * 3], np.float32)
    return [
        (pos, box, tcl.cells_per_dimension(box, 1.5, 2), 16),  # no overflow
        (wild, 10.0, 6, 4),  # overflow in the dense cells
        (edges, 10.0, 4, 2),  # the s → 1 edge, negative wrap
        (np.zeros((50, 3), np.float32), 10.0, 5, 8),  # everything in one cell
    ]


@pytest.mark.parametrize("case", range(4))
def test_cell_list_bit_for_bit(case):
    pos, box, m, cap = _cell_cases()[case]
    want = jcl.build_cell_list(jnp.asarray(pos), jnp.float32(box), cells_per_dim=m, capacity=cap)
    got = tcl.build_cell_list(_t(pos), box, cells_per_dim=m, capacity=cap)
    for name in ("cell_ids", "sorted_atoms", "cell_table", "cell_counts", "overflow"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(tcl.compute_cell_ids(_t(pos), box, m).numpy(),
                                  np.asarray(jcl.compute_cell_ids(jnp.asarray(pos), jnp.float32(box), m)))


def test_stencils_equal_the_reference():
    for m, ndiv, half in ((11, 2, False), (11, 2, True), (5, 1, False), (7, 3, True)):
        off = tcl.stencil_offsets(m, ndiv, half)
        np.testing.assert_array_equal(off, jcl.stencil_offsets(m, ndiv, half))
        np.testing.assert_array_equal(tcl.stencil_cell_ids(m, off, "cpu").numpy(),
                                      np.asarray(jcl.stencil_cell_ids(m, off)))
    assert tcl.suggest_capacity(1000, 343) == jcl.suggest_capacity(1000, 343)
    assert tnl.estimate_max_neighbors(1000, 11.0, 2.9) == jnl.estimate_max_neighbors(1000, 11.0, 2.9)


def _pair_sets(idx, n):
    return [set(row[row < n].tolist()) for row in np.asarray(idx)]


@pytest.mark.parametrize("n,density,cutoff,cap_nbrs", [(350, 0.6, 1.6, 48), (1000, 0.8, 2.9, 24)])
def test_neighbor_list_sets_match_jax(n, density, cutoff, cap_nbrs):
    """Membership as sets, pairs within 1e-5 relative of the list cutoff
    excused; overflow flags equal (the second case overflows K)."""
    pos, box = _sample(n, density, seed=2, jitter=0.2)
    m = tcl.cells_per_dimension(box, cutoff, 2)
    kw = dict(cells_per_dim=m, cell_capacity=24, max_neighbors=cap_nbrs)
    want = jnl.build_neighbor_list(jnp.asarray(pos), jnp.float32(box), cutoff, **kw)
    got = tnl.build_neighbor_list(_t(pos), box, cutoff, **kw)
    assert bool(got.overflow) == bool(want.overflow)
    assert got.cell_capacity == want.cell_capacity and got.max_neighbors == want.max_neighbors
    assert torch.equal(got.ref_positions, _t(pos))
    if bool(want.overflow):
        return
    p = pos.astype(np.float64)
    for i, (g, w) in enumerate(zip(_pair_sets(got.idx.numpy(), n), _pair_sets(want.idx, n))):
        for j in g ^ w:
            d = p[i] - p[j]
            d -= box * np.round(d / box)
            assert abs(np.sqrt((d * d).sum()) / cutoff - 1.0) < 1e-5, (i, j)
    assert sum(len(s) for s in _pair_sets(got.idx.numpy(), n)) > 10 * n


def test_needs_rebuild_trips_where_jax_trips():
    pos, box = _sample(100, 0.5, 0)
    m = tcl.cells_per_dimension(box, 1.5, 2)
    kw = dict(cells_per_dim=m, cell_capacity=16, max_neighbors=48)
    want = jnl.build_neighbor_list(jnp.asarray(pos), jnp.float32(box), 1.5, **kw)
    got = tnl.build_neighbor_list(_t(pos), box, 1.5, **kw)
    for atom, axis, shift, skin in ((0, 0, 0.0, 0.4), (0, 0, 0.19, 0.4), (0, 0, 0.21, 0.4), (0, 0, 0.21, 0.5),
                                    (7, 2, -0.3, 0.5), (99, 1, box - 0.1, 0.4), (99, 1, box - 0.3, 0.4)):
        moved = pos.copy()
        moved[atom, axis] += shift
        j = bool(jnl.needs_rebuild(want, jnp.asarray(moved), jnp.float32(box), skin))
        t = bool(tnl.needs_rebuild(got, _t(moved), box, skin))
        assert t == j, (atom, axis, shift, skin)


def _force_fns(n, box, charges=None, **cfg):
    kw = dict(cutoff=2.5, switch=2.0, method="neighbor_list", skin=0.4, **cfg)
    jnb = japi.make_force_fn(japi.NonbondedConfig(**kw), jlj(np.ones(n), np.ones(n)), box, n, charges=charges)
    tnb = tapi.make_force_fn(tapi.NonbondedConfig(**kw), tlj(np.ones(n), np.ones(n), device="cpu"), box, n,
                             charges=charges, device="cpu")
    return jnb, tnb


@pytest.mark.parametrize("charged", [False, True])
@pytest.mark.parametrize("n,density,jitter", [(500, 0.4, 0.2), (1728, 0.8, 0.1)])
def test_neighbor_list_forces_match_jax(n, density, jitter, charged):
    """`make_force_fn(method='neighbor_list')`'s init and compute against
    JAX's, with and without DSF charges, at rtol 1e-4, atol 5e-4.  At
    ρ = 0.8 the lattice is jittered by 0.1, not by the 0.2 of
    tests/test_cell_list.py:143: there the force scale is 8,389 and JAX's
    own scaled minimum image misses this tolerance against the float64
    oracle (the next test holds the port to the oracle on that fixture)."""
    pos, box = _sample(n, density, seed=3, jitter=jitter)
    q = None
    cfg = {}
    if charged:
        q = np.random.default_rng(6).choice([0.4, -0.4], size=n)
        q -= q.mean()
        cfg = dict(coulomb_alpha=0.25, coulomb_constant=1.0)
    jnb, tnb = _force_fns(n, box, q, **cfg)
    want = jnb.compute(jnp.asarray(pos), jnb.init(jnp.asarray(pos)))
    aux = tnb.init(_t(pos))
    assert not bool(aux.overflow)
    got = tnb.compute(_t(pos), aux, outputs=ALL_OUTPUTS)
    for name in ("forces", "energies", "virials"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=1e-4,
                                   atol=5e-4, err_msg=name)
    # The block size changes no bit.
    coul = None if q is None else tc.DSFCoulomb.create(2.5, 0.25, 1.0, device="cpu")
    blocks = tnf.compute_nonbonded_neighborlist(_t(pos), box, tnb.model, tlj(np.ones(n), np.ones(n), device="cpu"),
                                                aux, None if q is None else _t(q), coul, atom_chunk=128)
    for name in ("forces", "energies", "virials"):
        assert torch.equal(getattr(blocks, name), getattr(got, name)), name


def test_neighbor_list_forces_match_oracle_at_the_reference_fixture():
    """tests/test_cell_list.py:143's (1728, 0.8) fixture (jitter 0.2, force
    scale 8,389): the port's list forces, energies and virials against the
    float64 all-pairs oracle at rtol 1e-4, atol 5e-4."""
    pos, box = _sample(1728, 0.8, seed=3, jitter=0.2)
    _, tnb = _force_fns(1728, box)
    got = tnb.compute(_t(pos), tnb.init(_t(pos)))
    for name, want in zip(("forces", "energies", "virials"), allpairs_oracle(pos, box, 2.5, 2.0, 0.5, 2.0)):
        np.testing.assert_allclose(getattr(got, name).numpy(), want, rtol=1e-4, atol=5e-4, err_msg=name)


def test_charged_neighbor_list_matches_allpairs():
    """tests/test_coulomb.py:76-99 on the port: LJ + DSF through the list
    against the port's all-pairs, rtol 1e-4, atol 2e-4."""
    n = 1000
    pos, box = _sample(n, 0.5, seed=6, jitter=0.15)
    q = np.random.default_rng(6).choice([0.4, -0.4], size=n)
    q -= q.mean()
    kw = dict(cutoff=2.5, switch=2.0, coulomb_alpha=0.25, coulomb_constant=1.0)
    params = tlj(np.ones(n), np.ones(n), device="cpu")
    ap = tapi.make_force_fn(tapi.NonbondedConfig(method="allpairs", **kw), params, box, n, charges=q, device="cpu")
    nl = tapi.make_force_fn(tapi.NonbondedConfig(method="neighbor_list", skin=0.4, **kw), params, box, n, charges=q,
                            device="cpu")
    ref = ap.compute(_t(pos), ())
    out = nl.compute(_t(pos), nl.init(_t(pos)))
    for name in ("forces", "energies"):
        np.testing.assert_allclose(getattr(out, name).numpy(), getattr(ref, name).numpy(), rtol=1e-4, atol=2e-4,
                                   err_msg=name)


def test_exclusion_corrections_match_jax():
    """`apply_exclusion_corrections` on the 864-atom charged fixture's
    exclusions (LJ and Coulomb 1-4 scales, two pad pairs (N, N)) against
    JAX's, on the same base output; the fixed-order add reruns bitwise."""
    a = fixtures.charged_arrays()
    n = a["n"]
    pos = a["pos"].astype(np.float32)
    pairs = np.concatenate([a["pairs"], [[n, n], [n, n]]]).astype(np.int32)
    ljs = np.concatenate([a["ljs"], [0.0, 0.0]]).astype(np.float32)
    cs = np.concatenate([a["cs"], [0.0, 0.0]]).astype(np.float32)
    rng = np.random.default_rng(9)
    base = (rng.normal(size=(n, 3)), rng.normal(size=n), rng.normal(size=n))
    base = tuple(b.astype(np.float32) for b in base)
    jcoul = jc.DSFCoulomb.create(2.5, alpha=0.25, coulomb_constant=1.0)
    want = jnf.apply_exclusion_corrections(
        jnf.NonbondedOutput(*(jnp.asarray(b) for b in base)), jnp.asarray(pos), jnp.float32(a["box"]),
        JModel.create(2.5, 2.0), jlj(np.ones(n), np.ones(n)), jnp.asarray(pairs), jnp.asarray(ljs),
        jnp.asarray(a["q"]), jcoul, jnp.asarray(cs))
    args = (NonbondedOutput(*(torch.from_numpy(b) for b in base)), _t(pos), a["box"],
            TModel.create(2.5, 2.0, device="cpu"), tlj(np.ones(n), np.ones(n), device="cpu"),
            torch.from_numpy(pairs), torch.from_numpy(ljs), torch.from_numpy(a["q"]),
            tc.coulomb_from_numpy(jax.device_get(jcoul), "cpu"), torch.from_numpy(cs))
    got = tnf.apply_exclusion_corrections(*args)
    again = tnf.apply_exclusion_corrections(*args, plan=tnf.exclusion_plan(torch.from_numpy(pairs), n))
    for name in ("forces", "energies", "virials"):
        g = getattr(got, name)
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)), rtol=1e-4, atol=5e-4, err_msg=name)
        assert torch.equal(g, getattr(again, name)), name
    assert float((got.energies - torch.from_numpy(base[1])).abs().max()) > 1e-2  # the corrections act


def test_resolve_method_and_init_capacity_doubling():
    """`'auto'` resolves as JAX's does; an initial capacity too small for
    the list doubles in `init` to the capacities JAX's init reaches."""
    cfg = dict(cutoff=2.5, switch=2.0, skin=0.3)
    for box, n in ((6.0, 100), (12.0, 200), (12.0, 1000), (14.0, 256), (40.0, 5000)):
        assert tapi.resolve_method(tapi.NonbondedConfig(**cfg), box, n) == japi.resolve_method(
            japi.NonbondedConfig(**cfg), box, n)
    n = 1000
    pos, box = _sample(n, 0.8, seed=3, jitter=0.2)
    jnb, tnb = _force_fns(n, box, max_neighbors=8, cell_capacity_multiplier=0.3)
    want = jnb.init(jnp.asarray(pos))
    got = tnb.init(_t(pos))
    assert not bool(got.overflow)
    assert (got.max_neighbors, got.cell_capacity) == (want.max_neighbors, want.cell_capacity)
    assert got.max_neighbors > 8


def test_entry_points_need_a_card_or_a_device(monkeypatch):
    """`make_state` and `make_force_fn` build on the CUDA card unless a
    device is named; without a card they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pos, box = _sample(300, 0.5, 1)
    config = tapi.NonbondedConfig(cutoff=2.5, switch=2.0)
    params = tlj(np.ones(300), np.ones(300), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_state(pos, box=box)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.make_force_fn(config, params, box, 300)
    st = make_state(pos, box=box, device="cpu")
    assert st.positions.device.type == "cpu" and st.box.dim() == 0 and st.step.dtype == torch.int32
    assert tapi.make_force_fn(config, params, box, 300, device="cpu").model.rc2.device.type == "cpu"
    with pytest.raises(ValueError, match="dense-cell engine"):
        tapi.NonbondedConfig(cutoff=2.5, switch=2.0, method="pallas")
