"""The port's bonded terms (`emdee_tpu_torch.potentials.bonded`) and the
exclusive/shared split of the molecular engine against the JAX package's:
energies, virials and force rows on the cases of tests/test_bonded.py:34-107
and :141 (tolerances as there; force rows 2e-6 of the force scale), the hand
gradients against `torch.autograd`, `remap`, and on the system of
tests/test_exclusive_split.py the partition and the scatter-set plus
fixed-order add equal to one merged fixed-order add bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.neighbors import cell_dense_molecular as jmol
from emdee_tpu.potentials import bonded as jb
from emdee_tpu_torch.core.scatter import add_plan, fixed_add
from emdee_tpu_torch.neighbors import cell_dense_molecular as tmol
from emdee_tpu_torch.potentials import bonded as tb

torch.set_num_threads(2)

BOX = 100.0


def _port(system):
    return tb.bonded_from_numpy(jax.device_get(system), "cpu")


def _box(v):
    return torch.tensor(v, dtype=torch.float32)


def _both(pos):
    return jnp.asarray(pos, jnp.float32), torch.tensor(np.asarray(pos, np.float32))


def _bond(pairs, r0, k):
    m = len(pairs)
    return jb.BondTable(jnp.asarray(pairs, jnp.int32), jnp.asarray(r0, jnp.float32), jnp.asarray(k, jnp.float32),
                        jnp.ones(m, bool))


def _angle(atoms, theta0, k):
    return jb.AngleTable(jnp.asarray(atoms, jnp.int32), jnp.asarray(theta0, jnp.float32),
                         jnp.asarray(k, jnp.float32), jnp.ones(len(atoms), bool))


def _torsion(atoms, per, phase, k):
    return jb.TorsionTable(jnp.asarray(atoms, jnp.int32), jnp.asarray(per, jnp.int32),
                           jnp.asarray(phase, jnp.float32), jnp.asarray(k, jnp.float32), jnp.ones(len(atoms), bool))


CASES = {
    # test_bonded.py:34: a stretched bond, E = ½·100·0.5².
    "bond": (np.array([[0.0, 0, 0], [1.5, 0, 0]]), BOX,
             jb.BondedSystem(_bond([(0, 1)], [1.0], [100.0]), None, None, None), 0.5 * 100 * 0.5**2),
    # :51: across the periodic boundary, distance 0.4 = r0.
    "bond_pbc": (np.array([[0.2, 0, 0], [9.8, 0, 0]]), 10.0,
                 jb.BondedSystem(_bond([(0, 1)], [0.4], [100.0]), None, None, None), 0.0),
    # :59: a right angle against θ0 = π/3.
    "angle": (np.array([[1.0, 0, 0], [0.0, 0, 0], [0.0, 1.0, 0]]), BOX,
              jb.BondedSystem(None, _angle([[0, 1, 2]], [np.pi / 3], [10.0]), None, None),
              0.5 * 10 * (np.pi / 2 - np.pi / 3) ** 2),
    # :71: planar cis, φ = 0, E = 4(1 + cos(−π)).
    "torsion": (np.array([[1.0, 1.0, 0], [0.0, 0.9, 0], [0.0, -1.0, 0], [1.0, -1.1, 0]]), BOX,
                jb.BondedSystem(None, None, _torsion([[0, 1, 2, 3]], [[2, 0]], [[np.pi, 0.0]], [[4.0, 0.0]]), None),
                4.0 * (1 + np.cos(-np.pi))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_energy_virial_forces_match_jax(case):
    pos, box, system, e_expect = CASES[case]
    jp, tp = _both(pos)
    tsys = _port(system)
    e = float(tsys.energy(tp, _box(box)))
    assert e == pytest.approx(e_expect, rel=1e-4, abs=1e-4)
    assert e == pytest.approx(float(system.energy(jp, jnp.float32(box))), rel=1e-5, abs=1e-5)
    assert float(tsys.virial(tp, _box(box))) == pytest.approx(float(system.virial(jp, jnp.float32(box))),
                                                              rel=1e-5, abs=1e-5)
    f = tsys.force_fn()(tp, _box(box)).numpy()
    np.testing.assert_allclose(f, np.asarray(system.force_fn()(jp, jnp.float32(box))), atol=1e-3)


def test_bond_force_direction():
    """A stretched bond pulls its atoms together: F = k(r − r0) = 50."""
    _, tp = _both([[0.0, 0, 0], [1.5, 0, 0]])
    f = _port(CASES["bond"][2]).force_fn()(tp, _box(BOX)).numpy()
    np.testing.assert_allclose(f, [[50.0, 0, 0], [-50.0, 0, 0]], atol=1e-3)


def test_torsion_forces_finite_difference():
    rng = np.random.default_rng(0)
    pos = (rng.normal(0, 1, (4, 3)) * 1.5).astype(np.float32)
    system = jb.BondedSystem(None, None, _torsion([[0, 1, 2, 3]], [[1, 3]], [[0.0, np.pi]], [[2.0, 0.7]]), None)
    tsys = _port(system)
    f = tsys.force_fn()(torch.from_numpy(pos), _box(BOX)).numpy()
    eps = 1e-3
    for a in range(4):
        for d in range(3):
            pp, pm = pos.copy(), pos.copy()
            pp[a, d] += eps
            pm[a, d] -= eps
            fd = -(float(tsys.energy(torch.from_numpy(pp), _box(BOX))) -
                   float(tsys.energy(torch.from_numpy(pm), _box(BOX)))) / (2 * eps)
            assert f[a, d] == pytest.approx(fd, abs=2e-2)


def _random_system():
    """test_bonded.py:141's system: 60 atoms, 21 bonds, 17 angles, 13
    torsions (used again as impropers), padded to multiples of 8."""
    rng = np.random.default_rng(0)
    n = 60
    pos = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    pad8 = lambda k: max(8, -(-k // 8) * 8)  # noqa: E731

    def rows(count, arity, cap):
        out = np.full((cap, arity), n, np.int32)
        for r in range(count):
            out[r] = rng.choice(n, arity, replace=False)
        return out

    nb, na, nt = 21, 17, 13
    cb, ca, ct = pad8(nb), pad8(na), pad8(nt)
    bonds = jb.BondTable(jnp.asarray(rows(nb, 2, cb)), jnp.asarray(rng.uniform(0.8, 1.5, cb).astype(np.float32)),
                         jnp.asarray(rng.uniform(10, 50, cb).astype(np.float32)), jnp.asarray(np.arange(cb) < nb))
    angles = jb.AngleTable(jnp.asarray(rows(na, 3, ca)), jnp.asarray(rng.uniform(1.5, 2.2, ca).astype(np.float32)),
                           jnp.asarray(rng.uniform(10, 40, ca).astype(np.float32)), jnp.asarray(np.arange(ca) < na))
    tors = jb.TorsionTable(
        atoms=jnp.asarray(rows(nt, 4, ct)),
        periodicity=jnp.asarray(rng.integers(1, 4, (ct, 3)).astype(np.int32)),
        phase=jnp.asarray(rng.uniform(0, 3.1, (ct, 3)).astype(np.float32)),
        k=jnp.asarray(rng.uniform(1, 8, (ct, 3)).astype(np.float32)),
        valid=jnp.asarray(np.arange(ct) < nt),
    )
    return pos, jb.BondedSystem(bonds=bonds, angles=angles, torsions=tors, impropers=tors)


def test_force_rows_match_jax_and_autograd():
    """`bonded_force_rows` equals JAX's row for row (indices exactly, rows
    within 2e-6 of the force scale); the folded analytic forces equal
    −∇E by `torch.autograd` (test_bonded.py:141's tolerance), pad rows
    included."""
    pos, system = _random_system()
    tsys = _port(system)
    box = 10.0
    ji, jr = jb.bonded_force_rows(jnp.asarray(pos), jnp.float32(box), system)
    ti, tr = tb.bonded_force_rows(torch.from_numpy(pos), _box(box), tsys)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    scale = max(np.abs(np.asarray(jr)).max(), 1.0)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-6 * scale)

    p = torch.from_numpy(pos).requires_grad_(True)
    f_auto = -torch.autograd.grad(tsys.energy(p, _box(box)), p)[0].numpy()
    f_ana = tb.bonded_forces_analytic(torch.from_numpy(pos), _box(box), tsys).numpy()
    scale = max(np.abs(f_auto).max(), 1.0)
    np.testing.assert_allclose(f_ana, f_auto, atol=2e-6 * scale)
    np.testing.assert_allclose(f_ana, np.asarray(jb.bonded_forces_analytic(jnp.asarray(pos), jnp.float32(box), system)),
                               atol=2e-6 * scale)


def test_remap_matches_jax():
    _, system = _random_system()
    index_map = np.random.default_rng(4).permutation(61).astype(np.int32)
    j = jax.device_get(system.remap(jnp.asarray(index_map)))
    t = _port(system).remap(torch.from_numpy(index_map))
    for name in ("bonds", "angles", "torsions", "impropers"):
        np.testing.assert_array_equal(getattr(t, name).atoms.numpy(), np.asarray(getattr(j, name).atoms), name)


def _split_system(n):
    """tests/test_exclusive_split.py's system: 3 waters (one exclusive angle
    each) + a 4-atom chain whose angles share atoms, + a bond on it."""
    angles = jb.AngleTable(
        atoms=jnp.asarray([[1, 0, 2], [4, 3, 5], [7, 6, 8], [9, 10, 11], [10, 11, 12]] + [[n] * 3] * 3, jnp.int32),
        theta0=jnp.asarray([1.9, 1.9, 1.9, 2.0, 2.0, 0, 0, 0], jnp.float32),
        k=jnp.asarray([400.0, 400.0, 400.0, 300.0, 250.0, 0, 0, 0], jnp.float32),
        valid=jnp.asarray([True] * 5 + [False] * 3),
    )
    bonds = jb.BondTable(jnp.asarray([[9, 10]] + [[n] * 2] * 7, jnp.int32),
                         jnp.asarray([1.2] + [0.0] * 7, jnp.float32), jnp.asarray([500.0] + [0.0] * 7, jnp.float32),
                         jnp.asarray([True] + [False] * 7))
    return jb.BondedSystem(bonds=bonds, angles=angles, torsions=None, impropers=None)


@pytest.mark.parametrize("leftover", [None, [[4, 12]]])
def test_split_exclusive_terms_match_jax(leftover):
    """The partition equals JAX's table for table; a leftover pair touching
    atom 4 demotes the second water's angle (test_exclusive_split.py)."""
    n = 13
    system = _split_system(n)
    lo = None if leftover is None else np.asarray(leftover)
    je, js = jmol._split_exclusive_terms(system, lo, n)
    te, ts = tmol._split_exclusive_terms(_port(system), lo, n)
    for jsys, tsys in ((je, te), (js, ts)):
        for name in ("bonds", "angles", "torsions", "impropers"):
            jt, tt = getattr(jsys, name), getattr(tsys, name)
            assert (jt is None) == (tt is None), name
            if jt is not None:
                for field, a in jt._asdict().items():
                    np.testing.assert_array_equal(getattr(tt, field).numpy(), np.asarray(a), f"{name}.{field}")
    assert int(te.angles.valid.sum()) == (3 if leftover is None else 2)


def test_set_plus_add_matches_merged_add():
    """Exclusive rows written by a scatter-set plus the shared rows folded by
    the fixed-order add equal the fixed-order add of all rows bit for bit;
    both equal JAX's merged scatter-add within float32 rounding."""
    n = 13
    system = _split_system(n)
    excl, shared = tmol._split_exclusive_terms(_port(system), None, n)
    pos = np.random.default_rng(3).uniform(0, 9.0, (n + 1, 3)).astype(np.float32)
    tp, box = torch.from_numpy(pos), _box(9.0)

    idx, rows = tb.bonded_force_rows(tp, box, _port(system))
    ref = fixed_add(torch.zeros_like(tp), add_plan(idx, n + 1), rows)
    ix, rx = tb.bonded_force_rows(tp, box, excl)
    f = torch.zeros_like(tp).index_put((ix,), rx)
    i_s, r_s = tb.bonded_force_rows(tp, box, shared)
    f = fixed_add(f, add_plan(i_s, n + 1), r_s)
    assert torch.equal(f[:-1], ref[:-1])
    ji, jr = jb.bonded_force_rows(jnp.asarray(pos), jnp.float32(9.0), system)
    jref = np.asarray(jnp.zeros_like(jnp.asarray(pos)).at[ji].add(jr))
    np.testing.assert_allclose(ref[:-1].numpy(), jref[:-1], rtol=1e-6, atol=1e-4)


def test_forces_into_match_jax():
    """`bond_forces_into`, `angle_forces_into` and `torsion_forces_into`
    against JAX's on the triatomic fixture (`tools/fixtures.py`: its bonds
    and angles, and a torsion over each molecule and the next molecule's
    first atom), each added onto the same random forces, within 2e-6 of
    the force scale (as the rows are held)."""
    from emdee_tpu_torch.tools.fixtures import triatomic_arrays, triatomic_bonded
    from torch_port_utils import jax_triatomic_bonded

    fx = triatomic_arrays()
    n, box = fx["n"], fx["box"]
    pos = fx["pos"].astype(np.float32)
    base = np.random.default_rng(8).normal(size=(n, 3)).astype(np.float32)
    a = fx["angles"]
    quad = np.concatenate([a, np.roll(a[:, :1], -1, axis=0)], axis=1)
    t = len(quad)
    jtors = _torsion(quad, np.tile([[1, 3]], (t, 1)), np.tile([[0.3, np.pi]], (t, 1)), np.tile([[2.0, 0.7]], (t, 1)))
    jsys, tsys = jax_triatomic_bonded(fx), triatomic_bonded(fx, "cpu")
    cases = ((jb.bond_forces_into, tb.bond_forces_into, jsys.bonds, tsys.bonds),
             (jb.angle_forces_into, tb.angle_forces_into, jsys.angles, tsys.angles),
             (jb.torsion_forces_into, tb.torsion_forces_into, jtors, _port(jb.BondedSystem(None, None, jtors, None)).torsions))
    for jfn, tfn, jtab, ttab in cases:
        want = np.asarray(jfn(jnp.asarray(base), jnp.asarray(pos), jnp.float32(box), jtab))
        got = tfn(torch.from_numpy(base), torch.from_numpy(pos), _box(box), ttab).numpy()
        scale = max(np.abs(want - base).max(), 1.0)
        assert np.abs(want - base).max() > 1.0  # the terms move the forces
        np.testing.assert_allclose(got, want, atol=2e-6 * scale, err_msg=tfn.__name__)
