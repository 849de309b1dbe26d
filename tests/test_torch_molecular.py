"""The molecular dense engine of the port (`emdee_tpu_torch.neighbors.
cell_dense_molecular`, the molecular branches of `cell_dense`) against the
JAX package's, on the CPU.

- The tag tables and their slot gather equal JAX's array for array,
  including the band split and the bond piggyback of
  tests/test_cell_dense_molecular.py:294-330.
- The plain `cell_dense_forces` with DSF Coulomb and exclusion tags against
  JAX's `cell_dense_forces` on the 864-atom fixture of
  tests/test_pallas_kernel.py:110-160 (forces within 2e-4 of the force
  scale, energies and virials within 1e-3), and with bond tags against
  JAX's interpret-mode kernel `pallas_cell_forces(excl=aux+bond)`.
- Rollouts on the triatomic fixture of tests/test_grid_sharded_pallas.py:
  36-104 (375 atoms, band 1: leftover pairs, shared and exclusive terms,
  bonds and angles): the port's 'torch' path against JAX's 'xla' (positions
  and velocities within 2e-4, energies within 1e-6 relative), and the
  port's absorbed-bond path against JAX's 'pallas_interpret' (the same
  tolerances), each side to the other's gather path at
  tests/test_cell_dense_molecular.py:363-368's 2e-3 / 5e-2.
- Charges ride every rebin bit for bit; the water box of `tools/water.py`
  at full width resolves to the resident kernel family."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.neighbors import cell_dense_molecular as jmol
from emdee_tpu.neighbors.pallas_cell_kernel import pallas_cell_forces
from emdee_tpu.potentials import bonded as jb
from emdee_tpu.potentials import coulomb as jc
from emdee_tpu.potentials.lennard_jones import LennardJonesModel as JModel
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom as jlj
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.neighbors import cell_dense_molecular as tmol
from emdee_tpu_torch.neighbors import cell_kernel
from emdee_tpu_torch.potentials import bonded as tb
from emdee_tpu_torch.potentials import coulomb as tc
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel as TModel
from emdee_tpu_torch.potentials.lennard_jones import lennard_jones_atom as tlj
from emdee_tpu_torch.tools import fixtures
from torch_port_utils import bits, drifted_state, to_port

torch.set_num_threads(2)

TMODEL = TModel.create(2.5, 2.0, device="cpu")
JMODEL = JModel.create(2.5, 2.0)
STEPS, REBIN_EVERY, DT = 20, 5, 1e-3


def _port_tags(tags):
    """JAX slot tags (ids, mlj, mcs[, bond]) → port tensors."""
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    out = (t(tags[0]), t(tags[1]), t(tags[2]))
    return out + ((tuple(t(a) for a in tags[3]),) if len(tags) > 3 else ())


# ---------------------------------------------------------------------------
# Tag tables
# ---------------------------------------------------------------------------


def _triatomic():
    """tests/test_grid_sharded_pallas.py's 125 bent triatomics (A-B-C) on a
    5³ lattice (`tools/fixtures.py`), with JAX's bonded system and config."""
    fx = fixtures.triatomic_arrays()
    nb, na = len(fx["bond_pairs"]), len(fx["angles"])
    fx["bonded"] = jb.BondedSystem(
        bonds=jb.BondTable(jnp.asarray(fx["bond_pairs"], jnp.int32), jnp.full((nb,), fx["bond_r0"], jnp.float32),
                           jnp.full((nb,), fx["bond_k"], jnp.float32), jnp.ones((nb,), bool)),
        angles=jb.AngleTable(jnp.asarray(fx["angles"], jnp.int32), jnp.full((na,), fx["angle_theta0"], jnp.float32),
                             jnp.full((na,), fx["angle_k"], jnp.float32), jnp.ones((na,), bool)),
        torsions=None, impropers=None,
    )
    fx["config"] = jcd.suggest_cell_dense_config(fx["n"], fx["box"], cutoff=2.5, switch=2.0, skin=0.3)
    return fx


def _assert_tables_equal(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if isinstance(w, tuple):
            _assert_tables_equal(g, w)
        elif w is not None:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("variant", ["wide", "band", "bonds"])
def test_exclusion_tables_match_jax(variant):
    """`build_exclusion_tables` equals JAX's, array for array: full width,
    band 1 with its leftover pairs, and bonds riding the tags."""
    fx = _triatomic()
    args = (fx["n"], fx["pairs"], fx["ljs"], fx["cs"])
    kw = {"band": {"band_e": 1}, "wide": {}}.get(variant)
    if kw is None:
        bt = fx["bonded"].bonds
        kw = {"band_e": 1, "bonds": (np.asarray(bt.atoms), np.asarray(bt.k), np.asarray(bt.length))}
    want = jmol.build_exclusion_tables(*args, **kw)
    got = tmol.build_exclusion_tables(*args, **kw)
    _assert_tables_equal(got, want)
    if variant != "wide":
        assert got[1][0].shape[0] > 0  # the band leaves real leftover pairs


def test_build_exclusion_tables_bond_piggyback():
    """tests/test_cell_dense_molecular.py:294-330 on the port: bonded pairs
    take the tag prefix with their (k, k·r0, k·r0²) weights, absorption is
    reported per bond, and every array equals JAX's."""
    n = 6
    pairs = np.asarray([[1, 2], [0, 1], [0, 2], [3, 4]], np.int32)
    scales = np.zeros(4, np.float32)
    bonds = (np.asarray([[0, 1], [2, 0], [3, 4], [4, 5]], np.int32), np.asarray([100.0, 200.0, 300.0, 400.0]),
             np.asarray([1.0, 1.5, 2.0, 2.5]))
    tabs, leftover, bond_tabs, absorbed = tmol.build_exclusion_tables(n, pairs, scales, None, bonds=bonds)
    _assert_tables_equal((tabs, leftover, bond_tabs, absorbed),
                         jmol.build_exclusion_tables(n, pairs, scales, None, bonds=bonds))
    ids = tabs[0]
    kb, kr0, kr02 = bond_tabs
    np.testing.assert_array_equal(absorbed, [True, True, True, False])
    assert leftover[0].shape[0] == 0
    assert set(ids[0, :2].astype(int)) == {1, 2}
    for e in range(2):
        k_expect, r0_expect = (100.0, 1.0) if int(ids[0, e]) == 1 else (200.0, 1.5)
        assert kb[0, e] == pytest.approx(k_expect)
        assert kr0[0, e] == pytest.approx(k_expect * r0_expect)
        assert kr02[0, e] == pytest.approx(k_expect * r0_expect**2)
    assert kb[1, int(np.flatnonzero(ids[1] == 2.0)[0])] == 0.0
    assert kb.shape[-1] <= ids.shape[-1]


def test_aux_fn_matches_jax():
    """The slot gather of the tags (with bond weights) equals JAX's on a
    state, empty slots on the pad row; every table is contiguous."""
    fx = _triatomic()
    bt = fx["bonded"].bonds
    tabs, _, bond_tabs, _ = jmol.build_exclusion_tables(
        fx["n"], fx["pairs"], fx["ljs"], fx["cs"], band_e=1,
        bonds=(np.asarray(bt.atoms), np.asarray(bt.k), np.asarray(bt.length)))
    js = jcd.cell_dense_init(fx["pos"], fx["vel"], np.ones(fx["n"]), jlj(np.ones(fx["n"]), np.ones(fx["n"])),
                             fx["config"], charges=fx["q"])
    want = jmol.make_exclusion_aux_fn(fx["n"], *tabs, bond_tabs=bond_tabs)(js)
    got = tmol.make_exclusion_aux_fn(fx["n"], *(np.asarray(t) for t in tabs),
                                     bond_tabs=tuple(np.asarray(t) for t in bond_tabs))(to_port(js))
    _assert_tables_equal(got, want)
    assert all(t.is_contiguous() for t in (*got[:3], *got[3]))


# ---------------------------------------------------------------------------
# The plain force pass
# ---------------------------------------------------------------------------


def _charged_fixture():
    """tests/test_pallas_kernel.py:110-160: 864 atoms, ±0.3 charges,
    synthetic triplet exclusions (0 and 0.5/0.8 scales), and harmonic bonds
    on the (i, i+1) pairs (k = 40, r0 = 1.1) for the bond branch
    (`tools/fixtures.py`), as a JAX state."""
    a = fixtures.charged_arrays()
    n = a["n"]
    config = jcd.suggest_cell_dense_config(n, a["box"], cutoff=2.5, switch=2.0, skin=0.3)
    coul = jc.DSFCoulomb.create(2.5, alpha=0.25, coulomb_constant=1.0)
    st = jcd.cell_dense_init(a["pos"], a["vel"], np.ones(n), jlj(np.ones(n), np.ones(n)), config, charges=a["q"])
    return st, config, coul, n, a["pairs"], a["ljs"], a["cs"], a["bonds"]


def _close_forces(got, want, valid, scale=None):
    f, e, w = (a.numpy() for a in got)
    fr, er, wr = (np.asarray(a) for a in want)
    scale = scale or max(np.abs(fr[valid]).max(), 1.0)
    np.testing.assert_allclose(f[valid], fr[valid], atol=2e-4 * scale)
    np.testing.assert_allclose(e[valid], er[valid], atol=1e-3)
    np.testing.assert_allclose(w[valid], wr[valid], atol=1e-3)
    assert (f[~valid] == 0).all() and (e[~valid] == 0).all() and (w[~valid] == 0).all()


def test_plain_forces_coulomb_tags_match_jax():
    """DSF + exclusion tags (Coulomb scales given, and defaulting to the LJ
    scales) against JAX's `cell_dense_forces`; the tags change the energy."""
    st, config, coul, n, pairs, ljs, cs, _ = _charged_fixture()
    ts = to_port(st)
    tcoul = tc.coulomb_from_numpy(jax.device_get(coul), "cpu")
    valid = np.asarray(st.valid)
    for scales in (cs, None):
        tabs = jmol.build_exclusion_tables(n, pairs, ljs, scales)
        aux = jmol.make_exclusion_aux_fn(n, *tabs)(st)
        want = jcd.cell_dense_forces(st, JMODEL, config, coul, aux, compute_energy=True)
        got = tcd.cell_dense_forces(ts, TMODEL, config, tcoul, _port_tags(aux), compute_energy=True)
        _close_forces(got, want, valid)
    e0 = tcd.cell_dense_forces(ts, TMODEL, config, tcoul, None, compute_energy=True)[1]
    assert abs(float(torch.where(ts.valid, got[1] - e0, 0.0).sum())) > 1.0
    f_only = tcd.cell_dense_forces(ts, TMODEL, config, tcoul, _port_tags(aux))
    assert f_only[1] is None and torch.equal(f_only[0], got[0])


def test_plain_forces_bond_tags_match_pallas_interpret():
    """The plain version of the kernel's bond branch (bond weights on the
    first E_b tags) against JAX's interpret-mode kernel with the same tags,
    forces and energies; the bonds change the forces."""
    st, config, coul, n, pairs, ljs, cs, bonds = _charged_fixture()
    tabs, _, bond_tabs, absorbed = jmol.build_exclusion_tables(n, pairs, ljs, cs, bonds=bonds)
    assert absorbed.all()
    aux = jmol.make_exclusion_aux_fn(n, *tabs, bond_tabs=bond_tabs)(st)
    want = pallas_cell_forces(st, JMODEL, config, compute_energy=True, interpret=True,
                              coulomb=jc.coulomb_consts(coul), excl=aux)
    ts = to_port(st)
    tcoul = tc.coulomb_from_numpy(jax.device_get(coul), "cpu")
    got = tcd.cell_dense_forces(ts, TMODEL, config, tcoul, _port_tags(aux), compute_energy=True)
    _close_forces(got, want, np.asarray(st.valid))
    no_bond = tcd.cell_dense_forces(ts, TMODEL, config, tcoul, _port_tags(aux[:3]))[0]
    assert float((got[0] - no_bond).abs().max()) > 1.0


# ---------------------------------------------------------------------------
# Rollouts
# ---------------------------------------------------------------------------


def _sims(fx, jax_backend, port_backend="torch"):
    """(JAX state, JAX (rollout, energy), port (rollout, energy))."""
    n = fx["n"]
    jparams = jlj(np.ones(n), np.ones(n))
    coul = jc.DSFCoulomb.create(2.5, alpha=0.25, coulomb_constant=1.0)
    kw = dict(charges=fx["q"], exclusion_pairs=fx["pairs"], exclusion_scales=fx["ljs"],
              exclusion_scales_coulomb=fx["cs"], exclusion_band=1)
    js = jcd.cell_dense_init(fx["pos"], fx["vel"], np.ones(n), jparams, fx["config"], charges=fx["q"])
    jsim = jmol.make_molecular_dense_sim(fx["config"], JMODEL, DT, n, params=jparams, coulomb=coul,
                                         bonded=fx["bonded"], backend=jax_backend, **kw)
    tsim = tmol.make_molecular_dense_sim(
        fx["config"], TMODEL, DT, n, params=tcd.lj_params_from_numpy(jax.device_get(jparams), "cpu"),
        coulomb=tc.coulomb_from_numpy(jax.device_get(coul), "cpu"), bonded=tb.bonded_from_numpy(
            jax.device_get(fx["bonded"]), "cpu"), backend=port_backend, **kw)
    return js, jsim, tsim


def _run_and_compare(js, jsim, tsim, n, atol_pos, atol_vel, rel_e):
    (jroll, jenergy), (troll, tenergy) = jsim, tsim
    ja = jroll(js, num_steps=STEPS, rebin_every=REBIN_EVERY)
    ta = troll(to_port(js), num_steps=STEPS, rebin_every=REBIN_EVERY)
    assert not bool(ja.overflow) and not bool(ta.overflow)
    pj, vj = jcd.gather_dense_atoms(ja, n)
    pt, vt = tcd.gather_dense_atoms(ta, n)
    assert np.abs(pt - pj).max() <= atol_pos and np.abs(vt - vj).max() <= atol_vel
    for jst, tst in ((js, to_port(js)), (ja, ta)):
        pe_j, vir_j, ke_j = (float(x) for x in jenergy(jst))
        pe_t, vir_t, ke_t = (float(x) for x in tenergy(tst))
        assert pe_t == pytest.approx(pe_j, rel=rel_e, abs=1e-4)
        assert ke_t == pytest.approx(ke_j, rel=rel_e)
        assert vir_t == pytest.approx(vir_j, rel=1e-5, abs=1e-3)
    return ta


def test_rollout_matches_jax_xla():
    """The port's 'torch' path (bonds, angles, leftover pairs in slot space,
    exclusive terms by scatter-set, shared ones by the fixed-order add)
    against JAX's 'xla' path over 20 steps: positions and velocities within
    2e-4, energies within 1e-6 relative; a rerun is bitwise equal."""
    fx = _triatomic()
    js, jsim, tsim = _sims(fx, "xla")
    ta = _run_and_compare(js, jsim, tsim, fx["n"], 2e-4, 2e-4, 1e-6)
    tb_ = tsim[0](to_port(js), num_steps=STEPS, rebin_every=REBIN_EVERY)
    for name, a in tcd.state_to_numpy(ta).items():
        np.testing.assert_array_equal(bits(a), bits(tcd.state_to_numpy(tb_)[name]), err_msg=name)


def test_absorbed_bond_rollout_matches_jax_pallas_interpret(monkeypatch):
    """The port's absorbed-bond path — the path of the 'cuda' backend, with
    its pair passes run by their plain versions — against JAX's
    'pallas_interpret' (bonds absorbed on both sides) within 2e-4, energy
    bookkeeping within 1e-6; against JAX's gather path ('xla') within
    tests/test_cell_dense_molecular.py:363-368's 2e-3 / 5e-2."""
    fx = _triatomic()
    real = tmol.make_cell_dense_sim
    monkeypatch.setattr(tmol, "resolve_dense_backend", lambda *a, **k: "cuda")
    monkeypatch.setattr(tmol, "make_cell_dense_sim", lambda *a, **k: real(*a, **{**k, "backend": "torch"}))
    js, jsim, tsim = _sims(fx, "pallas_interpret")
    ta = _run_and_compare(js, jsim, tsim, fx["n"], 2e-4, 2e-4, 1e-6)
    jx = _sims(fx, "xla")[1][0](js, num_steps=STEPS, rebin_every=REBIN_EVERY)
    px, vx = jcd.gather_dense_atoms(jx, fx["n"])
    pt, vt = tcd.gather_dense_atoms(ta, fx["n"])
    np.testing.assert_allclose(pt, px, atol=2e-3)
    np.testing.assert_allclose(vt, vx, atol=5e-2)


def _wide_exclusions(fx):
    """The triatomic fixture with atom 1 (molecule 0's B) also excluded from
    the 9 atoms of its three lattice neighbours (scales 0.3 / 0.6): 11
    partners, wider than the kernel's 8 tags."""
    extra = np.asarray([[1, 3 * m + k] for m in (1, 5, 25) for k in range(3)])
    fx = dict(fx, pairs=np.concatenate([fx["pairs"], extra]),
              ljs=np.concatenate([fx["ljs"], np.full(len(extra), 0.3, np.float32)]),
              cs=np.concatenate([fx["cs"], np.full(len(extra), 0.6, np.float32)]))
    return fx


def test_kernel_band_caps_wide_exclusions(monkeypatch):
    """An atom with 11 exclusion partners: on 'cuda' the tag band becomes
    the kernel's 8 and the rest goes through the slot-pair correction (its
    pair passes run here by their plain versions), which holds the 'torch'
    path at full width E = 11 to 2e-4 over 20 steps and the energy to 1e-6;
    the kernel's wrapper refuses 9+ tags with a ValueError that names
    exclusion_band."""
    fx = _wide_exclusions(fixtures.triatomic_arrays())
    n, maxt = fx["n"], cell_kernel.MAX_TAGS
    assert tmol.kernel_band(n, fx["pairs"], None) == maxt and tmol.kernel_band(n, fx["pairs"], 12) == maxt
    assert tmol.kernel_band(n, fx["pairs"], 3) == 3
    assert tmol.kernel_band(fixtures.triatomic_arrays()["n"], fixtures.triatomic_arrays()["pairs"], None) is None
    config = tcd.suggest_cell_dense_config(n, fx["box"], 2.5, 2.0, 0.3)
    params = tlj(np.ones(n), np.ones(n), device="cpu")
    st = tcd.cell_dense_init(fx["pos"], fx["vel"], np.ones(n), params, config, charges=fx["q"], device="cpu")
    coul = tc.DSFCoulomb.create(2.5, alpha=0.25, coulomb_constant=1.0, device="cpu")

    def sim(backend):
        return tmol.make_molecular_dense_sim(
            config, TMODEL, DT, n, params=params, charges=fx["q"], coulomb=coul, exclusion_pairs=fx["pairs"],
            exclusion_scales=fx["ljs"], exclusion_scales_coulomb=fx["cs"],
            bonded=fixtures.triatomic_bonded(fx, "cpu"), backend=backend)

    full_roll, full_energy = sim("torch")
    seen = {}
    real = tmol.make_cell_dense_sim

    def plain(*a, **k):
        seen.update(k)
        return real(*a, **{**k, "backend": "torch"})

    with monkeypatch.context() as m:
        m.setattr(tmol, "resolve_dense_backend", lambda *a, **k: "cuda")
        m.setattr(tmol, "make_cell_dense_sim", plain)
        roll, energy = sim("cuda")
    tags = seen["aux_fn"](st)
    assert tags[0].shape[-1] == maxt and len(tags) == 4  # band 8, bonds on the tags
    assert seen["extra_aux_fn"](st)[2] is not None  # leftover pairs in the slot-pair correction
    assert float(energy(st)[0]) == pytest.approx(float(full_energy(st)[0]), rel=1e-6)
    a, b = roll(st, num_steps=STEPS, rebin_every=REBIN_EVERY), full_roll(st, num_steps=STEPS, rebin_every=REBIN_EVERY)
    assert not bool(a.overflow) and not bool(b.overflow)
    (pa, va), (pb, vb) = tcd.gather_dense_atoms(a, n), tcd.gather_dense_atoms(b, n)
    assert np.abs(pa - pb).max() <= 2e-4 and np.abs(va - vb).max() <= 2e-4

    wide = tmol.build_exclusion_tables(n, fx["pairs"], fx["ljs"], fx["cs"])
    wide_tags = tmol.make_exclusion_aux_fn(n, *wide)(st)
    assert wide_tags[0].shape[-1] == 11
    with pytest.raises(ValueError, match="exclusion_band"):
        cell_kernel._launch_mol(st, config, coul, wide_tags, False)


# ---------------------------------------------------------------------------
# Charges through the rebins; the water box
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rebin", ["sort", "shift", "spill"])
def test_charges_ride_rebins_bitexact(rebin):
    """A drifted charged state through each rebin: every field, charges
    included, equals JAX's bit for bit."""
    st, config, _ = drifted_state(1000, seed=4)
    if rebin == "spill":
        config = config._replace(spill=True)
    q = np.random.default_rng(1).uniform(-1, 1, st.valid.shape).astype(np.float32)
    st = st._replace(charges=jnp.where(st.valid, jnp.asarray(q), 0.0))
    if rebin == "sort":
        want, got = jcd._rebin(st, config), tcd._rebin(to_port(st), config)
    else:
        want = jcd._rebin_shift(st, config, backend="xla")
        got = tcd._rebin_shift(to_port(st), config, backend="torch")
    ref = jax.device_get(want)._asdict()
    for name, a in tcd.state_to_numpy(got).items():
        np.testing.assert_array_equal(bits(a), bits(ref[name]), err_msg=name)
    assert int(((np.asarray(want.atom_id) != np.asarray(st.atom_id)) & np.asarray(want.valid)).sum()) > 0


def test_water_box_full_width():
    """`tools/water.py` at full width: 98,304 atoms in a 99.52 Å box, neutral,
    at the TIP3P geometry, no net momentum; the spill config is M = 12, C =
    64 and resolves to the resident kernel family on a CUDA device (the VMEM
    rule ×7/5 ×6/5: 12.1 MB < 13 MB); the start's lattice planes put
    more atoms in its busiest cells than the spill capacity, and the plain
    config that holds them makes 'auto' pick the streaming family.  No card
    is touched."""
    from emdee_tpu_torch.tools import water

    box = water.water_box()
    n = len(box["masses"])
    assert n == 98_304 and box["box"] == pytest.approx(99.52)
    assert abs(box["charges"].sum()) < 1e-6
    p = box["positions"]
    d = p[box["bonds"][:, 1]] - p[box["bonds"][:, 0]]
    d -= np.round(d / box["box"]) * box["box"]
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), water.BOND_R0, atol=1e-4)
    assert np.abs((box["masses"][:, None] * box["velocities"]).sum(0)).max() < 1e-9
    spill = tcd.suggest_cell_dense_config(n, box["box"], water.CUTOFF, water.SWITCH, water.SKIN, spill=True)
    assert (spill.cells_per_dim, spill.capacity) == (12, 64)
    resolve = lambda cfg: tcd.resolve_dense_backend(cfg, "auto", device="cuda", with_coulomb=True,  # noqa: E731
                                                    with_excl=True)
    assert resolve(spill) == "cuda"
    plain = tcd.suggest_cell_dense_config(n, box["box"], water.CUTOFF, water.SWITCH, water.SKIN)
    cap = max(plain.capacity, water.start_capacity(p, plain))
    assert cap > spill.capacity and resolve(plain._replace(capacity=cap)) == "cuda_streaming"


def test_water_box_conserves_energy():
    """A 1,536-atom water box (8³ waters, M = 3) on the port's 'torch' path:
    12 steps at dt = 5e-4 hold the total energy to 1e-4 relative (the
    healthy NVE bound of the verify recipe; measured 1.3e-5)."""
    from emdee_tpu_torch import cell_dense_init
    from emdee_tpu_torch.tools import water

    box, config, model, coul, params = water.water_setup("cpu", n_side=8, spill=False)
    st = cell_dense_init(box["positions"], box["velocities"], box["masses"], params, config,
                         charges=box["charges"], device="cpu")
    roll, energy = water.molecular_sim(box, config, model, coul, params, "torch", "cpu")
    e0 = sum(float(x) for x in energy(st)[::2])
    out = roll(st, num_steps=12, rebin_every=6)
    assert not bool(out.overflow)
    assert abs(sum(float(x) for x in energy(out)[::2]) - e0) <= 1e-4 * abs(e0)
