"""The molecular grid-sharded engine (K2c-G on the CPU: its plain version)
against the JAX package's grid engine on `backend="xla"` (8 virtual CPU
devices, tests/conftest.py), at the reference tests' sizes and tolerances:
the charged fixture of tests/test_grid_sharded.py:150-202 (DSF + exclusion
tags, 2,048 atoms, M = 10) on (2,2,2) and (2,2,1) — (2,4,1) does not divide
M = 10, and the reference has 8 CPU devices — energy within rel 1e-5 /
abs 1e-2 and 20 steps within 2e-4, and
against the port's one-card molecular engine; the triatomic fixture of
tests/test_grid_sharded_pallas.py:36-104 (bonded terms and leftover pairs
beyond the band) the same way.  On the port's side alone: the plain ghost
molecular pair forces bit for bit the one-card plain `cell_dense_forces`
(coulomb=, excl=); decompositions bitwise equal; a 2-rank gloo `DistMesh`
bitwise equal to `LocalMesh`; the sticky flag raised by a bonded partner
two cells away."""

import jax
import numpy as np
import pytest
import torch

from emdee_tpu.distributed import grid_sharded as jgs
from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.neighbors import cell_dense_molecular as jmol
from emdee_tpu.potentials.coulomb import DSFCoulomb as JCoulomb
from emdee_tpu.potentials.lennard_jones import LennardJonesModel as JModel
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom as jlj
from emdee_tpu_torch.distributed import dryrun
from emdee_tpu_torch.distributed import grid_sharded as gs
from emdee_tpu_torch.distributed.mesh import make_grid_mesh
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.neighbors import cell_dense_molecular as tmol
from emdee_tpu_torch.tools import fixtures
from torch_port_utils import bits, jax_triatomic_bonded, to_port

torch.set_num_threads(2)
DT, STEPS, REBIN = 0.002, 20, 5
JMODEL = JModel.create(2.5, 2.0)
SHAPES = [(2, 2, 2), (2, 2, 1)]
TRI_SHAPES = [(1, 1, 1), (2, 2, 2), (2, 1, 2)]


def _run(st, config, model, shape, kwargs, steps=STEPS):
    """A port grid run from the one-card state `st`: (the sharded end
    state, its one-card gather, the energy closure)."""
    mesh = make_grid_mesh(shape, device="cpu")
    rollout, energy = gs.make_grid_sharded_sim(config, model, DT, mesh, **kwargs)
    out = rollout(gs.distribute_grid(st, config, mesh), num_steps=steps, rebin_every=REBIN)
    return out, gs.gather_grid_state(out, config, mesh), energy


@pytest.fixture(scope="module")
def charged():
    """The charged fixture: JAX state and options, the port's, and the
    port's 20-step runs on (1,1,1) and SHAPES."""
    a = fixtures.grid_charged_arrays()
    n = a["n"]
    config = fixtures.grid_charged_config(a)
    st = jcd.cell_dense_init(a["pos"], a["vel"], np.ones(n), jlj(np.ones(n), np.ones(n)), config, charges=a["q"])
    assert not bool(st.overflow) and config.cells_per_dim == 10
    jkw = dict(coulomb=JCoulomb.create(2.5, alpha=0.25, coulomb_constant=1.0),
               excl_tables=jmol.build_exclusion_tables(n, a["pairs"], a["ljs"], a["cs"]))
    kw = fixtures.grid_charged_kwargs("cpu")
    model = tcd.LennardJonesModel.create(2.5, 2.0, device="cpu")
    runs = {shape: _run(to_port(st), config, model, shape, kw) for shape in [(1, 1, 1)] + SHAPES}
    return a, st, config, jkw, kw, model, runs


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_molecular_matches_reference(charged, shape):
    """Energy within rel 1e-5 / abs 1e-2 and 20 steps within 2e-4 of JAX's
    grid engine ('xla') on the same mesh shape."""
    a, st, config, jkw, kw, model, runs = charged
    jmesh = jgs.make_grid_mesh(shape)
    jroll, jenergy = jgs.make_grid_sharded_sim(config, JMODEL, DT, jmesh, backend="xla", **jkw)
    jst = jgs.distribute_grid(st, config, jmesh)
    mesh = make_grid_mesh(shape, device="cpu")
    _, energy = gs.make_grid_sharded_sim(config, model, DT, mesh, **kw)
    pe, vir, ke = (float(x) for x in energy(gs.distribute_grid(to_port(st), config, mesh)))
    jpe, jvir, jke = (float(x) for x in jenergy(jst))
    assert pe == pytest.approx(jpe, rel=1e-5, abs=1e-2)
    assert vir == pytest.approx(jvir, rel=1e-5, abs=1e-2)
    assert ke == pytest.approx(jke, rel=1e-5)
    ref = jroll(jst, num_steps=STEPS, rebin_every=REBIN)
    out, whole, _ = runs[shape]
    assert not bool(ref.overflow) and not bool(out.overflow) and int(out.step) == STEPS
    p_ref, v_ref = jgs.gather_grid_atoms(ref, config, a["n"])
    p, v = tcd.gather_dense_atoms(whole, a["n"])
    np.testing.assert_allclose(p, p_ref, atol=2e-4)
    np.testing.assert_allclose(v, v_ref, atol=2e-4)


def test_grid_molecular_matches_single_card(charged):
    """The port's one-card molecular engine ('torch', kernel exclusion mode)
    on the same fixture: energy within rel 1e-5 and 20 steps within 2e-4 of
    the (2,2,2) grid (no Kahan compensation on the grid, as the
    reference's)."""
    a, st, config, jkw, kw, model, runs = charged
    n = a["n"]
    roll1, energy1 = tmol.make_molecular_dense_sim(
        config, model, DT, n, params=tcd.lj_params_from_numpy(jax.device_get(jlj(np.ones(n), np.ones(n))), "cpu"),
        charges=a["q"], coulomb=kw["coulomb"], exclusion_pairs=a["pairs"], exclusion_scales=a["ljs"],
        exclusion_scales_coulomb=a["cs"], backend="torch")
    ref = roll1(to_port(st), num_steps=STEPS, rebin_every=REBIN)
    out, whole, energy = runs[(2, 2, 2)]
    assert float(energy(out)[0]) == pytest.approx(float(energy1(ref)[0]), rel=1e-5, abs=1e-2)
    p, v = tcd.gather_dense_atoms(whole, n)
    pr, vr = tcd.gather_dense_atoms(ref, n)
    np.testing.assert_allclose(p, pr, atol=2e-4)
    np.testing.assert_allclose(v, vr, atol=2e-4)


def test_grid_molecular_decompositions_bitwise_equal(charged):
    *_, runs = charged
    first = tcd.state_to_numpy(runs[(1, 1, 1)][1])
    for shape in SHAPES:
        got = tcd.state_to_numpy(runs[shape][1])
        for name, want in first.items():
            np.testing.assert_array_equal(bits(got[name]), bits(want), err_msg=f"{shape} {name}")


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2), (2, 5, 1)])
def test_plain_ghost_mol_forces_equal_single_card_plain(charged, shape):
    """The ghost pass's plain version with DSF and the tags (no bond tags)
    is bit for bit the one-card plain `cell_dense_forces(coulomb=, excl=)`,
    forces, energies and virials, on a state drifted 0.45·skin so that
    atoms sit across cell faces and the seam."""
    a, st, config, jkw, kw, model, _ = charged
    port = to_port(st)
    v = port.velocities
    port = port._replace(positions=torch.where(
        port.valid[..., None], port.positions + (0.45 * 0.3 / float(v.abs().max())) * v, 0.0))
    tags = tmol.make_exclusion_aux_fn(a["n"], *kw["excl_tables"])(port)
    f_ref, e_ref, w_ref = tcd.cell_dense_forces(port, model, config, kw["coulomb"], tags, compute_energy=True)
    mesh = make_grid_mesh(shape, device="cpu")
    sh = gs.distribute_grid(port, config, mesh)
    rollout, _ = gs.make_grid_sharded_sim(config, model, DT, mesh, **kw)
    f, e, w = rollout.forces(sh, compute_energy=True)
    back = gs.gather_grid_state(sh._replace(positions=f, half_sigma=e, twice_sqrt_eps=w), config, mesh)
    assert torch.equal(back.positions.view(torch.int32), f_ref.view(torch.int32))
    assert torch.equal(back.half_sigma.view(torch.int32), e_ref.view(torch.int32))
    assert torch.equal(back.twice_sqrt_eps.view(torch.int32), w_ref.view(torch.int32))


@pytest.mark.parametrize("fixture", ["charged", "triatomic"])
def test_gloo_dist_mesh_molecular_bitwise_equals_local_mesh(fixture):
    """Two gloo ranks, (2,1,1), one shard a rank: the charges ride the halo
    and the rebin exchanges, the triatomic fixture's term bindings sum the
    int32 atom → slot map over the ranks, and the end state is bitwise the
    LocalMesh run's, the energies within 1e-6."""
    if fixture == "charged":
        port, config, model = fixtures.grid_charged_state("cpu")
        kwargs_fn = fixtures.grid_charged_kwargs
    else:
        port, config, model = fixtures.triatomic_state("cpu")
        kwargs_fn = fixtures.triatomic_grid_kwargs
    kw = kwargs_fn("cpu")
    runs = dryrun.run_ranks(2, dryrun.grid_job, ((2, 1, 1), tcd.state_to_numpy(port), config, STEPS, REBIN, "cpu",
                                                 kwargs_fn), timeout=240)
    out, whole, energy = _run(port, config, model, (2, 1, 1), kw)
    want = tcd.state_to_numpy(whole)
    energies = tuple(float(x) for x in energy(out))
    for got, got_e in runs:
        for name in want:
            np.testing.assert_array_equal(bits(got[name]), bits(want[name]), err_msg=name)
        np.testing.assert_allclose(got_e, energies, rtol=1e-6)


# ---------------------------------------------------------------------------
# Bonded terms and leftover pairs: the triatomic fixture
# ---------------------------------------------------------------------------


def _jax_triatomic():
    """The reference test's triatomic options and state (JAX), band 1."""
    fx = fixtures.triatomic_arrays()
    n = fx["n"]
    config = jcd.suggest_cell_dense_config(n, fx["box"], cutoff=2.5, switch=2.0, skin=0.3)
    params = jlj(np.ones(n), np.ones(n))
    tabs, leftover = jmol.build_exclusion_tables(n, fx["pairs"], fx["ljs"], fx["cs"], band_e=1)
    assert leftover[0].shape[0] > 0
    st = jcd.cell_dense_init(fx["pos"], fx["vel"], np.ones(n), params, config, charges=fx["q"])
    kw = dict(coulomb=JCoulomb.create(2.5, alpha=0.25, coulomb_constant=1.0), excl_tables=tabs, bonded=jax_triatomic_bonded(fx),
              excl_leftover=leftover, atom_params=params, atom_charges=fx["q"])
    return fx, st, config, kw


@pytest.fixture(scope="module")
def triatomic():
    fx, st, config, jkw = _jax_triatomic()
    kw = fixtures.triatomic_grid_kwargs("cpu")
    model = tcd.LennardJonesModel.create(2.5, 2.0, device="cpu")
    runs = {shape: _run(to_port(st), config, model, shape, kw) for shape in TRI_SHAPES}
    return fx, st, config, jkw, kw, model, runs


def test_grid_triatomic_matches_reference(triatomic):
    """Bonds and angles as term rows and the leftover pairs beyond band 1,
    each shard evaluating its own atoms' rows: energy within rel 1e-5 and
    20 steps within 2e-4 of JAX's grid engine ('xla', owner computes with
    reaction folds) on (2,2,2)."""
    fx, st, config, jkw, kw, model, runs = triatomic
    jmesh = jgs.make_grid_mesh((2, 2, 2))
    jroll, jenergy = jgs.make_grid_sharded_sim(config, JMODEL, 1e-3, jmesh, backend="xla", **jkw)
    jst = jgs.distribute_grid(st, config, jmesh)
    mesh = make_grid_mesh((2, 2, 2), device="cpu")
    roll, energy = gs.make_grid_sharded_sim(config, model, 1e-3, mesh, **kw)
    sh = gs.distribute_grid(to_port(st), config, mesh)
    for got, want in zip(energy(sh), jenergy(jst)):
        assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-3)
    ref = jroll(jst, num_steps=STEPS, rebin_every=REBIN)
    out = roll(sh, num_steps=STEPS, rebin_every=REBIN)
    assert not bool(ref.overflow) and not bool(out.overflow)
    p_ref, v_ref = jgs.gather_grid_atoms(ref, config, fx["n"])
    p, v = gs.gather_grid_atoms(out, config, fx["n"], mesh)
    np.testing.assert_allclose(p, p_ref, atol=2e-4)
    np.testing.assert_allclose(v, v_ref, atol=2e-4)


def test_grid_triatomic_decompositions_bitwise_equal(triatomic):
    """Each atom's term rows arrive in the same order with the same values
    on any decomposition: (1,1,1), (2,2,2) and (2,1,2) end bitwise equal."""
    *_, runs = triatomic
    first = tcd.state_to_numpy(runs[TRI_SHAPES[0]][1])
    for shape in TRI_SHAPES[1:]:
        assert not bool(runs[shape][0].overflow)
        got = tcd.state_to_numpy(runs[shape][1])
        for name, want in first.items():
            np.testing.assert_array_equal(bits(got[name]), bits(want), err_msg=f"{shape} {name}")


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2)])
def test_bad_flag_on_far_bonded_partner(shape):
    """A bonded partner two cells from its atom (molecule 0's A moved by two
    cell sides along x) trips the sticky flag at the first binding, as the
    reference's `bad` does; the intact fixture does not."""
    fx = fixtures.triatomic_arrays()
    kw = fixtures.triatomic_grid_kwargs("cpu")
    for far in (False, True):
        pos = fx["pos"].copy()
        st, config, model = fixtures.triatomic_state("cpu")
        if far:
            pos[0, 0] = (pos[0, 0] + 2.0 * config.cell_side) % config.box
            st, config, model = fixtures.triatomic_state("cpu", pos)
        assert not bool(st.overflow)
        mesh = make_grid_mesh(shape, device="cpu")
        roll, _ = gs.make_grid_sharded_sim(config, model, 1e-3, mesh, **kw)
        out = roll(gs.distribute_grid(st, config, mesh), num_steps=1, rebin_every=1)
        assert bool(out.overflow) == far
