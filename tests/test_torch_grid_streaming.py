"""The grid-sharded engine's streaming family on the CPU: `torch_streaming`,
the half shell over each shard's ghost grid with its reactions written to
ghost cells (`streaming_kernel.streaming_ghost_forces_plain`, the plain
version of K5s) and returned to their owners by the reverse exchange
(`grid_sharded._fold3`), against the JAX package's grid engine
(emdee_tpu/distributed/grid_sharded.py, 8 virtual CPU devices of
tests/conftest.py) at the reference tests' sizes and tolerances: the
streaming test's fixture of tests/test_grid_sharded.py:284-303 (1,024 atoms
at ρ 0.12 on (2,2,2), 4 steps, rebin every 2) against JAX's `xla` and
`pallas_streaming_interpret` backends (atol 1e-4); energies on (2,2,2),
(2,4,1) and (4,1,1) (rtol 1e-5); the molecular variant on the charged and
the triatomic fixtures against JAX's `xla` (the fixtures' own gates).  On the port's side alone: the
plain pass and the fold against the one-card plain forces on every mesh
shape, a 2-rank gloo `DistMesh` run bitwise equal to `LocalMesh` (the first
reverse exchange across ranks), and the grid's 'auto' rule (the reference's
per-shard VMEM estimate, grid_sharded.py:237-249) at the sizes the H100
smoke drives."""

import numpy as np
import pytest
import torch

from emdee_tpu.distributed import grid_sharded as jgs
from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.neighbors import cell_dense_molecular as jmol
from emdee_tpu.potentials.coulomb import DSFCoulomb as JCoulomb
from emdee_tpu.potentials.lennard_jones import LennardJonesModel as JModel
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom as jlj
from emdee_tpu.utils.lattice import cubic_lattice, maxwell_boltzmann
from emdee_tpu_torch import LennardJonesModel
from emdee_tpu_torch.distributed import dryrun
from emdee_tpu_torch.distributed import grid_sharded as gs
from emdee_tpu_torch.distributed.mesh import LocalMesh, make_grid_mesh
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.neighbors.streaming_kernel import streaming_ghost_forces_plain
from emdee_tpu_torch.tools import fixtures
from torch_port_utils import bits, jax_triatomic_bonded, to_port

torch.set_num_threads(2)
SHAPES = [(1, 1, 1), (2, 2, 2), (2, 4, 1), (4, 1, 1)]
JMODEL = JModel.create(2.5, 2.0)


def _setup(n, density, T=0.9, seed=21):
    """tests/test_grid_sharded.py's `_setup`: (JAX state, config, n)."""
    pos, box = cubic_lattice(n, density, jitter=0.1, seed=seed)
    config = jcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.3)
    config = config._replace(cells_per_dim=max((config.cells_per_dim // 8) * 8, 8))
    st = jcd.cell_dense_init(pos, maxwell_boltzmann(n, T, seed=seed + 1), np.ones(n), jlj(np.ones(n), np.ones(n)), config)
    assert not bool(st.overflow)
    return st, config, n


def _model():
    return LennardJonesModel.create(2.5, 2.0, device="cpu")


@pytest.fixture(scope="module")
def streaming_case():
    """The JAX streaming test's fixture and the port's `torch_streaming`
    run on (2,2,2): 4 steps, rebin every 2."""
    st, config, n = _setup(1024, 0.12)
    mesh = make_grid_mesh((2, 2, 2), device="cpu")
    rollout, _ = gs.make_grid_sharded_sim(config, _model(), 0.002, mesh, backend="torch_streaming")
    assert rollout.family == "torch_streaming"
    out = rollout(gs.distribute_grid(to_port(st), config, mesh), num_steps=4, rebin_every=2)
    assert not bool(out.overflow) and int(out.step) == 4
    return st, config, n, gs.gather_grid_atoms(out, config, n, mesh)


def _jax_streaming_gate(case, backend):
    st, config, n, (p, v) = case
    jmesh = jgs.make_grid_mesh((2, 2, 2))
    jroll, _ = jgs.make_grid_sharded_sim(config, JMODEL, 0.002, jmesh, backend=backend)
    ref = jroll(jgs.distribute_grid(st, config, jmesh), num_steps=4, rebin_every=2)
    assert not bool(ref.overflow)
    p_ref, v_ref = jgs.gather_grid_atoms(ref, config, n)
    np.testing.assert_allclose(p, p_ref, atol=1e-4)
    np.testing.assert_allclose(v, v_ref, atol=1e-4)


def test_streaming_rollout_matches_reference_xla(streaming_case):
    _jax_streaming_gate(streaming_case, "xla")


@pytest.mark.full
def test_streaming_rollout_matches_reference_streaming_interpret(streaming_case):
    """The same run against the reference's streaming kernel in interpret
    mode under shard_map (its half shell, unwrapped reaction rows padded onto
    the ghost grid, `_fold3`)."""
    _jax_streaming_gate(streaming_case, "pallas_streaming_interpret")


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 4, 1), (4, 1, 1)])
def test_streaming_energy_matches_reference(streaming_case, shape):
    """The energy pass (the plain pass's per-slot halves and their reaction
    rows, folded) against JAX's grid energy on `xla`, on the streaming
    test's fixture: rtol 1e-5."""
    st, config, _, _ = streaming_case
    mesh = make_grid_mesh(shape, device="cpu")
    _, energy = gs.make_grid_sharded_sim(config, _model(), 0.002, mesh, backend="torch_streaming")
    got = [float(x) for x in energy(gs.distribute_grid(to_port(st), config, mesh))]
    jmesh = jgs.make_grid_mesh(shape)
    _, jenergy = jgs.make_grid_sharded_sim(config, JMODEL, 0.002, jmesh, backend="xla")
    want = [float(x) for x in jenergy(jgs.distribute_grid(st, config, jmesh))]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_streaming_and_fold_match_single_card_plain(shape):
    """`streaming_ghost_forces_plain` then `_fold3` against the one-card
    plain `_dense_forces` on a state drifted 0.45·skin (atoms across cell
    faces and the seam): forces within 1e-5 of the force scale, energies
    and virials within 1e-5 relative, exact zeros on empty slots.  The
    interior of the reaction grid is zero and so is its −z layer (no group
    writes there)."""
    st, config, _ = _setup(1024, 0.12)
    port = to_port(st)
    v = port.velocities
    port = port._replace(positions=torch.where(
        port.valid[..., None], port.positions + (0.45 * 0.3 / float(v.abs().max())) * v, 0.0))
    model = _model()
    f_ref, e_ref, w_ref = tcd._dense_forces(port.positions, port.half_sigma, port.twice_sqrt_eps, port.valid, model,
                                            config, config.box, True)
    mesh = make_grid_mesh(shape, device="cpu")
    sh = gs.distribute_grid(port, config, mesh)
    pos3 = torch.where(sh.valid, sh.positions.movedim(-1, 0), float("nan"))
    gh = gs._ghost3(torch.cat([pos3, sh.half_sigma[None], sh.twice_sqrt_eps[None]]), mesh)
    f, react, e, w = streaming_ghost_forces_plain(gh, config, model, None, True)
    mz, my, mx = f.shape[-4:-1]
    assert not bool(react[..., 1:mz + 1, 1:my + 1, 1:mx + 1, :].any()) and not bool(react[..., 0, :, :, :].any())
    back = gs._fold3(react, mesh)
    out = torch.cat([f + back[:3], (e + back[3])[None], (w + back[4])[None]]).movedim(0, -1)
    whole = gs.gather_grid_state(sh._replace(positions=out), config, mesh).positions
    valid = port.valid
    scale = float(f_ref[valid].abs().max())
    np.testing.assert_allclose(whole[..., :3][valid].numpy(), f_ref[valid].numpy(), atol=1e-5 * scale)
    np.testing.assert_allclose(whole[..., 3][valid].numpy(), e_ref[valid].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(whole[..., 4][valid].numpy(), w_ref[valid].numpy(), rtol=1e-5, atol=1e-5)
    assert not bool(whole[~valid].any())


def test_molecular_streaming_matches_reference_charged():
    """The charged fixture (DSF + exclusion tags, M = 10) on (2,2,2)
    `torch_streaming` against JAX's grid `xla`: energy within rel 1e-5 /
    abs 1e-2, 10 steps within 2e-4 (tests/test_grid_sharded.py's gates)."""
    a = fixtures.grid_charged_arrays()
    n = a["n"]
    config = fixtures.grid_charged_config(a)
    st = jcd.cell_dense_init(a["pos"], a["vel"], np.ones(n), jlj(np.ones(n), np.ones(n)), config, charges=a["q"])
    jkw = dict(coulomb=JCoulomb.create(2.5, alpha=0.25, coulomb_constant=1.0),
               excl_tables=jmol.build_exclusion_tables(n, a["pairs"], a["ljs"], a["cs"]))
    jmesh = jgs.make_grid_mesh((2, 2, 2))
    jroll, jenergy = jgs.make_grid_sharded_sim(config, JMODEL, 0.002, jmesh, backend="xla", **jkw)
    jst = jgs.distribute_grid(st, config, jmesh)
    mesh = make_grid_mesh((2, 2, 2), device="cpu")
    roll, energy = gs.make_grid_sharded_sim(config, _model(), 0.002, mesh, backend="torch_streaming",
                                            **fixtures.grid_charged_kwargs("cpu"))
    sh = gs.distribute_grid(to_port(st), config, mesh)
    for got, want in zip(energy(sh), jenergy(jst)):
        assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-2)
    ref, out = jroll(jst, num_steps=10, rebin_every=5), roll(sh, num_steps=10, rebin_every=5)
    assert not bool(ref.overflow) and not bool(out.overflow)
    p_ref, v_ref = jgs.gather_grid_atoms(ref, config, n)
    p, v = gs.gather_grid_atoms(out, config, n, mesh)
    np.testing.assert_allclose(p, p_ref, atol=2e-4)
    np.testing.assert_allclose(v, v_ref, atol=2e-4)


def test_molecular_streaming_matches_reference_triatomic():
    """The triatomic fixture (DSF, tags, bonds and angles as term rows, the
    leftover pairs beyond band 1) on (2,2,2) `torch_streaming` against JAX's
    grid `xla`, at the gates of tests/test_grid_sharded_pallas.py's
    streaming case: energies within rel 1e-5 / abs 1e-3, 6 steps (rebin
    every 3) within 1e-4."""
    fx = fixtures.triatomic_arrays()
    n = fx["n"]
    config = jcd.suggest_cell_dense_config(n, fx["box"], cutoff=2.5, switch=2.0, skin=0.3)
    params = jlj(np.ones(n), np.ones(n))
    tabs, leftover = jmol.build_exclusion_tables(n, fx["pairs"], fx["ljs"], fx["cs"], band_e=1)
    st = jcd.cell_dense_init(fx["pos"], fx["vel"], np.ones(n), params, config, charges=fx["q"])
    jkw = dict(coulomb=JCoulomb.create(2.5, alpha=0.25, coulomb_constant=1.0), excl_tables=tabs,
               bonded=jax_triatomic_bonded(fx), excl_leftover=leftover, atom_params=params, atom_charges=fx["q"])
    jmesh = jgs.make_grid_mesh((2, 2, 2))
    jroll, jenergy = jgs.make_grid_sharded_sim(config, JMODEL, 1e-3, jmesh, backend="xla", **jkw)
    jst = jgs.distribute_grid(st, config, jmesh)
    mesh = make_grid_mesh((2, 2, 2), device="cpu")
    roll, energy = gs.make_grid_sharded_sim(config, _model(), 1e-3, mesh, backend="torch_streaming",
                                            **fixtures.triatomic_grid_kwargs("cpu"))
    sh = gs.distribute_grid(to_port(st), config, mesh)
    for got, want in zip(energy(sh), jenergy(jst)):
        assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-3)
    ref, out = jroll(jst, num_steps=6, rebin_every=3), roll(sh, num_steps=6, rebin_every=3)
    assert not bool(ref.overflow) and not bool(out.overflow)
    p_ref, v_ref = jgs.gather_grid_atoms(ref, config, n)
    p, v = gs.gather_grid_atoms(out, config, n, mesh)
    np.testing.assert_allclose(p, p_ref, atol=1e-4)
    np.testing.assert_allclose(v, v_ref, atol=1e-4)


def test_gloo_dist_mesh_streaming_bitwise_equals_local_mesh():
    """Two gloo ranks, (2,1,1): the reaction ghosts of each rank's shard
    cross to the other rank in `_fold3` (the first reverse exchange across
    ranks); the end state is bitwise the LocalMesh run's, the energies
    within 1e-6."""
    st, config, _ = _setup(1024, 0.12)
    port = to_port(st)
    kwargs = {"backend": "torch_streaming"}
    runs = dryrun.run_ranks(2, dryrun.grid_job, ((2, 1, 1), tcd.state_to_numpy(port), config, 10, 5, "cpu", None,
                                                 kwargs), timeout=240)
    mesh = make_grid_mesh((2, 1, 1), device="cpu")
    rollout, energy = gs.make_grid_sharded_sim(config, _model(), 0.002, mesh, **kwargs)
    out = rollout(gs.distribute_grid(port, config, mesh), num_steps=10, rebin_every=5)
    want = tcd.state_to_numpy(gs.gather_grid_state(out, config, mesh))
    energies = tuple(float(x) for x in energy(out))
    for got, got_e in runs:
        for name in want:
            np.testing.assert_array_equal(bits(got[name]), bits(want[name]), err_msg=name)
        np.testing.assert_allclose(got_e, energies, rtol=1e-6)


def _config(m, c):
    return tcd.CellDenseConfig(cells_per_dim=m, capacity=c, box=m * 3.0, cutoff=2.5, switch=2.0, skin=0.35,
                               num_atoms=1000)


@pytest.mark.parametrize("m,c,shape,uniform,mol,mb,family", [
    (37, 32, (1, 1, 1), True, False, 46.77, "cuda_streaming"),  # the 1M melt, one shard
    (36, 32, (2, 1, 1), True, False, 23.36, "cuda_streaming"),
    (36, 32, (2, 2, 2), True, False, 6.73, "cuda"),
    (26, 88, (2, 2, 2), False, True, 15.10, "cuda_streaming"),  # the 985,527-atom water box
    (17, 32, (1, 1, 1), True, False, 5.82, "cuda"),  # the smoke's LJ grid
    (12, 80, (1, 1, 1), False, True, 11.24, "cuda"),  # the smoke's water grid
])
def test_grid_auto_rule(m, c, shape, uniform, mol, mb, family):
    """The grid's 'auto' rule: the reference's per-shard estimate at the
    sizes the H100 smoke drives, and the family it picks on a CUDA mesh
    (nothing touches a card), 'torch' on the CPU; 'cuda_streaming' and its
    alias 'pallas_streaming' refuse a CPU mesh."""
    config = _config(m, c)
    uni = (0.5, 2.0) if uniform else None
    est = gs.grid_vmem_estimate(config, LocalMesh(shape, "cpu"), uni, with_coulomb=mol, with_excl=mol)
    assert est / 1e6 == pytest.approx(mb, abs=0.01)
    kw = dict(uniform_params=uni, with_coulomb=mol, with_excl=mol)
    assert gs.resolve_grid_backend(config, LocalMesh(shape, "cuda"), "auto", **kw) == family
    assert gs.resolve_grid_backend(config, LocalMesh(shape, "cpu"), "auto", **kw) == "torch"
    assert gs.resolve_grid_backend(config, LocalMesh(shape, "cuda"), "pallas_streaming", **kw) == "cuda_streaming"
    for backend in ("cuda_streaming", "pallas_streaming"):
        with pytest.raises(ValueError, match="CUDA"):
            gs.resolve_grid_backend(config, LocalMesh(shape, "cpu"), backend, **kw)


def test_k5s_shared_memory_fits_the_smoke_shapes():
    """K5s's shared memory a block (`smem_bytes`, the C entries' count) is
    K5's warp-owned block, whatever the shards' geometry: four
    warps of three 64-entry tiles (x, y, z, with per-atom parameters σ/2 and
    2√ε, and the slot) and the (n_r, C) centre and reaction rows, at the 1M
    melt's C = 32 and the M = 36 grids' C = 40, uniform and per-atom, with
    and without energies; K5s-mol's at the 985,527-atom water box (C = 88,
    DSF and eight tags, with energies) is K5c's.  The geometry check takes
    any shard row (a 60-cell grid at C = 96 with energies, which the pencil
    refused) and C up to 1024, and refuses C > 1024.  K5s's scratch
    (`ghost_scratch_bytes`: a centre slice over the own slots and 13
    reaction slices over the ghost slots, (n_r, slots) float32 each) at the
    smoke's shapes: the 1M melt on (1,1,1), M = 37, C = 32 — 315.6 MB forces
    only, 526.0 MB with energies — and on (2,2,2), M = 36, C = 40 — 421.8
    MB; the 97,556-atom melt on (1,1,1), M = 17, C = 32 — 36.1 MB."""
    from emdee_tpu_torch.neighbors import streaming_kernel as sk

    for c in (32, 40):
        for uniform, fields in ((True, 4), (False, 6)):
            for energy, nr in ((False, 3), (True, 5)):
                assert sk.smem_bytes(_config(36, c), energy, uniform=uniform) == 4 * 4 * (3 * fields * 64
                                                                                          + 2 * nr * c)
    assert sk.smem_bytes(_config(37, 32), False, uniform=True) == 15_360
    assert sk.smem_bytes(_config(37, 32), True) == 23_552
    sk._check_geometry(_config(37, 32), True)
    sk._check_geometry(_config(26, 88), True, True, 8)
    assert sk.smem_bytes(_config(26, 88), True, True, 2) < sk.smem_bytes(_config(26, 88), True, True, 8) <= 232_448
    sk._check_geometry(_config(60, 96), True)
    sk._check_geometry(_config(60, 96), True, True, 8)
    sk._check_geometry(_config(24, 1024), True)
    with pytest.raises(ValueError, match="C ≤ 1024"):
        sk._check_geometry(_config(26, 1025), False)
    assert sk.ghost_scratch_bytes(1, (37, 37, 37), 32, False) == 4 * 3 * (1_620_896 + 13 * 1_898_208) == 315_571_200
    assert sk.ghost_scratch_bytes(1, (37, 37, 37), 32, True) == 525_952_000
    assert sk.ghost_scratch_bytes(8, (18, 18, 18), 40, False) == 4 * 3 * (1_866_240 + 13 * 2_560_000) == 421_754_880
    assert sk.ghost_scratch_bytes(1, (17, 17, 17), 32, False) == 36_126_720
