"""The port's atom-table slab engine (`emdee_tpu_torch.distributed.domain`)
on the CPU against the JAX package's (`emdee_tpu/distributed/domain.py`,
on the 8 virtual CPU devices of tests/conftest.py), at
tests/test_distributed.py's sizes and tolerances: the config rule and its
refusal, the slot layouts of `distribute` and `redistribute` bit for bit,
the halo buffers, energies against JAX's and the port's all-pairs, a
40-step rollout, the dry run's part 1; the halo rule at two slabs, where
the port leaves the reference (ROADMAP fault R11); and on the port's side
alone: the (D, 1, 1) mesh, a 2-rank gloo `DistMesh` run bitwise equal to
`LocalMesh`, and (`full`) the energy conservation gate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.distributed import domain as jd
from emdee_tpu.distributed.mesh import make_mesh as jax_mesh
from emdee_tpu.potentials.lennard_jones import LennardJonesModel as JaxModel
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom as jax_lj_atom
from emdee_tpu.utils.lattice import cubic_lattice, maxwell_boltzmann
from emdee_tpu_torch import LennardJonesModel, compute_nonbonded_allpairs, lennard_jones_atom
from emdee_tpu_torch.distributed import domain as td
from emdee_tpu_torch.distributed import dryrun
from emdee_tpu_torch.distributed.mesh import ATOM_AXIS, LocalMesh, make_mesh
from torch_port_utils import bits

torch.set_num_threads(2)


def _system(n, density, T=0.8, seed=7):
    """tests/test_distributed.py's `_system`."""
    pos, box = cubic_lattice(n, density, jitter=0.1, seed=seed)
    return pos, maxwell_boltzmann(n, T, seed=seed + 1), box


def _model():
    return LennardJonesModel.create(2.5, 2.0, device="cpu")


def _params(n):
    return lennard_jones_atom(np.ones(n), np.ones(n), device="cpu")


def _distribute_both(pos, vel, config, ndev):
    n = len(pos)
    ref = jd.distribute(pos, vel, np.ones(n), jax_lj_atom(np.ones(n), np.ones(n)), config, jax_mesh(ndev))
    mesh = make_mesh(ndev, device="cpu")
    return ref, td.distribute(pos, vel, np.ones(n), _params(n), config, mesh), mesh


def assert_layout_equal(port, ref):
    ref = jax.device_get(ref)
    for name in port._fields:
        np.testing.assert_array_equal(bits(getattr(port, name).numpy()), bits(np.asarray(getattr(ref, name))),
                                      err_msg=name)


def test_slab_mesh():
    mesh = make_mesh(3, device="cpu")
    assert isinstance(mesh, LocalMesh) and mesh.shape == (3, 1, 1) and ATOM_AXIS == "atoms"
    assert make_mesh(device="cpu").shape == (1, 1, 1)
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.all_gather(x) is x
    assert torch.equal(mesh.shift(x[None, :, None, None], 0, 1)[0, :, 0, 0], x[[1, 2, 0]])


@pytest.mark.parametrize("args", [(1024, 25.0, 2.5, 2, {}), (2048, 25.07, 2.5, 4, {}), (1500, 23.2, 2.5, 2,
                                  {"resort_every": 10}), (3000, 27.1, 3.0, 3, {"halo_skin": 0.4})])
def test_suggest_domain_config_matches_reference(args):
    *pos_args, kw = args
    assert tuple(td.suggest_domain_config(*pos_args, **kw)) == tuple(jd.suggest_domain_config(*pos_args, **kw))
    cfg = td.suggest_domain_config(*pos_args, **kw)
    ref = jd.suggest_domain_config(*pos_args, **kw)
    assert (cfg.halo_width, cfg.slab_width) == (ref.halo_width, ref.slab_width)


def test_too_many_devices_rejected():
    with pytest.raises(ValueError, match="slab width") as ours:
        td.suggest_domain_config(1000, 10.0, 2.5, 8)
    with pytest.raises(ValueError) as theirs:
        jd.suggest_domain_config(1000, 10.0, 2.5, 8)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("ndev", [2, 4])
def test_distribute_matches_reference_and_round_trips(ndev):
    pos, vel, box = _system(1024, 0.06)
    n = len(pos)
    config = jd.suggest_domain_config(n, box, 2.5, ndev)
    ref, st, mesh = _distribute_both(pos, vel, config, ndev)
    assert_layout_equal(st, ref)
    assert not bool(st.overflow) and int(st.valid.sum()) == n
    ids, valid = st.atom_id.numpy(), st.valid.numpy()
    assert (ids[~valid] == np.iinfo(np.int32).max).all()
    z = st.positions[:, 2].numpy()
    slot_slab = np.arange(len(ids)) // config.slot_capacity
    np.testing.assert_array_equal(slot_slab[valid],
                                  np.clip((z[valid] % box) / config.slab_width, 0, ndev - 1).astype(int))
    p, v = td.gather_dense(st, n)
    np.testing.assert_array_equal(p, pos.astype(np.float32))
    np.testing.assert_array_equal(v, vel.astype(np.float32))


def test_redistribute_matches_reference():
    """Atoms moved across slab faces and the periodic seam (and one slab
    overfilled) re-sort into JAX's slot layout bit for bit, flag included."""
    pos, vel, box = _system(1024, 0.06)
    n = len(pos)
    config = jd.suggest_domain_config(n, box, 2.5, 4)
    ref, st, mesh = _distribute_both(pos, vel, config, 4)
    for shift, overfill in ((3.0, False), (-7.5, False), (0.0, True)):
        moved = st.positions + shift * st.velocities
        if overfill:  # a third of the atoms into slab 0
            moved[: len(moved) // 3, 2] = 0.1 * config.slab_width
        moved = torch.where(st.valid[:, None], moved, 0.0)
        got = td.redistribute(st._replace(positions=moved), config, mesh)
        want = jd.redistribute(ref._replace(positions=jnp.asarray(moved.numpy())), config, jax_mesh(4))
        assert bool(got.overflow) == overfill
        if not overfill:
            assert_layout_equal(got, want)
        else:
            assert bool(want.overflow)


def test_halo_pack_matches_reference():
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 10, (2, 300, 3)).astype(np.float32)
    hs, tse = rng.uniform(0.4, 0.6, (2, 2, 300)).astype(np.float32)
    for frac, cap in ((0.2, 80), (0.4, 80)):
        sel = rng.uniform(size=(2, 300)) < frac
        got = td._halo_pack(*(torch.from_numpy(x) for x in (pos, hs, tse, sel)), cap)
        for s in range(2):
            want = jd._halo_pack(*(jnp.asarray(x[s]) for x in (pos, hs, tse, sel)), cap)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(bits(g[s].numpy()), bits(np.asarray(w)))


def test_energy_matches_reference_and_allpairs():
    pos, vel, box = _system(2048, 0.13)
    n = len(pos)
    config = jd.suggest_domain_config(n, box, 2.5, 4)
    ref, st, mesh = _distribute_both(pos, vel, config, 4)
    _, energy = td.make_sharded_step(config, mesh, _model(), dt=0.002)
    e, w = (float(x) for x in energy(st))
    _, jenergy = jd.make_sharded_step(config, jax_mesh(4), JaxModel.create(2.5, 2.0), dt=0.002)
    je, jw = (float(x) for x in jenergy(ref))
    ap = compute_nonbonded_allpairs(torch.tensor(pos, dtype=torch.float32), box, _model(), _params(n))
    for got, want in ((e, je), (w, jw), (e, float(ap.energies.sum())), (w, float(ap.virials.sum()))):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_two_slabs_ghost_an_atom_that_left_its_slab_once():
    """ROADMAP fault R11: at D = 2 the reference measures an atom's offset
    from its slab's far face periodically, so an owned atom that crossed a
    face within a block goes out as a ghost through both faces and its
    pairs count twice.  The port measures from the slab's centre: on a
    random fluid (ρ 0.12, atoms ≥ 0.9σ apart) moved 0.3σ up in z without a
    re-sort (a translation: the all-pairs energy stays), its energy and
    virial stay the all-pairs values (rtol 1e-5), where JAX's do not."""
    from emdee_tpu_torch.utils.lattice import random_fluid

    pos, box = random_fluid(1500, 0.12, 0.9, seed=4)
    vel = maxwell_boltzmann(1500, 0.8, seed=5)
    n = len(pos)
    config = jd.suggest_domain_config(n, box, 2.5, 2, resort_every=10)
    ref, st, mesh = _distribute_both(pos, vel, config, 2)
    moved = torch.where(st.valid[:, None], torch.remainder(st.positions + torch.tensor([0.0, 0.0, 0.3]), box), 0.0)
    slab = torch.clamp((moved[:, 2] / config.slab_width).long(), 0, 1)
    assert int((st.valid & (slab != torch.arange(len(slab)) // config.slot_capacity)).sum()) > 10
    _, energy = td.make_sharded_step(config, mesh, _model(), dt=0.002)
    e, w = (float(x) for x in energy(st._replace(positions=moved)))
    _, jenergy = jd.make_sharded_step(config, jax_mesh(2), JaxModel.create(2.5, 2.0), dt=0.002)
    je, _ = (float(x) for x in jenergy(ref._replace(positions=jnp.asarray(moved.numpy()))))
    ap = compute_nonbonded_allpairs(moved[st.valid], box, _model(), _params(n))
    np.testing.assert_allclose(e, float(ap.energies.sum()), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(w, float(ap.virials.sum()), rtol=1e-5, atol=1e-3)
    want = float(ap.energies.sum())
    assert abs(je - want) > 10 * (1e-5 * abs(want) + 1e-3)  # the reference's pairs across the moved faces twice


def test_rollout_matches_reference():
    """tests/test_distributed.py's 40-step rollout (1,500 atoms, ρ 0.12,
    resort every 10) on (2, 1, 1) against JAX's sharded rollout."""
    pos, vel, box = _system(1500, 0.12)
    n = len(pos)
    config = jd.suggest_domain_config(n, box, 2.5, 2, resort_every=10)
    ref, st, mesh = _distribute_both(pos, vel, config, 2)
    rollout, _ = td.make_sharded_step(config, mesh, _model(), dt=0.002)
    out = rollout(st, num_blocks=4)
    jroll, _ = jd.make_sharded_step(config, jax_mesh(2), JaxModel.create(2.5, 2.0), dt=0.002)
    jout = jroll(ref, num_blocks=4)
    assert int(out.step) == int(jout.step) == 40
    assert bool(out.overflow) == bool(jout.overflow) is False
    p, v = td.gather_dense(out, n)
    pr, vr = jd.gather_dense(jout, n)
    np.testing.assert_allclose(p, pr, atol=5e-4)
    np.testing.assert_allclose(v, vr, atol=5e-4)


def test_dryrun_part1_flag_matches_reference():
    """The dry run's part 1 on two slabs against the reference's
    (`__graft_entry__.py:91-115`) from the same arrays: one block, and the
    random start's close pairs trip the staleness flag in both (the reason
    the dry run gates the flag only from four slabs on)."""
    a = dryrun.slab_arrays(2)
    n = a["n"]
    got, _ = dryrun.slab_part(1, make_mesh(2, device="cpu"))
    config = jd.suggest_domain_config(n, a["box"], 2.5, 2, resort_every=5)
    jroll, _ = jd.make_sharded_step(config, jax_mesh(2), JaxModel.create(2.5, 2.0), dt=0.002)
    jout = jroll(jd.distribute(a["pos"], a["vel"], np.ones(n), jax_lj_atom(np.ones(n), np.ones(n)), config,
                               jax_mesh(2)), num_blocks=1)
    assert int(got["step"]) == int(jout.step) == 5
    assert bool(got["overflow"]) and bool(jout.overflow)


def test_gloo_dist_mesh_bitwise_equals_local_mesh():
    pos, vel, box = _system(1500, 0.12)
    config = td.suggest_domain_config(len(pos), box, 2.5, 2, resort_every=10)
    runs = dryrun.run_ranks(2, dryrun.domain_job, (pos, vel, config, 1), timeout=240)
    want, energies = dryrun.domain_run(make_mesh(2, device="cpu"), pos, vel, config, 1)
    assert int(want["step"]) == 10 and not bool(want["overflow"])
    for got, got_e in runs:
        for name, value in want.items():
            np.testing.assert_array_equal(bits(got[name]), bits(value), err_msg=name)
        np.testing.assert_allclose(got_e, energies, rtol=1e-6)


@pytest.mark.full
def test_sharded_energy_conservation():
    """tests/test_distributed.py's `full` gate: 3,000 atoms at ρ 0.15 on
    (4, 1, 1), 100 steps, relative drift < 1e-4."""
    pos, vel, box = _system(3000, 0.15)
    n = len(pos)
    config = td.suggest_domain_config(n, box, 2.5, 4, resort_every=10)
    mesh = make_mesh(4, device="cpu")
    rollout, energy = td.make_sharded_step(config, mesh, _model(), dt=0.002)
    st = td.distribute(pos, vel, np.ones(n), _params(n), config, mesh)

    def total_energy(s):
        ke = 0.5 * float(torch.sum(torch.where(s.valid[:, None], s.masses[:, None] * s.velocities**2, 0.0)))
        return ke + float(energy(s)[0])

    e0 = total_energy(st)
    st = rollout(st, num_blocks=10)
    assert not bool(st.overflow)
    e1 = total_energy(st)
    assert abs(e1 - e0) / abs(e0) < 1e-4, (e0, e1)
