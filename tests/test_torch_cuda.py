"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test skips without a CUDA device (decided in a fixture,
never at import).  On a machine with the card, run
`python -m pytest tests/test_torch_cuda.py -m gpu -q`.  This file imports no
JAX: the GPU machine has none."""

import numpy as np
import pytest
import torch

from emdee_tpu_torch import (
    LennardJonesModel,
    cell_dense_init,
    lennard_jones_atom,
    make_cell_dense_sim,
    suggest_cell_dense_config,
)
from emdee_tpu_torch.neighbors import cell_kernel, rebin_kernel, streaming_kernel
from emdee_tpu_torch.neighbors.cell_dense import _rebin_shift
from emdee_tpu_torch.tools import fixtures
from emdee_tpu_torch.utils.lattice import cubic_lattice, maxwell_boltzmann

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _state(device, n=2048, varied=True, drift=False, geometry=None):
    pos, box = cubic_lattice(n, 0.6, jitter=0.15, seed=11)
    rng = np.random.default_rng(11)
    eps, sig = (rng.uniform(0.8, 1.2, n), rng.uniform(0.9, 1.1, n)) if varied else (np.ones(n), np.ones(n))
    config = suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.35)
    if geometry is not None:
        config = config._replace(**geometry)
    st = cell_dense_init(pos, maxwell_boltzmann(n, 1.3, seed=12), np.ones(n),
                         lennard_jones_atom(eps, sig, device=device), config, device=device)
    if drift:  # cross cell faces and the periodic seam, as between rebins
        v = st.velocities
        pos = torch.where(st.valid[..., None], st.positions + (0.45 * 0.35 / float(v.abs().max())) * v, 0.0)
        st = st._replace(positions=pos)
    return st, config, LennardJonesModel.create(2.5, 2.0, device=device)


@pytest.mark.parametrize("drift", [False, True])
def test_force_kernel_matches_plain(device, drift):
    st, config, model = _state(device, drift=drift)
    before = cell_kernel.LAUNCHES
    fk, ek, wk = cell_kernel.cell_forces(st, model, config, compute_energy=True, backend="cuda")
    fp, ep, wp = cell_kernel.cell_forces(st, model, config, compute_energy=True, backend="torch")
    torch.cuda.synchronize()
    assert cell_kernel.LAUNCHES == before + 1
    v = st.valid.cpu().numpy()
    fk, ek, wk, fp, ep, wp = (a.cpu().numpy() for a in (fk, ek, wk, fp, ep, wp))
    scale = max(np.abs(fp[v]).max(), 1.0)
    np.testing.assert_allclose(fk[v], fp[v], atol=2e-5 * scale)
    np.testing.assert_allclose(ek[v], ep[v], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(wk[v], wp[v], rtol=1e-4, atol=2e-3)
    assert (fk[~v] == 0).all() and (ek[~v] == 0).all() and (wk[~v] == 0).all()


def test_split_kernel_matches_plain(device):
    st, config, _ = _state(device, varied=False, drift=True)
    comps = [st.positions[..., i].contiguous() for i in range(3)]
    fk = cell_kernel.cell_forces_split(*comps, st.valid, config, uniform_params=(0.5, 2.0), backend="cuda")
    fp = cell_kernel.cell_forces_split(*comps, st.valid, config, uniform_params=(0.5, 2.0), backend="torch")
    v = st.valid
    scale = max(max(float(f[v].abs().max()) for f in fp), 1.0)
    for a, b in zip(fk, fp):
        assert float((a[v] - b[v]).abs().max()) <= 2e-5 * scale


# M = 4 puts ~32 atoms in a cell: with C = 56 many cells fill the kernel's
# second centre slot per lane and second packet chunk.
@pytest.mark.parametrize(
    "drift,geometry", [(False, None), (True, None), (True, {"cells_per_dim": 4, "capacity": 56})]
)
def test_streaming_kernel_matches_plain(device, drift, geometry):
    st, config, model = _state(device, drift=drift, geometry=geometry)
    assert not bool(st.overflow)
    before = streaming_kernel.LAUNCHES
    fk, ek, wk = streaming_kernel.cell_forces_streaming(st, model, config, compute_energy=True, backend="cuda")
    fp, ep, wp = streaming_kernel.cell_forces_streaming(st, model, config, compute_energy=True, backend="torch")
    torch.cuda.synchronize()
    assert streaming_kernel.LAUNCHES == before + 2  # the pair pass and the fold
    v = st.valid.cpu().numpy()
    fk, ek, wk, fp, ep, wp = (a.cpu().numpy() for a in (fk, ek, wk, fp, ep, wp))
    scale = max(np.abs(fp[v]).max(), 1.0)
    np.testing.assert_allclose(fk[v], fp[v], atol=2e-5 * scale)
    np.testing.assert_allclose(ek[v], ep[v], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(wk[v], wp[v], rtol=1e-4, atol=2e-3)
    assert (fk[~v] == 0).all() and (ek[~v] == 0).all() and (wk[~v] == 0).all()


def test_streaming_split_kernel_matches_plain_and_resident(device):
    st, config, model = _state(device, varied=False, drift=True)
    comps = [st.positions[..., i].contiguous() for i in range(3)]
    kw = {"uniform_params": (0.5, 2.0)}
    fk = streaming_kernel.cell_forces_streaming_split(*comps, st.valid, config, backend="cuda", **kw)
    fp = streaming_kernel.cell_forces_streaming_split(*comps, st.valid, config, backend="torch", **kw)
    fr = cell_kernel.cell_forces_split(*comps, st.valid, config, backend="cuda", **kw)
    stacked = streaming_kernel.cell_forces_streaming(st, model, config, backend="cuda", **kw)[0]
    v = st.valid
    scale = max(max(float(f[v].abs().max()) for f in fp), 1.0)
    for a, b, r in zip(fk, fp, fr):
        assert float((a[v] - b[v]).abs().max()) <= 2e-5 * scale
        assert float((a[v] - r[v]).abs().max()) <= 2e-5 * scale
    # The split entry equals the stacked one, bit for bit (the same kernel on the same values).
    assert torch.equal(torch.stack(fk, -1), stacked)


@pytest.mark.parametrize("uniform", [False, True])
def test_rebin_kernel_bitexact(device, uniform):
    st, config, _ = _state(device, varied=not uniform, drift=True)
    kw = {"uniform_params": (0.5, 2.0), "uniform_mass": 1.0} if uniform else {}
    before = rebin_kernel.LAUNCHES
    a = _rebin_shift(st, config, backend="cuda", **kw)
    b = _rebin_shift(st, config, backend="torch", **kw)
    assert rebin_kernel.LAUNCHES == before + 3
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x is None and y is None:
            continue
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), name
    assert not bool(a.overflow) and int(((a.atom_id != st.atom_id) & a.valid).sum()) > 10


@pytest.mark.parametrize("uniform", [False, True])
def test_rollout_kernels_match_plain_and_rerun_bitwise(device, uniform):
    st, config, model = _state(device, varied=not uniform)
    kw = {"uniform_params": (0.5, 2.0), "uniform_mass": 1.0} if uniform else {}
    roll_k, energy = make_cell_dense_sim(config, model, dt=0.004, **kw)
    roll_p, _ = make_cell_dense_sim(config, model, dt=0.004, backend="torch", **kw)
    # The jittered start is hot: rebin every 3 steps keeps it within skin/2.
    a = roll_k(st, num_steps=24, rebin_every=3)
    b = roll_k(st, num_steps=24, rebin_every=3)
    p = roll_p(st, num_steps=24, rebin_every=3)
    for name in a._fields:
        if getattr(a, name) is not None:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert not bool(a.overflow) and torch.equal(a.atom_id, p.atom_id)
    assert float((a.positions - p.positions).abs().max()) < 2e-5
    pe, _, ke = energy(a)
    assert torch.isfinite(pe) and torch.isfinite(ke)


@pytest.mark.parametrize("uniform", [False, True])
def test_streaming_rollout_matches_plain_and_reruns_bitwise(device, uniform):
    st, config, model = _state(device, varied=not uniform)
    kw = {"uniform_params": (0.5, 2.0), "uniform_mass": 1.0} if uniform else {}
    roll_k, energy = make_cell_dense_sim(config, model, dt=0.004, backend="cuda_streaming", **kw)
    roll_p, _ = make_cell_dense_sim(config, model, dt=0.004, backend="torch", **kw)
    streaming_kernel.LAUNCHES = 0
    cell_kernel.LAUNCHES = 0
    a = roll_k(st, num_steps=24, rebin_every=3)
    assert (streaming_kernel.LAUNCHES, cell_kernel.LAUNCHES) == (2 * (24 + 2), 0)
    b = roll_k(st, num_steps=24, rebin_every=3)
    p = roll_p(st, num_steps=24, rebin_every=3)
    for name in a._fields:
        if getattr(a, name) is not None:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert not bool(a.overflow) and torch.equal(a.atom_id, p.atom_id)
    assert float((a.positions - p.positions).abs().max()) < 2e-5
    pe, _, ke = energy(a)
    assert torch.isfinite(pe) and torch.isfinite(ke)


def _straggler_state(device):
    """The CPU straggler tests' fixture (tests/test_torch_straggler.py) on
    the card: 2,048 jittered-lattice atoms, C_t two below the fullest cell."""
    from emdee_tpu_torch import StragglerConfig, straggler_init

    n = 2048
    pos, box = cubic_lattice(n, 0.8442, jitter=0.1, seed=7)
    vel = maxwell_boltzmann(n, 0.8, seed=8)
    params = lennard_jones_atom(np.ones(n), np.ones(n), device=device)
    wide = suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.35)
    occ = cell_dense_init(pos, vel, np.ones(n), params, wide, device=device).valid.sum(1)
    config = StragglerConfig(wide._replace(capacity=int(occ.max()) - 2), wide.capacity + 8, 64, 48)
    return straggler_init(pos, vel, np.ones(n), params, config, device=device), config


def test_straggler_kernel_matches_plain(device):
    from emdee_tpu_torch.neighbors import straggler_kernel
    from emdee_tpu_torch.neighbors.cell_dense_straggler import _bindings, _hood_matrix

    st, config = _straggler_state(device)
    nc, m = config.grid.num_cells, config.grid.cells_per_dim
    av = st.aux_cell < nc
    assert int(av.sum()) >= 5
    table, _ = _bindings(st.aux_cell, av, config, _hood_matrix(m, device))
    p = st.grid.positions.permute(2, 0, 1).contiguous()
    a = st.aux_positions.t().contiguous()
    args = (p[0], p[1], p[2], st.grid.valid, a[0], a[1], a[2], st.aux_cell, table, config, (0.5, 2.0))
    before = (cell_kernel.LAUNCHES, straggler_kernel.LAUNCHES)
    fg, fa = straggler_kernel.straggler_forces(*args, backend="cuda")
    pg, pa = straggler_kernel.straggler_forces(*args, backend="torch")
    torch.cuda.synchronize()
    assert (cell_kernel.LAUNCHES, straggler_kernel.LAUNCHES) == (before[0] + 1, before[1] + 1)
    v = st.grid.valid
    scale = max(float(pg[:, v].abs().max()), 1.0)
    assert float((fg - pg)[:, v].abs().max()) <= 2e-5 * scale
    assert float((fa - pa)[:, av].abs().max()) <= 2e-5 * scale
    assert bool((fg[:, ~v] == 0).all()) and bool((fa[:, ~av] == 0).all())


def test_straggler_rollout_matches_plain_and_reruns_bitwise(device):
    from emdee_tpu_torch import make_straggler_sim
    from emdee_tpu_torch.neighbors import straggler_kernel

    st, config = _straggler_state(device)
    model = LennardJonesModel.create(2.5, 2.0, device=device)
    roll_k, energy = make_straggler_sim(config, model, dt=0.003, uniform_params=(0.5, 2.0))
    roll_p, _ = make_straggler_sim(config, model, dt=0.003, uniform_params=(0.5, 2.0), backend="torch")
    straggler_kernel.LAUNCHES = 0
    a = roll_k(st, num_steps=24, rebin_every=6)
    assert straggler_kernel.LAUNCHES == 24 + 2
    b = roll_k(st, num_steps=24, rebin_every=6)
    p = roll_p(st, num_steps=24, rebin_every=6)
    for x, y in zip(list(a.grid) + list(a[1:]), list(b.grid) + list(b[1:])):
        assert (x is None and y is None) or torch.equal(x, y)
    assert not bool(a.grid.overflow) and torch.equal(a.grid.atom_id, p.grid.atom_id)
    assert torch.equal(a.aux_atom_id, p.aux_atom_id) and torch.equal(a.aux_cell, p.aux_cell)
    assert float((a.grid.positions - p.grid.positions).abs().max()) < 2e-5
    assert float((a.aux_positions - p.aux_positions).abs().max()) < 2e-5
    pe, _, ke = energy(a)
    assert torch.isfinite(pe) and torch.isfinite(ke)


def _spill_state(device, drift=False):
    """tests/test_cell_dense.py's spill fixture (1,728 jittered lattice
    atoms at ρ = 0.75, M = 4, C = 32) squeezed toward 27 atoms a cell, the
    mean, so that cells shed into their neighbours at every rebin."""
    pos, box = cubic_lattice(1728, 0.75, jitter=0.12, seed=9)
    config = suggest_cell_dense_config(1728, box, cutoff=2.5, switch=2.0, skin=0.3, spill=True)
    config = config._replace(spill_target=27)
    st = cell_dense_init(pos, maxwell_boltzmann(1728, 1.0, seed=10), np.ones(1728),
                         lennard_jones_atom(np.ones(1728), np.ones(1728), device=device), config, device=device)
    if drift:
        st = st._replace(positions=torch.where(st.valid[..., None], st.positions + 0.4 * torch.sign(st.velocities), 0.0))
    return st, config, LennardJonesModel.create(2.5, 2.0, device=device)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_compact_kernel_matches_plain_every_slot(device):
    """K7 vs its plain version on random windows (the reference test's
    inputs, tests/test_pallas_compact.py) and every output slot, fill
    included; int32 fields stay int32."""
    from emdee_tpu_torch.neighbors import compact_kernel

    rng = np.random.default_rng(0)
    c, rows = 32, 200
    k = 3 * c
    keep = rng.random((rows, k)) < 0.3
    keep[:5] = rng.random((5, k)) < 0.6  # rows past capacity: ranks ≥ C drop
    rank = np.cumsum(keep, axis=1) - keep
    s = np.where(keep, np.arange(k)[None, :] - rank, 0).astype(np.int32)
    f1 = rng.standard_normal((rows, k)).astype(np.float32)
    f2 = rng.integers(0, 1000, (rows, k)).astype(np.int32)
    args = [torch.from_numpy(a).to(device) for a in (s, keep)]
    cand = [torch.from_numpy(f).to(device) for f in (f1, f2)]
    win = torch.stack([f.view(torch.int32) for f in cand])
    before = compact_kernel.LAUNCHES
    got = compact_kernel.compact_stacked(*args, win, c, last_fill=777, backend="cuda")
    ref = compact_kernel.compact_stacked(*args, win, c, last_fill=777, backend="torch")
    torch.cuda.synchronize()
    assert compact_kernel.LAUNCHES == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    assert int((got[1] == 777).sum()) > 0


@pytest.mark.parametrize("stacked", [False, True])
def test_spill_rebin_kernel_matches_plain(device, stacked):
    """The spill route with K7 vs its plain version: every field of every
    slot, the valid mask and the flag; 3 K7 launches and no K4 launch."""
    from emdee_tpu_torch.neighbors import compact_kernel
    from emdee_tpu_torch.neighbors.cell_dense import _rebin_shift_core

    st, config, _ = _spill_state(device, drift=True)
    assert config.spill and not bool(st.overflow)
    if stacked:
        f = 0.1 * st.positions
        before = (compact_kernel.LAUNCHES, rebin_kernel.LAUNCHES)
        a, fa = _rebin_shift(st, config, forces=f, backend="cuda")
        b, fb = _rebin_shift(st, config, forces=f, backend="torch")
        assert (compact_kernel.LAUNCHES, rebin_kernel.LAUNCHES) == (before[0] + 3, before[1])
        for name in a._fields:
            if getattr(a, name) is not None:
                assert torch.equal(_bits(getattr(a, name)), _bits(getattr(b, name))), name
        assert torch.equal(_bits(fa), _bits(fb))
        assert not bool(a.overflow)
        return
    fields = [st.positions[..., i] for i in range(3)] + [st.velocities[..., i] for i in range(3)]
    fields.append(st.atom_id)
    ovf = torch.zeros((), dtype=torch.bool, device=device)
    rk, vk, ok = _rebin_shift_core(list(fields), st.valid, ovf, config, "cuda")
    rp, vp, op = _rebin_shift_core(list(fields), st.valid, ovf, config, "torch")
    for x, y in zip(rk + [vk, ok], rp + [vp, op]):
        assert torch.equal(_bits(x), _bits(y))


def test_device_box_launches_equal_value_box(device):
    """K2 (both entries), K5 and K4 give the same bits for the static box
    (a number, held on the device once by `cell_dense._box`) as for the same
    value as a dynamic 0-d box tensor."""
    from emdee_tpu_torch.neighbors.rebin_kernel import SENTINEL_BITS, rebin_routing

    st, config, model = _state(device, varied=True, drift=True)
    tbox = torch.full((), config.box, dtype=torch.float32, device=device)
    dyn = st._replace(box=tbox)
    for fn in (cell_kernel.cell_forces, streaming_kernel.cell_forces_streaming):
        a = fn(st, model, config, compute_energy=True, backend="cuda")
        b = fn(dyn, model, config, compute_energy=True, backend="cuda")
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    comps = [st.positions[..., i].contiguous() for i in range(3)]
    for fn in (cell_kernel.cell_forces_split, streaming_kernel.cell_forces_streaming_split):
        a = fn(*comps, st.valid, config, uniform_params=(0.5, 2.0), backend="cuda")
        b = fn(*comps, st.valid, config, uniform_params=(0.5, 2.0), box=tbox, backend="cuda")
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    sent = torch.full((), SENTINEL_BITS, dtype=torch.int32, device=device).view(torch.float32)
    pos = st.positions - torch.floor(st.positions / tbox) * tbox
    fields = tuple(torch.where(st.valid, pos[..., i], sent) for i in range(3)) + (st.atom_id,)
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    a, fa = rebin_routing(fields, config.box, m, c, ns, backend="cuda")
    b, fb = rebin_routing(fields, tbox, m, c, ns, backend="cuda")
    for x, y in zip(a + (fa,), b + (fb,)):
        assert torch.equal(_bits(x), _bits(y))


def test_spill_rollout_matches_plain_and_reruns_bitwise(device):
    from emdee_tpu_torch.neighbors import compact_kernel

    st, config, model = _spill_state(device)
    kw = {"uniform_params": (0.5, 2.0), "uniform_mass": 1.0}
    roll_k, energy = make_cell_dense_sim(config, model, dt=0.004, **kw)
    roll_p, _ = make_cell_dense_sim(config, model, dt=0.004, backend="torch", **kw)
    compact_kernel.LAUNCHES = rebin_kernel.LAUNCHES = 0
    a = roll_k(st, num_steps=24, rebin_every=3)
    assert (compact_kernel.LAUNCHES, rebin_kernel.LAUNCHES) == (3 * 8, 0)
    b = roll_k(st, num_steps=24, rebin_every=3)
    p = roll_p(st, num_steps=24, rebin_every=3)
    for name in a._fields:
        if getattr(a, name) is not None:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert not bool(a.overflow) and torch.equal(a.atom_id, p.atom_id)
    assert float((a.positions - p.positions).abs().max()) < 2e-5
    pe, _, ke = energy(a)
    assert torch.isfinite(pe) and torch.isfinite(ke)


@pytest.mark.parametrize("spill", [False, True])
def test_nvt_rollout_reruns_bitwise_on_the_card_generator(device, spill):
    """CSVR (wide) and Langevin (spill) rollouts with record=True: reruns
    from one seed of a CUDA generator are bitwise equal, another seed
    differs, and the records stay on the card."""
    from emdee_tpu_torch import CSVRConfig, LangevinConfig

    st, config, model = _spill_state(device) if spill else _state(device, varied=False)
    thermo = LangevinConfig(1.0, 2.0) if spill else CSVRConfig(1.0, 0.2)
    roll, _ = make_cell_dense_sim(config, model, dt=0.004, thermostat=thermo)
    runs = []
    for seed in (5, 5, 6):
        g = torch.Generator(device=device).manual_seed(seed)
        runs.append(roll(st, num_steps=24, rebin_every=3, record=True, rng=g))
    (a, ra), (b, rb), (c, _) = runs
    assert not bool(a.overflow)
    assert all(r.device.type == "cuda" and r.shape == (8,) for r in ra)
    assert torch.equal(a.velocities, b.velocities) and all(torch.equal(x, y) for x, y in zip(ra, rb))
    assert not torch.equal(a.velocities, c.velocities)


def _routing_stack(st, config):
    """(nf, M³, C) int32: wrapped positions with the NaN-pattern sentinel in
    empty slots, velocities, atom id — a rebin's routed fields."""
    box = torch.full((), config.box, dtype=torch.float32, device=st.positions.device)
    sent = torch.full((), rebin_kernel.SENTINEL_BITS, dtype=torch.int32, device=box.device).view(torch.float32)
    pos = st.positions - torch.floor(st.positions / box) * box
    fields = [torch.where(st.valid, pos[..., i], sent) for i in range(3)]
    fields += [st.velocities[..., i] for i in range(3)]
    return torch.stack([f.contiguous().view(torch.int32) for f in fields] + [st.atom_id])


def test_rebin_window_kernel_matches_plain_and_k4(device):
    from emdee_tpu_torch.neighbors import rebin_window_kernel as k6
    from emdee_tpu_torch.neighbors.cell_dense import _PASSES

    st, config, _ = _state(device, varied=False, drift=True)
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    x = _routing_stack(st, config)
    before = k6.LAUNCHES
    for axis, _, cf in _PASSES:
        args = k6.periodic_windows(x, m, axis)
        out_k, ovf_k = k6.rebin_window_pass(*args, config.box, cf, m, c, ns, backend="cuda")
        out_p, ovf_p = k6.rebin_window_pass(*args, config.box, cf, m, c, ns, backend="torch")
        assert torch.equal(out_k, out_p) and bool(ovf_k) == bool(ovf_p) is False
        x = out_k.reshape(x.shape)
    assert k6.LAUNCHES == before + 3
    fields = tuple(_routing_stack(st, config)[i].view(torch.float32) for i in range(6)) + (st.atom_id,)
    ref, ovf = rebin_kernel.rebin_routing(fields, config.box, m, c, ns, backend="cuda")
    for i, r in enumerate(ref):
        assert torch.equal(x[i], r.view(torch.int32)), f"field {i}"
    assert int((x[-1] != st.atom_id).sum()) > 10


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2)])
def test_ghost_force_kernel_equals_k2_and_matches_plain(device, shape):
    from emdee_tpu_torch.distributed import grid_sharded as gs
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh

    st, config, model = _state(device, drift=True, geometry={"cells_per_dim": 4, "capacity": 56})
    mesh = make_grid_mesh(shape, device=device)
    sh = gs.distribute_grid(st, config, mesh)
    roll_k, _ = gs.make_grid_sharded_sim(config, model, 0.002, mesh, backend="cuda")
    roll_p, _ = gs.make_grid_sharded_sim(config, model, 0.002, mesh, backend="torch")
    before = cell_kernel.LAUNCHES
    got = roll_k.forces(sh, compute_energy=True)
    assert cell_kernel.LAUNCHES == before + 1
    whole = lambda f, e, w: gs.gather_grid_state(sh._replace(positions=f, half_sigma=e, twice_sqrt_eps=w), config, mesh)  # noqa: E731
    k, p = whole(*got), whole(*roll_p.forces(sh, compute_energy=True))
    ref = cell_kernel.cell_forces(st, model, config, compute_energy=True, backend="cuda")
    for a, b in zip((k.positions, k.half_sigma, k.twice_sqrt_eps), ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    v = st.valid
    scale = max(float(p.positions[v].abs().max()), 1.0)
    assert float((k.positions[v] - p.positions[v]).abs().max()) <= 2e-5 * scale
    np.testing.assert_allclose(k.half_sigma[v].cpu().numpy(), p.half_sigma[v].cpu().numpy(), rtol=1e-4, atol=1e-4)


def test_grid_rollout_kernels_match_plain_and_rerun_bitwise(device):
    from emdee_tpu_torch.distributed import grid_sharded as gs
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors import rebin_window_kernel as k6

    st, config, model = _state(device, varied=False, geometry={"cells_per_dim": 4, "capacity": 56})
    outs = {}
    for shape in ((1, 1, 1), (2, 2, 2)):
        mesh = make_grid_mesh(shape, device=device)
        sh = gs.distribute_grid(st, config, mesh)
        roll, _ = gs.make_grid_sharded_sim(config, model, 0.002, mesh, uniform_params=(0.5, 2.0))
        k2, k6_before = cell_kernel.LAUNCHES, k6.LAUNCHES
        out = roll(sh, num_steps=12, rebin_every=3)
        assert (cell_kernel.LAUNCHES - k2, k6.LAUNCHES - k6_before) == (14, 12)
        again = roll(sh, num_steps=12, rebin_every=3)
        assert all(torch.equal(a, b) for a, b in zip(out, again) if isinstance(a, torch.Tensor))
        assert not bool(out.overflow)
        outs[shape] = gs.gather_grid_state(out, config, mesh)
        if shape == (2, 2, 2):
            roll_p, _ = gs.make_grid_sharded_sim(config, model, 0.002, mesh, uniform_params=(0.5, 2.0), backend="torch")
            plain = gs.gather_grid_state(roll_p(sh, num_steps=12, rebin_every=3), config, mesh)
            assert torch.equal(plain.atom_id, outs[shape].atom_id)
            assert float((plain.positions - outs[shape].positions).abs().max()) <= 2e-5
    a, b = outs[(1, 1, 1)], outs[(2, 2, 2)]
    assert all(torch.equal(x, y) for x, y in zip(a, b) if isinstance(x, torch.Tensor))


def test_probe_kernels_match_plain(device):
    from emdee_tpu_torch.tools import probes

    ghost, centers = probes.probe_fma_inputs(6, 32, device)
    before = probes.LAUNCHES
    got = probes.probe_fma(ghost, centers, 6, 32, 15)
    assert torch.equal(got.view(torch.int32), probes.probe_fma_plain(ghost, centers, 6, 32, 15).view(torch.int32))
    for transposed in (False, True):
        cen, expand = probes.probe_cen_inputs(transposed, device, progs=8)
        got = probes.probe_cen(cen, expand, transposed)
        want = probes.probe_cen_plain(cen, expand, transposed)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5)
    assert probes.LAUNCHES == before + 3


def test_straggler_gather_pass_reruns_bitwise(device):
    """strag_pass="xla": the gather pass's reactions folded by the
    fixed-order add, so two rollouts on the card are bitwise equal (no
    float atomics), and they agree with the kernel pass."""
    from emdee_tpu_torch import make_straggler_sim

    st, config = _straggler_state(device)
    model = LennardJonesModel.create(2.5, 2.0, device=device)
    roll_x, _ = make_straggler_sim(config, model, dt=0.003, uniform_params=(0.5, 2.0), strag_pass="xla")
    roll_k, _ = make_straggler_sim(config, model, dt=0.003, uniform_params=(0.5, 2.0))
    a = roll_x(st, num_steps=24, rebin_every=6)
    b = roll_x(st, num_steps=24, rebin_every=6)
    k = roll_k(st, num_steps=24, rebin_every=6)
    for x, y in zip(list(a.grid) + list(a[1:]), list(b.grid) + list(b[1:])):
        assert (x is None and y is None) or torch.equal(x, y)
    assert not bool(a.grid.overflow) and torch.equal(a.grid.atom_id, k.grid.atom_id)
    assert float((a.grid.positions - k.grid.positions).abs().max()) < 2e-5


@pytest.mark.parametrize("variant", ["coulomb", "tags", "coulomb_tags", "bonds", "coulomb_bonds"])
def test_molecular_kernel_matches_plain(device, variant):
    """K2c (DSF, exclusion tags, tag-borne bonds) against its plain version:
    forces within 2e-4 of the force scale, per-slot energies and virials
    within 1e-3 (the reference's K2c tolerance), empty slots exactly 0."""
    st, config, model, coul, tags = fixtures.charged_fixture(device)
    c = coul if "coulomb" in variant else None
    excl = None if variant == "coulomb" else (tags if "bonds" in variant else tags[:3])
    before = cell_kernel.LAUNCHES
    for energy in (False, True):
        fk, ek, wk = cell_kernel.cell_forces(st, model, config, compute_energy=energy, backend="cuda",
                                             coulomb=c, excl=excl)
        fp, ep, wp = cell_kernel.cell_forces(st, model, config, compute_energy=energy, backend="torch",
                                             coulomb=c, excl=excl)
        torch.cuda.synchronize()
        v = st.valid
        scale = max(float(fp[v].abs().max()), 1.0)
        assert float((fk - fp)[v].abs().max()) <= 2e-4 * scale
        assert bool((fk[~v] == 0).all())
        if energy:
            assert float((ek - ep)[v].abs().max()) <= 1e-3 and float((wk - wp)[v].abs().max()) <= 1e-3
            assert bool((ek[~v] == 0).all()) and bool((wk[~v] == 0).all())
    assert cell_kernel.LAUNCHES == before + 2


def test_molecular_water_rollout_matches_plain_and_reruns_bitwise(device):
    """A 1,536-atom flexible-water box (`tools/water.py`, 8³ waters, M = 3)
    on 'cuda' (bonds absorbed in K2c) against 'torch' (the gather path)
    after 20 steps within 2e-3 / 5e-2; two 'cuda' rollouts bitwise equal;
    the streaming family refuses molecular terms (K5c)."""
    from emdee_tpu_torch import gather_dense_atoms, make_cell_dense_sim
    from emdee_tpu_torch.tools import water

    box, config, model, coul, params = water.water_setup(device, n_side=8, spill=False)
    st = cell_dense_init(box["positions"], box["velocities"], box["masses"], params, config,
                         charges=box["charges"], device=device)
    roll_k, energy_k = water.molecular_sim(box, config, model, coul, params, "cuda", device)
    roll_p, energy_p = water.molecular_sim(box, config, model, coul, params, "torch", device)
    a = roll_k(st, num_steps=20, rebin_every=5)
    b = roll_k(st, num_steps=20, rebin_every=5)
    p = roll_p(st, num_steps=20, rebin_every=5)
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)
    assert not bool(a.overflow) and not bool(p.overflow)
    n = len(box["masses"])
    (pa, va), (pp, vp) = gather_dense_atoms(a, n), gather_dense_atoms(p, n)
    assert np.abs(pa - pp).max() < 2e-3 and np.abs(va - vp).max() < 5e-2
    pe_k, pe_p = float(energy_k(st)[0]), float(energy_p(st)[0])
    assert abs(pe_k - pe_p) <= 1e-5 * abs(pe_p) + 1e-2
    with pytest.raises(NotImplementedError, match="K5c"):
        make_cell_dense_sim(config, model, dt=water.DT, backend="cuda_streaming", coulomb=coul)[0](st, 5, 5)


def test_molecular_triatomic_reruns_bitwise(device):
    """The triatomic fixture at band 1 (leftover pairs and shared terms by
    the fixed-order add, exclusive angles by scatter-set, bonds in K2c) on
    'cuda': two 20-step rollouts bitwise equal, and within 2e-3 / 5e-2 of
    'torch' (the gather path)."""
    from emdee_tpu_torch import gather_dense_atoms

    st, (roll_k, _) = fixtures.triatomic_sim(device, "cuda")
    _, (roll_p, _) = fixtures.triatomic_sim(device, "torch")
    a, b, p = (r(st, num_steps=20, rebin_every=5) for r in (roll_k, roll_k, roll_p))
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)
    assert not bool(a.overflow) and not bool(p.overflow)
    n = int(st.valid.sum())
    (pa, va), (pp, vp) = gather_dense_atoms(a, n), gather_dense_atoms(p, n)
    assert np.abs(pa - pp).max() < 2e-3 and np.abs(va - vp).max() < 5e-2
