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


def _state(device, n=2048, varied=True, drift=False, geometry=None, density=0.6):
    pos, box = cubic_lattice(n, density, jitter=0.15, seed=11)
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
    assert rebin_kernel.LAUNCHES == before + 1  # one cooperative launch a rebin
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x is None and y is None:
            continue
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), name
    assert not bool(a.overflow) and int(((a.atom_id != st.atom_id) & a.valid).sum()) > 10


def _k4_fields(st, pos):
    """The component carry's routed fields: positions and velocities as
    strided views of their (M³, C, 3) tensors, atom id."""
    return [pos[..., i] for i in range(3)] + [st.velocities[..., i] for i in range(3)] + [st.atom_id]


@pytest.mark.parametrize("case", ["strided", "y pass overflows", "rows outnumber the grid"])
def test_fused_rebin_matches_plain_and_three_launches(device, case):
    """K4's one cooperative launch on raw positions with the valid mask and
    the wrap, as `_rebin_shift_core` calls it, against the plain version and
    against the former three launches (`emdee_rebin_pass`) on the parked
    fields: bit for bit in every field and the flag — on strided views of
    the drifted 2,048-atom state; with every atom of the cells at y = 0
    moved one cell up y, so that the y pass overflows between the z and x
    passes; and on 100,000 atoms at M = 23, whose 12,167 rows outnumber
    the rows the card routes at a time (a warp a row), so that each warp
    routes several rows a pass."""
    import ctypes

    from emdee_tpu_torch.csrc import build
    from emdee_tpu_torch.neighbors.cell_dense import _box
    from emdee_tpu_torch.tools.ab_rebin import three_pass

    big = case == "rows outnumber the grid"
    st, config, _ = _state(device, n=100000, varied=False, drift=True, density=0.35) if big else \
        _state(device, drift=True)
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    pos = st.positions
    if case == "y pass overflows":
        low = ((torch.arange(m**3, device=device) // m) % m == 0)[:, None] & st.valid
        pos = pos.clone()
        pos[..., 1] += torch.where(low, float(config.cell_side), 0.0)
    fields = _k4_fields(st, pos)
    assert fields[0].stride() == (3 * c, 3) and fields[3].stride() == (3 * c, 3)
    box = _box(config.box, pos)
    grid = (ctypes.c_int * 4)()  # blocks an SM, SMs, threads a block, rows a block at a time
    build.check(build.load().emdee_rebin_routing_attrs(grid), "attrs")
    assert (m**3 > grid[0] * grid[1] * grid[3]) == big, (m, tuple(grid))
    before = rebin_kernel.LAUNCHES
    got = rebin_kernel.rebin_routing(fields, box, m, c, ns, backend="cuda", valid=st.valid, wrap=True)
    assert rebin_kernel.LAUNCHES == before + 1
    plain = rebin_kernel.rebin_routing(fields, box, m, c, ns, backend="torch", valid=st.valid, wrap=True)
    three = three_pass(build.load(), rebin_kernel._parked(fields, st.valid, box, True), box, m, c, ns)
    for ref in (plain, three):
        assert bool(got[1]) == bool(ref[1]) == (case == "y pass overflows")
        for i, (x, y) in enumerate(zip(got[0], ref[0])):
            assert torch.equal(_bits(x), _bits(y)), f"field {i}"
    assert int(((got[0][-1] != st.atom_id) & (got[0][-1] < ns)).sum()) > 10


def test_straggler_aux_staging_loops_and_empty_buffer(device):
    """K3's aux side at C_t = 40, where the 27·C = 1,080 candidates exceed a
    block of 1,024 threads and the staging loops: against the plain version
    within 2e-5 of the force scale and bit for bit the former
    one-warp-a-slot kernel (`emdee_straggler_aux_warp`), rerunning bitwise;
    then with an all-empty aux buffer: exact zeros."""
    from emdee_tpu_torch import StragglerConfig, straggler_init
    from emdee_tpu_torch.csrc import build
    from emdee_tpu_torch.neighbors import straggler_kernel
    from emdee_tpu_torch.tools.ab_rebin import aux_call

    n = 2048
    pos, box = cubic_lattice(n, 0.8442, jitter=0.1, seed=7)
    vel = maxwell_boltzmann(n, 0.8, seed=8)
    params = lennard_jones_atom(np.ones(n), np.ones(n), device=device)
    wide = suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.35)
    config = StragglerConfig(wide._replace(capacity=40), wide.capacity + 8, 64, 48)
    st = straggler_init(pos, vel, np.ones(n), params, config, device=device)
    nc, a_cap = config.grid.num_cells, config.aux_capacity
    av = st.aux_cell < nc
    assert 27 * config.grid.capacity > 1024 and int(av.sum()) >= 10 and not bool(st.grid.overflow)
    p = st.grid.positions.permute(2, 0, 1).contiguous()
    a = st.aux_positions.t().contiguous()
    args = (p[0], p[1], p[2], st.grid.valid, a[0], a[1], a[2], st.aux_cell)
    uni = (0.5, 2.0)
    outs = [torch.empty((3, a_cap), dtype=torch.float32, device=device) for _ in range(3)]
    before = straggler_kernel.LAUNCHES
    straggler_kernel.launch_aux(*args, outs[0], config, uni)
    straggler_kernel.launch_aux(*args, outs[1], config, uni)
    assert straggler_kernel.LAUNCHES == before + 2
    aux_call(build.load(), "emdee_straggler_aux_warp", args, outs[2], config, uni)
    want = straggler_kernel.aux_forces_plain(*args, config, uni)
    torch.cuda.synchronize()
    assert torch.equal(_bits(outs[0]), _bits(outs[1])) and torch.equal(_bits(outs[0]), _bits(outs[2]))
    scale = max(float(want[:, av].abs().max()), 1.0)
    assert float((outs[0] - want)[:, av].abs().max()) <= 2e-5 * scale
    assert bool((outs[0][:, ~av] == 0).all())

    empty = args[:7] + (torch.full_like(st.aux_cell, nc),)
    out = torch.full((3, a_cap), float("nan"), dtype=torch.float32, device=device)
    straggler_kernel.launch_aux(*empty, out, config, uni)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), torch.zeros_like(_bits(out)))


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
    before = compact_kernel.COMPACT_LAUNCHES
    got = compact_kernel.compact_stacked(*args, win, c, last_fill=777, backend="cuda")
    ref = compact_kernel.compact_stacked(*args, win, c, last_fill=777, backend="torch")
    torch.cuda.synchronize()
    assert compact_kernel.COMPACT_LAUNCHES == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    assert int((got[1] == 777).sum()) > 0


@pytest.mark.parametrize("stacked", [False, True])
def test_spill_rebin_kernel_matches_plain(device, stacked):
    """The spill route with K7 vs its plain version: every field of every
    slot, the valid mask and the flag; one K7 launch (its three passes)
    and no K4 launch."""
    from emdee_tpu_torch.neighbors import compact_kernel
    from emdee_tpu_torch.neighbors.cell_dense import _rebin_shift_core

    st, config, _ = _spill_state(device, drift=True)
    assert config.spill and not bool(st.overflow)
    if stacked:
        f = 0.1 * st.positions
        before = (compact_kernel.LAUNCHES, rebin_kernel.LAUNCHES)
        a, fa = _rebin_shift(st, config, forces=f, backend="cuda")
        b, fb = _rebin_shift(st, config, forces=f, backend="torch")
        assert (compact_kernel.LAUNCHES, rebin_kernel.LAUNCHES) == (before[0] + 1, before[1])
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


def _spill_case(device, case):
    """(state, config, extra fields) of a spill routing case: 'drifted',
    the 1,728-atom fixture squeezed toward 27, every atom moved 0.5σ per
    axis along its velocity's sign (its lattice sits 0.55σ inside the
    cell faces, so `_spill_state`'s 0.4σ crosses none); 'overflow', the
    same with every atom of the cells at y = 0 moved one cell up y, so
    that the y pass, between the other two, overflows; 'seam', 1,500 atoms
    at random on their spill config squeezed toward 24 and moved 0.4σ per
    axis along their velocities' signs (spills, hold-backs and seam wraps
    fire); 'c40', the same at C = 40 toward 28 (two chunks a segment);
    'water', the 98,304-atom water box on its spill geometry at C = 80
    toward the suggested 64, drifted 0.5 Å, with per-atom parameters,
    forces and charges riding (14 fields)."""
    from emdee_tpu_torch.tools import water
    from emdee_tpu_torch.utils.lattice import random_fluid

    extra = []
    if case in ("drifted", "overflow"):
        st, config, _ = _spill_state(device, drift=True)
        st = st._replace(positions=torch.where(st.valid[..., None], st.positions + 0.1 * torch.sign(st.velocities),
                                               0.0))
        if case == "overflow":
            m = config.cells_per_dim
            crowd = ((torch.arange(m**3, device=device) // m) % m == 0)[:, None] & st.valid
            pos = st.positions.clone()
            pos[..., 1] += torch.where(crowd, float(config.cell_side), 0.0)
            st = st._replace(positions=pos)
    elif case == "water":
        box, config, _, _, params = water.water_setup(device, spill=True)
        config = config._replace(capacity=80, spill_target=config.capacity)
        st = cell_dense_init(box["positions"], box["velocities"], box["masses"], params, config,
                             charges=box["charges"], device=device)
        st = st._replace(positions=torch.where(st.valid[..., None], st.positions + 0.5 * torch.sign(st.velocities),
                                               0.0))
        f = 0.1 * st.positions
        extra = [st.inv_masses, st.half_sigma, st.twice_sqrt_eps] + [f[..., i] for i in range(3)] + [st.charges]
    else:
        n = 1500
        pos, box = random_fluid(n, 0.75, 0.85, 0)
        config = suggest_cell_dense_config(n, box, 2.5, 2.0, 0.3, spill=True)
        config = config._replace(spill_target=24) if case == "seam" else config._replace(capacity=40, spill_target=28)
        st = cell_dense_init(pos, maxwell_boltzmann(n, 1.0, seed=1), np.ones(n),
                             lennard_jones_atom(np.ones(n), np.ones(n), device=device), config, device=device)
        st = st._replace(positions=torch.where(st.valid[..., None], st.positions + 0.4 * torch.sign(st.velocities),
                                               0.0))
    assert config.spill and not bool(st.overflow)
    return st, config, extra


@pytest.mark.parametrize("case", ["drifted", "overflow", "seam", "c40", "water"])
def test_spill_routing_kernel_matches_plain_and_witness(device, case):
    """K7, the spill route's three passes in one launch, against its plain
    version and against the former route on the card (the torch masks with
    the former compaction kernel): every field of every slot, the valid
    mask and the flag, bit for bit, on the caller's raw fields (strided
    position and velocity views, the valid mask, the wrap)."""
    from emdee_tpu_torch.neighbors import compact_kernel
    from emdee_tpu_torch.neighbors.cell_dense import _spill_params

    st, config, extra = _spill_case(device, case)
    fields = [st.positions[..., i] for i in range(3)] + [st.velocities[..., i] for i in range(3)] + extra
    fields.append(st.atom_id)
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    args = (fields, config.box, m, c, ns, _spill_params(config), st.valid)
    plain = compact_kernel.spill_routing(*args, backend="torch")
    before = (compact_kernel.COMPACT_LAUNCHES, compact_kernel.LAUNCHES)
    witness = compact_kernel.spill_route_plain(*args, compact="cuda")
    assert compact_kernel.COMPACT_LAUNCHES == before[0] + 3
    flat = lambda r: list(r[0]) + [r[1], r[2]]  # noqa: E731
    got = compact_kernel.spill_routing(*args, backend="cuda")
    torch.cuda.synchronize()
    for name, ref in (("plain", plain), ("witness", witness)):
        for i, (x, y) in enumerate(zip(flat(got), flat(ref))):
            assert torch.equal(_bits(x), _bits(y)), (name, i)
    assert compact_kernel.LAUNCHES == before[1] + 1
    assert bool(plain[2]) == (case == "overflow")
    moved = int(((plain[0][-1] != st.atom_id) & plain[1]).sum())
    assert moved > 100, moved
    if case in ("seam", "water"):  # seam spills and holds: coordinates stored below 0
        assert int(sum(int((plain[0][i][plain[1]] < 0).sum()) for i in range(3))) > 0


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
    assert (compact_kernel.LAUNCHES, rebin_kernel.LAUNCHES) == (8, 0)  # one a rebin
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
    before = k6.WINDOW_LAUNCHES
    for axis, _, cf in _PASSES:
        args = k6.periodic_windows(x, m, axis)
        out_k, ovf_k = k6.rebin_window_pass(*args, config.box, cf, m, c, ns, backend="cuda")
        out_p, ovf_p = k6.rebin_window_pass(*args, config.box, cf, m, c, ns, backend="torch")
        assert torch.equal(out_k, out_p) and bool(ovf_k) == bool(ovf_p) is False
        x = out_k.reshape(x.shape)
    assert k6.WINDOW_LAUNCHES == before + 3
    fields = tuple(_routing_stack(st, config)[i].view(torch.float32) for i in range(6)) + (st.atom_id,)
    ref, ovf = rebin_kernel.rebin_routing(fields, config.box, m, c, ns, backend="cuda")
    for i, r in enumerate(ref):
        assert torch.equal(x[i], r.view(torch.int32)), f"field {i}"
    assert int((x[-1] != st.atom_id).sum()) > 10


def _grid_fields(sh, ns):
    """A grid-sharded state's transported fields as the grid engine's rebin
    reads them: x, y, z, vx, vy, vz, 1/m, σ/2, 2√ε (views of the state's
    tensors), atom id (ns in empty slots)."""
    pos3, vel3 = sh.positions.movedim(-1, 0), sh.velocities.movedim(-1, 0)
    return ([pos3[i] for i in range(3)] + [vel3[i] for i in range(3)]
            + [sh.inv_masses, sh.half_sigma, sh.twice_sqrt_eps, torch.where(sh.valid, sh.atom_id, ns)])


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2), (2, 4, 1)])
def test_rebin_halo_kernel_matches_plain_witness_and_k4(device, shape):
    """K6 as the grid's rebin calls it (each pass on the shards' own rows
    with the two halo planes `mesh.shift` brings, the first on the raw
    fields, parked and wrapped in the kernel) on the drifted per-atom
    lattice at M = 8, C = 24, sharded over `shape`: every pass against its
    plain version and against the former kernel over whole windows, bit for
    bit in every slot and the flag; on one shard the three passes against
    K4's rebin of the one-card state."""
    from emdee_tpu_torch.distributed import grid_sharded as gs
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors import rebin_window_kernel as k6

    st, config, _ = _state(device, varied=True, drift=True, geometry={"cells_per_dim": 8, "capacity": 24})
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    mesh = make_grid_mesh(shape, device=device)
    sh = gs.distribute_grid(st, config, mesh)
    local = tuple(m // s for s in shape)
    x = _grid_fields(sh, ns)
    before = k6.LAUNCHES
    for axis in range(3):
        lo, hi = k6.halo_planes(x, mesh, axis)
        args = (x, lo, hi, k6.global_coords(mesh, local, axis), config.box, axis, m, c, ns, axis == 0)
        out, flag = k6.rebin_halo_pass(*args, backend="cuda")
        plain, ovf_p = k6.rebin_halo_plain(*args)
        witness, ovf_w = k6.rebin_halo_plain(*args, windows="cuda")
        torch.cuda.synchronize()
        assert torch.equal(out, plain) and torch.equal(out, witness), axis
        assert int(flag) == int(ovf_p) == int(ovf_w) == 0
        x = out
    assert k6.LAUNCHES == before + 3
    whole = gs.gather_grid_state(sh._replace(atom_id=x[-1]), config, mesh).atom_id
    assert int((whole != st.atom_id).sum()) > 50
    if shape == (1, 1, 1):
        fields = [st.positions[..., i] for i in range(3)] + [st.velocities[..., i] for i in range(3)]
        fields += [st.inv_masses, st.half_sigma, st.twice_sqrt_eps, st.atom_id]
        ref, ovf = rebin_kernel.rebin_routing(tuple(fields), config.box, m, c, ns, backend="cuda", valid=st.valid,
                                              wrap=True)
        assert not bool(ovf)
        for i, r in enumerate(ref):
            assert torch.equal(x[i].reshape(m**3, c), r.view(torch.int32)), f"field {i}"


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2), (2, 1, 2)])
@pytest.mark.parametrize("case", ["drifted", "overflow", "seam", "c40"])
def test_spill_halo_kernel_matches_plain_and_k7(device, case, shape):
    """K7-G, the grid's spill pass, as the grid's rebin calls it (each pass
    on the shards' own rows with the two-layer halo planes `mesh.shift`
    brings, the first on the raw fields, parked and wrapped in the kernel)
    on the spill cases of `_spill_case` at M = 4: on a split axis each
    shard holds 2 layers, so every row's q±2 lies across a shard face and
    both halo layers come from one neighbour; 'overflow' crowds the y
    pass.  Every pass against its plain version, bit for bit in every slot
    and the flag, three launches a rebin; on one shard the three passes
    against K7's route of the one-card state (the live slots, every slot
    of every field but the positions, whose fill differs, the mask and the
    flag)."""
    from emdee_tpu_torch.distributed import grid_sharded as gs
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors import compact_kernel
    from emdee_tpu_torch.neighbors import rebin_window_kernel as k6
    from emdee_tpu_torch.neighbors.cell_dense import _spill_params

    st, config, _ = _spill_case(device, case)
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    assert m == 4
    spill = _spill_params(config)
    mesh = make_grid_mesh(shape, device=device)
    sh = gs.distribute_grid(st, config, mesh)
    local = tuple(m // s for s in shape)
    x = _grid_fields(sh, ns)
    before, raised = k6.SPILL_LAUNCHES, False
    for axis in range(3):
        lo, hi = k6.halo_planes(x, mesh, axis, depth=2)
        args = (x, lo, hi, k6.global_coords(mesh, local, axis), config.box, axis, m, c, ns, spill, axis == 0)
        out, flag = k6.spill_halo_pass(*args, backend="cuda")
        plain, ovf = k6.spill_halo_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(out, plain), axis
        assert bool(flag) == bool(ovf), axis
        raised |= bool(flag)
        x = out
    assert k6.SPILL_LAUNCHES == before + 3
    assert raised == (case == "overflow")
    whole = gs.gather_grid_state(sh._replace(atom_id=x[-1]), config, mesh).atom_id
    assert int((whole != st.atom_id).sum()) > 10
    if shape == (1, 1, 1):
        fields = [st.positions[..., i] for i in range(3)] + [st.velocities[..., i] for i in range(3)]
        fields += [st.inv_masses, st.half_sigma, st.twice_sqrt_eps, st.atom_id]
        ref, valid, ovf = compact_kernel.spill_routing(tuple(fields), config.box, m, c, ns, spill, st.valid,
                                                       backend="cuda")
        assert bool(ovf) == raised
        got = x.reshape(len(fields), m**3, c)
        assert torch.equal(got[-1] < ns, valid)
        for i, r in enumerate(ref):
            mask = valid if i < 3 else torch.ones_like(valid)
            assert torch.equal(got[i][mask], r.view(torch.int32)[mask]), f"field {i}"


def _spill_grid_vs_passes(st, config, shape):
    """K7-G's one-launch form on `st` sharded over a `LocalMesh` of
    `shape`, against its plain version and against three launches of the
    per-pass form over halo planes, bit for bit in every slot and the
    flag, one launch a rebin.  Returns the flag."""
    from emdee_tpu_torch.distributed import grid_sharded as gs
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors import rebin_window_kernel as k6
    from emdee_tpu_torch.neighbors.cell_dense import _spill_params

    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    spill = _spill_params(config)
    mesh = make_grid_mesh(shape, device=st.positions.device)
    local = tuple(m // s for s in shape)
    coords = [k6.global_coords(mesh, local, axis) for axis in range(3)]
    fields = _grid_fields(gs.distribute_grid(st, config, mesh), ns)
    x, flag_p = fields, None
    for axis in range(3):
        lo, hi = k6.halo_planes(x, mesh, axis, depth=2)
        x, flag_p = k6.spill_halo_pass(x, lo, hi, coords[axis], config.box, axis, m, c, ns, spill, raw=axis == 0,
                                       flag=flag_p, backend="cuda")
    before, spill_before = k6.GRID_SPILL_LAUNCHES, k6.SPILL_LAUNCHES
    out, flag = k6.spill_grid_rebin(fields, mesh, coords, config.box, m, c, ns, spill, backend="cuda")
    plain, ovf = k6.spill_grid_rebin_plain(fields, config.box, m, c, ns, spill)
    torch.cuda.synchronize()
    assert k6.GRID_SPILL_LAUNCHES == before + 1 and k6.SPILL_LAUNCHES == spill_before
    assert torch.equal(out, plain) and torch.equal(out, x)
    assert bool(flag) == bool(ovf) == bool(flag_p)
    return bool(flag)


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2), (2, 1, 2)])
@pytest.mark.parametrize("case", ["drifted", "overflow", "seam", "c40"])
def test_spill_grid_kernel_matches_plain_and_passes(device, case, shape):
    """K7-G's one-launch form (`spill_grid_rebin` on a `LocalMesh`: the
    three passes in one cooperative launch, reading a row's neighbours in
    the neighbouring shard in place) on `_spill_case`'s cases at M = 4:
    against its plain version and against three launches of the per-pass
    form over halo planes, bit for bit in every slot and the flag; one
    launch a rebin."""
    st, config, _ = _spill_case(device, case)
    assert _spill_grid_vs_passes(st, config, shape) == (case == "overflow")


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2), (2, 1, 2)])
@pytest.mark.parametrize("case", ["drifted", "overflow", "c40"])
def test_spill_grid_kernel_row_loop(device, case, shape):
    """K7-G's one-launch form where its persistent grid's warps each take
    several rows: 287,496 jittered lattice atoms at ρ = 0.75 on their spill
    config's M = 24 (13,824 rows) at C = 32, squeezed toward 21 atoms a
    cell, moved 0.25σ per axis along their velocities' signs; 'overflow'
    moves the cells at y = 0 one cell up y; 'c40' at C = 40 (two chunks a
    row).
    More rows than the card holds resident warps, and the one-launch form
    against its plain version and three per-pass launches, bit for bit."""
    import ctypes

    from emdee_tpu_torch.csrc import build

    n = 66**3
    pos, box = cubic_lattice(n, 0.75, jitter=0.12, seed=9)
    config = suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.3, spill=True)
    config = config._replace(spill_target=21, capacity=40 if case == "c40" else 32)
    m = config.cells_per_dim
    assert m == 24
    st = cell_dense_init(pos, maxwell_boltzmann(n, 1.0, seed=10), np.ones(n),
                         lennard_jones_atom(np.ones(n), np.ones(n), device=device), config, device=device)
    assert not bool(st.overflow)
    pos = torch.where(st.valid[..., None], st.positions + 0.25 * torch.sign(st.velocities), 0.0)
    if case == "overflow":
        crowd = ((torch.arange(m**3, device=device) // m) % m == 0)[:, None] & st.valid
        pos[..., 1] += torch.where(crowd, float(config.cell_side), 0.0)
    attrs = (ctypes.c_int * 4)()
    build.check(build.load().emdee_spill_grid_attrs(attrs), "spill_grid attrs")
    per_sm, sms, _, warps_a_block = attrs
    assert m**3 > 2 * per_sm * sms * warps_a_block  # every warp takes two rows or more
    assert _spill_grid_vs_passes(st._replace(positions=pos), config, shape) == (case == "overflow")


# (atoms, density, M) of the jittered lattice for each capacity: every cell
# fits (the fullest holds 18, 27, 27, 46, 46), and at C = 56 and 88 a cell's
# second warp takes live centres.
_GHOST_GEOMETRY = {24: (2048, 0.4, 6), 32: (1372, 0.6, 4), 40: (1372, 0.6, 4), 56: (2048, 0.6, 4),
                   88: (2048, 0.6, 4)}


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2)])
@pytest.mark.parametrize("capacity", [24, 32, 40, 56, 88])
def test_ghost_force_kernel_equals_k2_and_matches_plain(device, capacity, shape):
    """The grid's GHOST mode (K2-G: the LJ pass's warp-owned kernel on the
    ghost grids since its redesign) against the one-card LJ pass (K2a/K2b:
    warp-owned cells, the cull) on the same drifted state, sharded over
    `shape`: per-atom forces
    with energies and virials, per-atom forces alone and uniform forces
    (K2a's component entry) bit for bit, at C = 24 … 88 (one to three warps
    a cell); the GHOST kernel within 2e-5 of the force scale of its plain
    version."""
    from emdee_tpu_torch.distributed import grid_sharded as gs
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh

    n, density, m = _GHOST_GEOMETRY[capacity]
    st, config, model = _state(device, n=n, drift=True, density=density,
                               geometry={"cells_per_dim": m, "capacity": capacity})
    assert not bool(st.overflow)
    mesh = make_grid_mesh(shape, device=device)
    sh = gs.distribute_grid(st, config, mesh)
    roll_k, _ = gs.make_grid_sharded_sim(config, model, 0.002, mesh, backend="cuda")
    roll_u, _ = gs.make_grid_sharded_sim(config, model, 0.002, mesh, uniform_params=(0.5, 2.0), backend="cuda")
    roll_p, _ = gs.make_grid_sharded_sim(config, model, 0.002, mesh, backend="torch")
    before = cell_kernel.LAUNCHES
    got = roll_k.forces(sh, compute_energy=True)
    assert cell_kernel.LAUNCHES == before + 1
    whole = lambda f, e=None, w=None: gs.gather_grid_state(sh._replace(  # noqa: E731
        positions=f, half_sigma=sh.half_sigma if e is None else e,
        twice_sqrt_eps=sh.twice_sqrt_eps if w is None else w), config, mesh)
    k, p = whole(*got), whole(*roll_p.forces(sh, compute_energy=True))
    ref = cell_kernel.cell_forces(st, model, config, compute_energy=True, backend="cuda")
    for a, b in zip((k.positions, k.half_sigma, k.twice_sqrt_eps), ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    f_only = whole(roll_k.forces(sh)[0]).positions
    assert torch.equal(f_only.view(torch.int32), cell_kernel.cell_forces(st, model, config, backend="cuda")[0]
                       .view(torch.int32))
    f_uni = whole(roll_u.forces(sh)[0]).positions
    comps = [st.positions[..., i].contiguous() for i in range(3)]
    ref_u = cell_kernel.cell_forces_split(*comps, st.valid, config, uniform_params=(0.5, 2.0), backend="cuda")
    for i in range(3):
        assert torch.equal(f_uni[..., i].view(torch.int32), ref_u[i].view(torch.int32))
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


@pytest.mark.parametrize("transposed", [False, True])
def test_probe_cen_matches_plain_and_matmul_at_the_probe_shape(device, transposed):
    """P2 (register-tiled) at the probe's full shape (289 programs of (96,
    17) @ (17, 544)) in both layouts: within 1e-5 relative of its plain
    version and of `torch.matmul` with TF32 off."""
    from emdee_tpu_torch.tools import probes

    cen, expand = probes.probe_cen_inputs(transposed, device)
    got = probes.probe_cen(cen, expand, transposed)
    want = probes.probe_cen_plain(cen, expand, transposed)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib = torch.matmul(cen.transpose(1, 2) if transposed else cen, expand)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    for other in (want, lib):
        np.testing.assert_allclose(got.cpu().numpy(), other.cpu().numpy(), rtol=1e-5)


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


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2), (2, 1, 2)])
@pytest.mark.parametrize("capacity", [24, 80, 88])
def test_k2c_matches_plain_reruns_bitwise_and_equals_k2c_g(device, capacity, shape):
    """K2c (the culled kernel with per-lane lists) on the charged fixture at
    C = 24, 80, 88 (one to three warps a cell): with and without the bond
    tags and energies, within 2e-4 of the force scale and 1e-3 of its plain
    version, empty slots exactly 0, a second call bitwise equal; without the
    bond tags its forces, energies and virials bit for bit K2c-G's (its
    GHOST mode on the ghost grids) on the same state sharded over `shape`:
    the cull, the lists and the ghost walk drop no pair and reorder no
    sum."""
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid, gather_grid_state
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh

    st, config, model, coul, tags = fixtures.charged_fixture(device, capacity)
    v = st.valid
    for excl in (tags, tags[:3]):
        for energy in (False, True):
            kw = dict(compute_energy=energy, coulomb=coul, excl=excl)
            got = cell_kernel.cell_forces(st, model, config, backend="cuda", **kw)
            again = cell_kernel.cell_forces(st, model, config, backend="cuda", **kw)
            fp, ep, wp = cell_kernel.cell_forces(st, model, config, backend="torch", **kw)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
            scale = max(float(fp[v].abs().max()), 1.0)
            assert float((got[0] - fp)[v].abs().max()) <= 2e-4 * scale
            assert bool((got[0][~v] == 0).all())
            if energy:
                for a, b in ((got[1], ep), (got[2], wp)):
                    assert float((a - b)[v].abs().max()) <= 1e-3
                    assert bool((a[~v] == 0).all())
    ref = cell_kernel.cell_forces(st, model, config, compute_energy=True, backend="cuda", coulomb=coul, excl=tags[:3])
    mesh = make_grid_mesh(shape, device=device)
    sh = distribute_grid(st, config, mesh)
    shard = lambda t: distribute_grid(st._replace(positions=t), config, mesh).positions  # noqa: E731
    gh = _ghost_stack(sh, mesh, coulomb=True, excl=True)
    f, e, w = cell_kernel.ghost_forces(gh, mesh.local_shape, mesh.base, config, model, compute_energy=True,
                                       backend="cuda", coulomb=coul, excl=tuple(shard(t) for t in tags[:3]))
    k = gather_grid_state(sh._replace(positions=f.movedim(0, -1), half_sigma=e, twice_sqrt_eps=w), config, mesh)
    for a, b in zip((k.positions, k.half_sigma, k.twice_sqrt_eps), ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_molecular_water_rollout_matches_plain_and_reruns_bitwise(device):
    """A 1,536-atom flexible-water box (`tools/water.py`, 8³ waters, M = 3)
    on 'cuda' (bonds absorbed in K2c) against 'torch' (the gather path)
    after 20 steps within 2e-3 / 5e-2; two 'cuda' rollouts bitwise equal;
    the grid engine takes the per-shard streaming backend (K5s) on the box,
    its energies with DSF alone within 1e-5 of the resident family's (K2-G)."""
    from emdee_tpu_torch import gather_dense_atoms
    from emdee_tpu_torch.distributed import grid_sharded as gs
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
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
    mesh = make_grid_mesh((1, 1, 1), device=device)
    sh = gs.distribute_grid(st, config, mesh)
    roll_s, energy_s = gs.make_grid_sharded_sim(config, model, water.DT, mesh, backend="cuda_streaming", coulomb=coul)
    _, energy_r = gs.make_grid_sharded_sim(config, model, water.DT, mesh, backend="cuda", coulomb=coul)
    assert roll_s.family == "cuda_streaming"
    for got, want in zip(energy_s(sh), energy_r(sh)):
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want)) + 1e-2


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


@pytest.mark.parametrize("capacity", [None, 40, 72])
@pytest.mark.parametrize("variant", ["coulomb", "tags", "coulomb_tags", "bonds", "coulomb_bonds"])
def test_streaming_molecular_kernel_matches_plain(device, variant, capacity):
    """K5c (the streaming kernel's DSF, exclusion tags and tag-borne bonds)
    against its plain version (K2c's) and against K2c, with one, two and
    three centre slots a lane (C = 24, 40, 72): forces within 2e-4 of the
    force scale, per-slot energies and virials within 1e-3, empty slots
    exactly 0; two launches a call (the pair pass and the fold)."""
    st, config, model, coul, tags = fixtures.charged_fixture(device, capacity)
    c = coul if "coulomb" in variant else None
    excl = None if variant == "coulomb" else (tags if "bonds" in variant else tags[:3])
    before = streaming_kernel.LAUNCHES
    for energy in (False, True):
        kw = dict(compute_energy=energy, coulomb=c, excl=excl)
        fk, ek, wk = streaming_kernel.cell_forces_streaming(st, model, config, backend="cuda", **kw)
        fp, ep, wp = streaming_kernel.cell_forces_streaming(st, model, config, backend="torch", **kw)
        f2, e2, w2 = cell_kernel.cell_forces(st, model, config, backend="cuda", **kw)
        torch.cuda.synchronize()
        v = st.valid
        scale = max(float(fp[v].abs().max()), 1.0)
        assert float((fk - fp)[v].abs().max()) <= 2e-4 * scale
        assert float((fk - f2)[v].abs().max()) <= 2e-4 * scale
        assert bool((fk[~v] == 0).all())
        if energy:
            for a, b in ((ek, ep), (wk, wp), (ek, e2), (wk, w2)):
                assert float((a - b)[v].abs().max()) <= 1e-3
            assert bool((ek[~v] == 0).all()) and bool((wk[~v] == 0).all())
    assert streaming_kernel.LAUNCHES == before + 4


@pytest.mark.parametrize("capacity", [80, 88])
def test_k5c_matches_plain_at_water_capacities_and_reruns_bitwise(device, capacity):
    """K5c (warp-owned centre cells, the bounding-box cull) at the water
    boxes' capacities (C = 80 and 88: three centre slots a lane) on the
    charged fixture, DSF with the bond tags, forces alone and with energies:
    within 2e-4 of the force scale and 1e-3 of its plain version, empty
    slots exactly 0; a second call bitwise equal; the variant's resources
    as the card reports them."""
    st, config, model, coul, tags = fixtures.charged_fixture(device, capacity)
    v = st.valid
    for energy, excl in ((False, tags), (True, tags[:3])):
        kw = dict(compute_energy=energy, coulomb=coul, excl=excl)
        got = streaming_kernel.cell_forces_streaming(st, model, config, backend="cuda", **kw)
        again = streaming_kernel.cell_forces_streaming(st, model, config, backend="cuda", **kw)
        fp, ep, wp = streaming_kernel.cell_forces_streaming(st, model, config, backend="torch", **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
        scale = max(float(fp[v].abs().max()), 1.0)
        assert float((got[0] - fp)[v].abs().max()) <= 2e-4 * scale
        assert bool((got[0][~v] == 0).all())
        if energy:
            for a, b in ((got[1], ep), (got[2], wp)):
                assert float((a - b)[v].abs().max()) <= 1e-3
                assert bool((a[~v] == 0).all())
        res = streaming_kernel.k5c_resources(config, coul, excl, energy)
        assert res["registers"] > 0 and res["blocks_per_sm"] >= 1
        assert res["smem_bytes"] >= streaming_kernel.smem_bytes(config, energy, True, excl[0].shape[-1],
                                                                0 if len(excl) == 3 else excl[3][0].shape[-1])


# Cells fuller than 96 and 192 atoms (`fixtures.crowded_arrays`): at C =
# 104 the streaming family runs two 96-entry chunks a cell, at C = 200 three.
_CROWDED = {104: ((5, 5, 4), 6.0), 200: ((7, 7, 4), 8.5)}


def _crowded(device, capacity, m=3):
    """The crowded charged box at C: (state, config, LJ model, DSF model,
    slot tags with bond weights), every cell holding 100 (C = 104) or 196
    (C = 200) atoms, drifted 0.45·skin."""
    per, edge = _CROWDED[capacity]
    st, config, model, coul, tags = fixtures.charged_fixture(device, capacity, fixtures.crowded_arrays(per, m, edge), m)
    assert not bool(st.overflow) and int(st.valid.sum(1).min()) > 96 * ((capacity - 1) // 96)
    return st, config, model, coul, tags


@pytest.mark.parametrize("capacity", [104, 200])
def test_streaming_chunked_kernel_matches_plain_and_reruns_bitwise(device, capacity):
    """F1: K5 above three centre slots a lane (its chunked variant: a cell
    compacted into 96-entry chunks, a cell pair run chunk pair by chunk
    pair with the cull) on cells of 100 and 196 atoms, two and three chunks:
    the stacked entry (per-atom, forces alone and with energies) and the
    split entry (uniform) against the plain version within 2e-5 of the
    force scale, energies and virials at the one-card test's gates, empty
    slots exactly 0, two launches a call, a second call bitwise equal; the
    split entry equals the stacked uniform one bit for bit; the card reports
    the variant's resources."""
    st, config, model, _, _ = _crowded(device, capacity)
    v = st.valid
    uni = (0.5, 2.0)
    for energy in (False, True):
        before = streaming_kernel.LAUNCHES
        got = streaming_kernel.cell_forces_streaming(st, model, config, compute_energy=energy, backend="cuda")
        again = streaming_kernel.cell_forces_streaming(st, model, config, compute_energy=energy, backend="cuda")
        fp, ep, wp = streaming_kernel.cell_forces_streaming(st, model, config, compute_energy=energy, backend="torch")
        torch.cuda.synchronize()
        assert streaming_kernel.LAUNCHES == before + 4
        assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
        scale = max(float(fp[v].abs().max()), 1.0)
        assert float((got[0] - fp)[v].abs().max()) <= 2e-5 * scale
        assert bool((got[0][~v] == 0).all())
        if energy:
            np.testing.assert_allclose(got[1][v].cpu().numpy(), ep[v].cpu().numpy(), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got[2][v].cpu().numpy(), wp[v].cpu().numpy(), rtol=1e-4, atol=2e-3)
        res = streaming_kernel.k5_resources(config, False, energy)
        assert res["registers"] > 0 and res["blocks_per_sm"] >= 1 and res["warps_per_block"] >= 1
    comps = [st.positions[..., i].contiguous() for i in range(3)]
    fk = streaming_kernel.cell_forces_streaming_split(*comps, v, config, uniform_params=uni, backend="cuda")
    f2 = streaming_kernel.cell_forces_streaming_split(*comps, v, config, uniform_params=uni, backend="cuda")
    fp = streaming_kernel.cell_forces_streaming_split(*comps, v, config, uniform_params=uni, backend="torch")
    stacked = streaming_kernel.cell_forces_streaming(st, model, config, uniform_params=uni, backend="cuda")[0]
    assert all(torch.equal(a, b) for a, b in zip(fk, f2))
    assert torch.equal(torch.stack(fk, -1), stacked)
    scale = max(max(float(f[v].abs().max()) for f in fp), 1.0)
    assert max(float((a - b)[v].abs().max()) for a, b in zip(fk, fp)) <= 2e-5 * scale


@pytest.mark.parametrize("capacity", [104, 200])
@pytest.mark.parametrize("variant", ["coulomb_tags", "coulomb_bonds"])
def test_k5c_chunked_matches_plain_and_reruns_bitwise(device, variant, capacity):
    """F1: K5c's chunked variant on cells of 100 and 196 atoms (two and
    three chunks), DSF with the tags (and the bond tags): within 2e-4 of the
    force scale and 1e-3 in energies and virials of its plain version and
    of K2c, empty slots exactly 0, a second call bitwise equal; the card
    reports the variant's resources (its warps a block as the wrapper
    counts them; no spill, its launch bounds asking for two blocks an SM)."""
    st, config, model, coul, tags = _crowded(device, capacity)
    v = st.valid
    excl = tags if variant == "coulomb_bonds" else tags[:3]
    for energy in (False, True):
        kw = dict(compute_energy=energy, coulomb=coul, excl=excl)
        got = streaming_kernel.cell_forces_streaming(st, model, config, backend="cuda", **kw)
        again = streaming_kernel.cell_forces_streaming(st, model, config, backend="cuda", **kw)
        fp, ep, wp = streaming_kernel.cell_forces_streaming(st, model, config, backend="torch", **kw)
        f2, e2, w2 = cell_kernel.cell_forces(st, model, config, backend="cuda", **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
        scale = max(float(fp[v].abs().max()), 1.0)
        assert float((got[0] - fp)[v].abs().max()) <= 2e-4 * scale
        assert float((got[0] - f2)[v].abs().max()) <= 2e-4 * scale
        assert bool((got[0][~v] == 0).all())
        if energy:
            for a, b in ((got[1], ep), (got[2], wp), (got[1], e2), (got[2], w2)):
                assert float((a - b)[v].abs().max()) <= 1e-3
        res = streaming_kernel.k5c_resources(config, coul, excl, energy)
        assert res["registers"] > 0 and res["blocks_per_sm"] >= 1 and res["warps_per_block"] >= 1
        assert res["local_bytes"] == 0, res


@pytest.mark.parametrize("capacity", [104, 200])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2)])
def test_k5s_chunked_kernels_match_plain(device, shape, capacity):
    """F1 on the grid's shards: the K5s pencil (LJ, uniform and per-atom)
    and K5s-mol (DSF and the tags) in their chunked variants on the crowded
    box at M = 4 (cells of 100 and 196 atoms), against their plain versions
    before the fold and, after it, against the one-card K5 and K5c, at the
    gates of the C ≤ 96 tests; reruns bitwise (`_k5s_vs_plain`)."""
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh

    st, config, model, coul, tags = _crowded(device, capacity, m=4)
    mesh = make_grid_mesh(shape, device=device)
    sh = distribute_grid(st, config, mesh)
    for uni in (None, (0.5, 2.0)):
        one = streaming_kernel.cell_forces_streaming(st, model, config, backend="cuda", uniform_params=uni)[0]
        _k5s_vs_plain(sh, mesh, config, model, one, 2e-5, 1e-4, 2e-3, 1e-4, uniform_params=uni)
    one = streaming_kernel.cell_forces_streaming(st, model, config, backend="cuda", coulomb=coul, excl=tags[:3])[0]
    shard = lambda t: distribute_grid(st._replace(positions=t), config, mesh).positions  # noqa: E731
    _k5s_vs_plain(sh, mesh, config, model, one, 2e-4, 1e-3, 1e-3, 0.0, coulomb=coul,
                  excl=tuple(shard(t) for t in tags[:3]))


# Seven bonded pairs 2.47–2.48 apart (the cutoff is 2.5) in a 12³ box of
# 4³ cells, each atom alone in its cell, so that a cell's bounding box is
# the atom itself: across a face, an edge and a corner, each also across
# the periodic seam, and a face pair whose second atom is stored in the
# cell at x = 6.1 but overhangs it by 0.2 toward its partner, as atoms do
# between rebins.  (first atom, second atom as binned, second atom's x.)
_CULL_PAIRS = (
    ((0.30, 4.5, 4.5), (9.82, 4.5, 4.5), None),  # face, across the seam in x
    ((2.125, 2.125, 7.5), (3.875, 3.875, 7.5), None),  # edge
    ((7.5, 0.62, 0.62), (7.5, 10.87, 10.87), None),  # edge, across the seam in y and z
    ((2.29, 8.29, 5.29), (3.72, 9.72, 6.72), None),  # corner
    ((0.70, 0.70, 0.70), (11.27, 11.27, 11.27), None),  # corner, across the seam in x, y and z
    ((5.29, 6.71, 8.29), (6.72, 5.28, 9.72), None),  # corner, the y offset negative
    ((3.42, 10.5, 1.5), (6.1, 10.5, 1.5), 5.9),  # face, the second atom overhanging its cell
)


def _cull_pairs_positions(device, capacity, copies=1, charges=None):
    """The `_CULL_PAIRS` box as a dense state with unit LJ parameters (and
    `charges`, if given): (state, config, the positions as stored (n, 3),
    box edge), each overhanging atom moved after binning."""
    from emdee_tpu_torch import cell_dense_init, lennard_jones_atom

    base = np.array([p for a, b, _ in _CULL_PAIRS for p in (a, b)], np.float64)
    tiles = 12.0 * np.array([(i, j, k) for i in range(copies) for j in range(copies) for k in range(copies)])
    pos = (base[None] + tiles[:, None]).reshape(-1, 3)
    n, edge = len(pos), 12.0 * copies
    config = suggest_cell_dense_config(n, edge, cutoff=fixtures.CUTOFF, switch=fixtures.SWITCH,
                                       skin=fixtures.CHARGED_SKIN)._replace(capacity=capacity)
    st = cell_dense_init(pos, np.zeros_like(pos), np.ones(n), lennard_jones_atom(np.ones(n), np.ones(n),
                         device=device), config, charges=charges, device=device)
    for a, b, x in _CULL_PAIRS:
        for t in tiles if x is not None else ():
            hit = st.valid & ((st.positions - torch.tensor(b + t, dtype=torch.float32, device=device)).abs()
                              .amax(-1) < 1e-5)
            assert int(hit.sum()) == 1
            st = st._replace(positions=torch.where(hit[..., None] & (torch.arange(3, device=device) == 0),
                                                   torch.tensor(x + t[0], dtype=torch.float32, device=device),
                                                   st.positions))
            pos[np.all(np.abs(pos - (b + t)) < 1e-5, axis=1), 0] = x + t[0]
    return st, config, pos, edge


def _cull_pairs_state(device, capacity, bonded=True, copies=1):
    """The `_CULL_PAIRS` box on the port: (state, config, LJ model, DSF
    model, slot tags, exclusion tables).  bonded: each pair is a harmonic
    bond (k = 40, r0 = 1.1) with its LJ and Coulomb excluded, the tags
    carry the bond weights; else each pair's LJ is excluded and its DSF
    Coulomb kept, no bond.  Charges ±0.4.  copies = 2: the 12³ box tiled
    2 × 2 × 2 into a 24³ box of 8³ cells (the same periodic system, every
    atom with its one partner, some pairs now across the inner faces at 12),
    so that (2,4,1) has two cell layers a shard."""
    from emdee_tpu_torch import DSFCoulomb, LennardJonesModel, build_exclusion_tables, make_exclusion_aux_fn

    n = 2 * len(_CULL_PAIRS) * copies**3
    q = np.tile(np.array([0.4, -0.4], np.float32), n // 2)
    st, config, pos, edge = _cull_pairs_positions(device, capacity, copies, q)
    d = pos[:, None] - pos[None]
    d -= edge * np.round(d / edge)
    bonds = np.argwhere(np.triu((d * d).sum(-1) < fixtures.CUTOFF**2, 1))  # each atom's one partner
    assert len(bonds) == n // 2
    zeros = np.zeros(len(bonds), np.float32)
    if bonded:
        tabs, _, bond_tabs, _ = build_exclusion_tables(
            n, bonds, zeros, zeros, bonds=(bonds, np.full(len(bonds), 40.0, np.float32),
                                           np.full(len(bonds), 1.1, np.float32)))
        tags = make_exclusion_aux_fn(n, *tabs, bond_tabs=bond_tabs)(st)
    else:
        tabs = build_exclusion_tables(n, bonds, zeros, np.ones(len(bonds), np.float32))
        tags = make_exclusion_aux_fn(n, *tabs)(st)
    coul = DSFCoulomb.create(fixtures.CUTOFF, alpha=0.25, coulomb_constant=1.0, device=device)
    return st, config, LennardJonesModel.create(fixtures.CUTOFF, fixtures.SWITCH, device=device), coul, tags, tabs


@pytest.mark.parametrize("capacity", [24, 88])
@pytest.mark.parametrize("kernel", ["K5c", "K2c"])
def test_k5c_cull_keeps_bonded_pairs_just_inside_the_cutoff(device, kernel, capacity):
    """K5c's cull (and K2c's: the warp's centre box against each neighbour
    cell) drops no pair inside the cutoff across a face, an edge or a corner
    offset, the periodic seam, or an atom's overhang (`_CULL_PAIRS`).  The
    switched LJ and the shifted-force DSF vanish at the cutoff and could not
    show a dropped pair; each pair's bond force there is ~55, beyond the
    2e-4-of-scale gate by more than a hundredfold, so a cull a few
    hundredths too tight fails it; each atom's force is also held within
    1e-3 of its own magnitude."""
    fn = streaming_kernel.cell_forces_streaming if kernel == "K5c" else cell_kernel.cell_forces
    st, config, model, coul, tags, _ = _cull_pairs_state(device, capacity)
    v = st.valid
    for energy in (False, True):
        kw = dict(compute_energy=energy, coulomb=coul, excl=tags)
        got = fn(st, model, config, backend="cuda", **kw)
        fp, ep, wp = fn(st, model, config, backend="torch", **kw)
        torch.cuda.synchronize()
        scale = max(float(fp[v].abs().max()), 1.0)
        tol = 2e-4 * scale
        assert float(fp[v].norm(dim=-1).min()) > 100 * tol  # every atom feels its bond
        assert float((got[0] - fp)[v].abs().max()) <= tol
        assert bool(((got[0] - fp)[v].norm(dim=-1) <= 1e-3 * fp[v].norm(dim=-1)).all())
        if energy:
            for a, b in ((got[1], ep), (got[2], wp)):
                assert float((a - b)[v].abs().max()) <= 1e-3


def _empty_strag_operands(st, config):
    """K3's operands with nothing parked: the state's component arrays, an
    empty aux buffer (A = 8, every lane at cell M³) and an all-empty (M²,
    Kn = 4) list table; (args for `straggler_forces`, StragglerConfig)."""
    from emdee_tpu_torch import StragglerConfig

    dev = st.positions.device
    sconfig = StragglerConfig(config, config.capacity + 4, 8, 4)
    comps = [st.positions[..., i].contiguous() for i in range(3)]
    aux = [torch.zeros(8, dtype=torch.float32, device=dev) for _ in range(3)]
    acell = torch.full((8,), config.num_cells, dtype=torch.int32, device=dev)
    table = torch.full((config.cells_per_dim**2, 4), -1, dtype=torch.int32, device=dev)
    return (*comps, st.valid, *aux, acell, table, sconfig), sconfig


@pytest.mark.parametrize("capacity", [24, 32, 104])
def test_lj_cull_keeps_switch_region_pairs_per_atom(device, capacity):
    """The LJ pass (K2a, K2b with and without energies, K3's grid side with
    nothing parked, and K2-G, the grid's GHOST mode, on (1,1,1) and (2,2,2)
    with and without energies, gathered to the one-card slots) and the
    one-card streaming pass (K5's split entry and its stacked entry with and
    without energies; at C = 104 its chunked variant) and its GHOST mode
    (K5s with the fold, on (1,1,1) and (2,2,2) with and without energies,
    gathered alike) drop no pair in the
    switch region just inside the cutoff: the `_CULL_PAIRS` geometry with unit LJ and nothing else — each
    atom alone in its cell with one partner at 0.988–0.992 rc across a face,
    an edge or a corner, the periodic seam, or an overhang — so each atom's
    force is its one pair's (~4e-3, the switch nearly closed) and a dropped
    pair fails by its whole force.  Each atom is held to its own plain force
    within 1e-3 of its magnitude, and with energies each slot's energy and
    virial within 1e-2 of theirs (the energy there is the switch's small
    remainder, S ≈ 3e-3, whose float32 rounding reaches ~1e-3 of it; a
    dropped pair misses it whole)."""
    from emdee_tpu_torch.distributed import grid_sharded as gs
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors import straggler_kernel

    st, config, pos, edge = _cull_pairs_positions(device, capacity)
    d = pos[:, None] - pos[None]
    d -= edge * np.round(d / edge)
    r = np.sqrt((d * d).sum(-1)) + 99.0 * np.eye(len(pos))
    assert (r.min(1) >= 0.97 * fixtures.CUTOFF).all() and (np.sort(r, 1)[:, 1] > fixtures.CUTOFF).all()
    model = LennardJonesModel.create(fixtures.CUTOFF, fixtures.SWITCH, device=device)
    v = st.valid
    uni = (0.5, 2.0)
    comps = [st.positions[..., i].contiguous() for i in range(3)]
    args, sconfig = _empty_strag_operands(st, config)
    runs = {
        "K2a": (lambda b: torch.stack(cell_kernel.cell_forces_split(*comps, v, config, uniform_params=uni,
                                                                    backend=b), -1), None),
        "K2b": (lambda b: cell_kernel.cell_forces(st, model, config, backend=b)[0], None),
        "K2b energies": (None, lambda b: cell_kernel.cell_forces(st, model, config, compute_energy=True, backend=b)),
        "K3": (lambda b: straggler_kernel.straggler_forces(*args, uni, backend=b)[0].permute(1, 2, 0), None),
        "K5 split": (lambda b: torch.stack(streaming_kernel.cell_forces_streaming_split(
            *comps, v, config, uniform_params=uni, backend=b), -1), None),
        "K5": (lambda b: streaming_kernel.cell_forces_streaming(st, model, config, backend=b)[0], None),
        "K5 energies": (None, lambda b: streaming_kernel.cell_forces_streaming(st, model, config,
                                                                              compute_energy=True, backend=b)),
    }

    def grid(shape, energy, family):
        """The grid's forces (and energies, virials) on `shape` through the
        kernel `family` ('cuda': K2-G; 'cuda_streaming': K5s and the fold)
        or its plain version, in one-card slots."""
        mesh = make_grid_mesh(shape, device=device)
        sh = gs.distribute_grid(st, config, mesh)
        plain = "torch" if family == "cuda" else "torch_streaming"

        def run(b):
            roll, _ = gs.make_grid_sharded_sim(config, model, 0.002, mesh, backend=family if b == "cuda" else plain)
            assert roll.family == (family if b == "cuda" else plain)
            f, e, w = roll.forces(sh, compute_energy=energy)
            whole = gs.gather_grid_state(sh._replace(positions=f, half_sigma=sh.half_sigma if e is None else e,
                                                     twice_sqrt_eps=sh.twice_sqrt_eps if w is None else w),
                                         config, mesh)
            return (whole.positions, whole.half_sigma, whole.twice_sqrt_eps) if energy else whole.positions
        return run

    for shape in ((1, 1, 1), (2, 2, 2)):
        for kernel, family in (("K2-G", "cuda"), ("K5s", "cuda_streaming")):
            name = f"{kernel} {shape}"
            runs[name] = (grid(shape, False, family), None)
            runs[name + " energies"] = (None, grid(shape, True, family))
    failed = []  # every launch is held, so that one run names each that drops a pair
    for name, (forces, energies) in runs.items():
        if energies is not None:
            got, want = energies("cuda"), energies("torch")
        else:
            got, want = (forces("cuda"),), (forces("torch"),)
        torch.cuda.synchronize()
        fk, fp = got[0][v], want[0][v]
        assert float(fp.norm(dim=-1).min()) > 1e-3, name
        ok = bool(((fk - fp).norm(dim=-1) <= 1e-3 * fp.norm(dim=-1)).all())
        for a, b in zip(got[1:], want[1:]):
            assert float(b[v].abs().min()) > 0, name
            ok = ok and bool(((a - b)[v].abs() <= 1e-2 * b[v].abs()).all())
        if not ok:
            failed.append(name)
    assert not failed, f"pairs dropped by {failed}"


def test_k3_with_nothing_parked_equals_k2a_and_reruns_bitwise(device):
    """K3's grid side with an all-empty aux table equals K2a bit for bit on
    the straggler fixture's grid (C_t two below the fullest cell, drifted
    0.45·skin); K2a, K2b (with and without energies) and K3 with the
    fixture's own table rerun bitwise; and the card reports the LJ pass's
    shared memory (its K2-G variants' too) as `cell_kernel.lj_smem_bytes`
    counts it, with at least the LJ_MIN_BLOCKS blocks an SM that its launch
    bounds ask for."""
    from emdee_tpu_torch.neighbors import straggler_kernel
    from emdee_tpu_torch.neighbors.cell_dense_straggler import _bindings, _hood_matrix

    sst, sconfig = _straggler_state(device)
    cfg = sconfig.grid
    vel = sst.grid.velocities
    grid = sst.grid._replace(positions=torch.where(
        sst.grid.valid[..., None], sst.grid.positions + (0.45 * 0.35 / float(vel.abs().max())) * vel, 0.0))
    args, _ = _empty_strag_operands(grid, cfg)
    out = torch.empty((3, cfg.num_cells, cfg.capacity), dtype=torch.float32, device=device)
    before = cell_kernel.LAUNCHES
    cell_kernel.launch_strag(*args[:7], args[8], out, cfg, (0.5, 2.0))
    assert cell_kernel.LAUNCHES == before + 1
    ref = cell_kernel.cell_forces_split(*args[:4], cfg, uniform_params=(0.5, 2.0), backend="cuda")
    for i in range(3):
        assert torch.equal(out[i].view(torch.int32), ref[i].view(torch.int32))

    av = sst.aux_cell < cfg.num_cells
    table, _ = _bindings(sst.aux_cell, av, sconfig, _hood_matrix(cfg.cells_per_dim, device))
    assert int((table >= 0).sum()) > 0
    p = grid.positions.permute(2, 0, 1).contiguous()
    a = sst.aux_positions.t().contiguous()
    strag = (p[0], p[1], p[2], grid.valid, a[0], a[1], a[2], sst.aux_cell, table, sconfig, (0.5, 2.0))
    model = LennardJonesModel.create(2.5, 2.0, device=device)
    calls = (lambda: straggler_kernel.straggler_forces(*strag, backend="cuda"),
             lambda: cell_kernel.cell_forces_split(*args[:4], cfg, uniform_params=(0.5, 2.0), backend="cuda"),
             lambda: cell_kernel.cell_forces(grid, model, cfg, backend="cuda"),
             lambda: cell_kernel.cell_forces(grid, model, cfg, compute_energy=True, backend="cuda"))
    for call in calls:
        x, y = call(), call()
        assert all(torch.equal(s.view(torch.int32), t.view(torch.int32)) for s, t in zip(x, y) if s is not None)
    for flags in ((True, False, False), (False, True, False), (False, False, False), (True, False, True),
                  *((u, e, False, True) for u in (True, False) for e in (False, True))):
        res = cell_kernel.lj_resources(*flags)
        assert res["registers"] > 0 and res["warps_per_block"] == cell_kernel.LJ_WARPS
        assert res["smem_bytes"] == cell_kernel.lj_smem_bytes()
        assert res["blocks_per_sm"] >= cell_kernel.LJ_MIN_BLOCKS, (flags, res)


def test_streaming_molecular_water_rollout_matches_plain_and_reruns_bitwise(device):
    """The 1,536-atom water box on 'cuda_streaming' (K5c, bonds on the
    tags) against 'torch' after 20 steps within 2e-3 / 5e-2 and against
    'cuda' (K2c); two rollouts bitwise equal; two K5c launches a force
    evaluation."""
    from emdee_tpu_torch import gather_dense_atoms
    from emdee_tpu_torch.tools import water

    box, config, model, coul, params = water.water_setup(device, n_side=8, spill=False)
    st = cell_dense_init(box["positions"], box["velocities"], box["masses"], params, config,
                         charges=box["charges"], device=device)
    roll_s, energy_s = water.molecular_sim(box, config, model, coul, params, "cuda_streaming", device)
    roll_k, _ = water.molecular_sim(box, config, model, coul, params, "cuda", device)
    roll_p, energy_p = water.molecular_sim(box, config, model, coul, params, "torch", device)
    before = streaming_kernel.LAUNCHES
    a = roll_s(st, num_steps=20, rebin_every=5)
    assert streaming_kernel.LAUNCHES == before + 2 * 22
    b = roll_s(st, num_steps=20, rebin_every=5)
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)
    n = len(box["masses"])
    pa, va = gather_dense_atoms(a, n)
    for other in (roll_p(st, num_steps=20, rebin_every=5), roll_k(st, num_steps=20, rebin_every=5)):
        assert not bool(a.overflow) and not bool(other.overflow)
        po, vo = gather_dense_atoms(other, n)
        assert np.abs(pa - po).max() < 2e-3 and np.abs(va - vo).max() < 5e-2
    pe_s, pe_p = float(energy_s(st)[0]), float(energy_p(st)[0])
    assert abs(pe_s - pe_p) <= 1e-5 * abs(pe_p) + 1e-2


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2)])
@pytest.mark.parametrize("capacity", [24, 80, 88, 200])
def test_ghost_mol_kernel_equals_k2c_and_matches_plain(device, capacity, shape):
    """K2c-G (`cell_mol_kernel` with GHOST, DSF and the tags) on the grid's
    charged fixture at C = 24, 80, 88, 200 (one to seven warps a cell, C =
    200 in one stage of the 256-slot tile), drifted across cell faces and
    the seam: forces, energies and virials bit for bit the one-card K2c-q's
    (no bond tags), and within 2e-4 of the force scale and 1e-3 of the
    plain ghost pass; one launch a call; the variants keep no local
    bytes."""
    from emdee_tpu_torch import make_exclusion_aux_fn
    from emdee_tpu_torch.distributed import grid_sharded as gs
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh

    st, config, model = fixtures.grid_charged_state(device, capacity)
    assert not bool(st.overflow)
    v = st.velocities
    st = st._replace(positions=torch.where(st.valid[..., None], st.positions + (0.45 * 0.3 / float(v.abs().max())) * v, 0.0))
    kw = fixtures.grid_charged_kwargs(device)
    tags = make_exclusion_aux_fn(config.num_atoms, *kw["excl_tables"])(st)
    mesh = make_grid_mesh(shape, device=device)
    sh = gs.distribute_grid(st, config, mesh)
    roll_k, _ = gs.make_grid_sharded_sim(config, model, 0.002, mesh, backend="cuda", **kw)
    roll_p, _ = gs.make_grid_sharded_sim(config, model, 0.002, mesh, backend="torch", **kw)
    before = cell_kernel.LAUNCHES
    got = roll_k.forces(sh, compute_energy=True)
    assert cell_kernel.LAUNCHES == before + 1
    whole = lambda f, e, w: gs.gather_grid_state(sh._replace(positions=f, half_sigma=e, twice_sqrt_eps=w), config, mesh)  # noqa: E731
    k, p = whole(*got), whole(*roll_p.forces(sh, compute_energy=True))
    ref = cell_kernel.cell_forces(st, model, config, compute_energy=True, backend="cuda", coulomb=kw["coulomb"],
                                  excl=tags)
    for a, b in zip((k.positions, k.half_sigma, k.twice_sqrt_eps), ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    v = st.valid
    scale = max(float(p.positions[v].abs().max()), 1.0)
    assert float((k.positions[v] - p.positions[v]).abs().max()) <= 2e-4 * scale
    assert float((k.half_sigma[v] - p.half_sigma[v]).abs().max()) <= 1e-3
    for energy in (False, True):
        res = cell_kernel.k2c_resources(config, kw["coulomb"], tags[:3], energy, ghost=True)
        assert res["registers"] > 0 and res["local_bytes"] == 0 and res["blocks_per_sm"] >= 1, res


def test_grid_molecular_rollout_reruns_bitwise(device):
    """The triatomic fixture (DSF, tags, bonds and angles as term rows,
    leftover pairs) on the grid with K2c-G and K6: (1,1,1) and (2,2,2)
    rerun bitwise and end bitwise equal to each other, within 2e-4 of the
    plain versions' run; one K2c-G launch a force evaluation, three K6 a
    rebin."""
    from emdee_tpu_torch.distributed import grid_sharded as gs
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors import rebin_window_kernel as k6

    st, config, model = fixtures.triatomic_state(device)
    kw = fixtures.triatomic_grid_kwargs(device)
    outs = {}
    for shape in ((1, 1, 1), (2, 2, 2)):
        mesh = make_grid_mesh(shape, device=device)
        sh = gs.distribute_grid(st, config, mesh)
        roll, _ = gs.make_grid_sharded_sim(config, model, 1e-3, mesh, **kw)
        k2, k6_before = cell_kernel.LAUNCHES, k6.LAUNCHES
        out = roll(sh, num_steps=20, rebin_every=5)
        assert (cell_kernel.LAUNCHES - k2, k6.LAUNCHES - k6_before) == (22, 12)
        again = roll(sh, num_steps=20, rebin_every=5)
        assert all(torch.equal(a, b) for a, b in zip(out, again) if isinstance(a, torch.Tensor))
        assert not bool(out.overflow)
        outs[shape] = gs.gather_grid_state(out, config, mesh)
        if shape == (2, 2, 2):
            roll_p, _ = gs.make_grid_sharded_sim(config, model, 1e-3, mesh, backend="torch", **kw)
            plain = gs.gather_grid_state(roll_p(sh, num_steps=20, rebin_every=5), config, mesh)
            assert torch.equal(plain.atom_id, outs[shape].atom_id)
            assert float((plain.positions - outs[shape].positions).abs().max()) <= 2e-4
    a, b = outs[(1, 1, 1)], outs[(2, 2, 2)]
    assert all(torch.equal(x, y) for x, y in zip(a, b) if isinstance(x, torch.Tensor))


def _ghost_stack(sh, mesh, uniform=False, coulomb=False, excl=False):
    """A grid-sharded state's ghost grids as the grid engine builds them:
    x, y, z (NaN in empty slots), [σ/2, 2√ε], [q], [atom ids as float32 bits]."""
    from emdee_tpu_torch.distributed.grid_sharded import _ghost3

    parts = [torch.where(sh.valid, sh.positions.movedim(-1, 0), float("nan"))]
    if not uniform:
        parts += [sh.half_sigma[None], sh.twice_sqrt_eps[None]]
    if coulomb:
        parts.append(sh.charges[None])
    if excl:
        parts.append(torch.where(sh.valid, sh.atom_id, -2).view(torch.float32)[None])
    return _ghost3(torch.cat(parts), mesh)


def _k5s_vs_plain(sh, mesh, config, model, one_card, gate, e_gate, w_gate, rtol, **kw):
    """K5s vs its plain version before the fold (interior forces, the
    reaction ghost grid, energies within e_gate + rtol·|E| and virials
    within w_gate + rtol·|W|), then after the fold vs the one-card forces
    `one_card` (M³, C, 3); empty slots exactly 0; reruns bitwise; two
    launches a call."""
    from emdee_tpu_torch.distributed.grid_sharded import _fold3, gather_grid_state

    gh = _ghost_stack(sh, mesh, kw.get("uniform_params") is not None, kw.get("coulomb") is not None,
                      kw.get("excl") is not None)
    args = (gh, mesh.local_shape, mesh.base, config, model)
    for energy in (False, True):
        before = streaming_kernel.LAUNCHES
        k = streaming_kernel.streaming_ghost_forces(*args, compute_energy=energy, backend="cuda", **kw)
        again = streaming_kernel.streaming_ghost_forces(*args, compute_energy=energy, backend="cuda", **kw)
        p = streaming_kernel.streaming_ghost_forces(*args, compute_energy=energy, backend="torch", **kw)
        torch.cuda.synchronize()
        assert streaming_kernel.LAUNCHES == before + 4
        assert all(torch.equal(a, b) for a, b in zip(k, again) if a is not None)
        valid = sh.valid
        live_ghost = ~torch.isnan(gh[0])
        scale = max(float(p[0].movedim(0, -1)[valid].abs().max()), 1.0)
        assert float((k[0] - p[0]).movedim(0, -1)[valid].abs().max()) <= gate * scale
        assert float((k[1][:3] - p[1][:3]).abs().max()) <= gate * scale
        assert not bool(k[0].movedim(0, -1)[~valid].any()) and not bool(k[1].movedim(0, -1)[~live_ghost].any())
        if energy:
            for a, b, atol in ((k[2][valid], p[2][valid], e_gate), (k[3][valid], p[3][valid], w_gate),
                               (k[1][3], p[1][3], e_gate), (k[1][4], p[1][4], w_gate)):
                np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=rtol, atol=atol)
        back = _fold3(k[1], mesh)
        f = gather_grid_state(sh._replace(positions=(k[0] + back[:3]).movedim(0, -1)), config, mesh).positions
        v1 = gather_grid_state(sh, config, mesh).valid
        assert float((f - one_card)[v1].abs().max()) <= gate * scale


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("geometry,shape", [((6, 24), (2, 2, 2)), ((5, 40), (1, 1, 1)), ((4, 88), (2, 2, 2)),
                                            ((4, 104), (2, 2, 2)), ((4, 200), (2, 2, 2))])
def test_streaming_ghost_kernel_matches_plain(device, uniform, geometry, shape):
    """K5s (K5's warp-owned kernel in its GHOST mode) with one, two and
    three centre slots a lane (C = 24, 40, 88) and its chunked variant (C =
    104, one chunk a cell; the crowded box's C = 200, cells of 196 atoms in
    three chunks), drifted across cell faces and the seam: against its plain
    version within 2e-5 of the force scale, energies and virials at the
    one-card K5 test's gates (1e-4 and 2e-3, rtol 1e-4), and after the fold
    against the one-card K5; reruns bitwise; the card reports no local
    (spill) bytes for the variant, with and without energies."""
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh

    m, c = geometry
    if c == 200:
        st, config, model, _, _ = _crowded(device, c, m=m)
    else:
        st, config, model = _state(device, varied=not uniform, drift=True,
                                   geometry={"cells_per_dim": m, "capacity": c})
    assert not bool(st.overflow)
    uni = (0.5, 2.0) if uniform else None
    one = streaming_kernel.cell_forces_streaming(st, model, config, backend="cuda", uniform_params=uni)[0]
    mesh = make_grid_mesh(shape, device=device)
    _k5s_vs_plain(distribute_grid(st, config, mesh), mesh, config, model, one, 2e-5, 1e-4, 2e-3, 1e-4,
                  uniform_params=uni)
    for energy in (False, True):
        res = streaming_kernel.k5_resources(config, uniform, energy, ghost=True)
        assert res["registers"] > 0 and res["blocks_per_sm"] >= 1 and res["local_bytes"] == 0, res


@pytest.mark.parametrize("capacity", [None, 40, 88])
@pytest.mark.parametrize("variant", ["coulomb", "tags", "coulomb_tags"])
def test_streaming_ghost_molecular_kernel_matches_plain(device, variant, capacity):
    """K5s-mol (DSF and the exclusion tags, no bond tags) on the charged
    fixture over (2,2,2), C = 24, 40, 88: against its plain version within
    2e-4 of the force scale and 1e-3 in energies and virials, and after the
    fold against the one-card K5c."""
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh

    st, config, model, coul, tags = fixtures.charged_fixture(device, capacity)
    c = coul if "coulomb" in variant else None
    excl = None if variant == "coulomb" else tags[:3]
    one = streaming_kernel.cell_forces_streaming(st, model, config, backend="cuda", coulomb=c, excl=excl)[0]
    mesh = make_grid_mesh((2, 2, 2), device=device)
    sh = distribute_grid(st, config, mesh)
    shard = lambda t: None if t is None else distribute_grid(st._replace(positions=t), config, mesh).positions  # noqa: E731
    ghost_tags = None if excl is None else tuple(shard(t) for t in excl)
    _k5s_vs_plain(sh, mesh, config, model, one, 2e-4, 1e-3, 1e-3, 0.0, coulomb=c, excl=ghost_tags)


def _grid_charged_m8(device, capacity):
    """The grid's charged fixture (2,048 atoms, box 28.3) on M = 8 cells at
    capacity C, drifted 0.45·skin along the velocities: (state, config, LJ
    model, DSF model, slot tags), so that (2,4,1) has two cell layers a
    shard."""
    from emdee_tpu_torch import make_exclusion_aux_fn

    a = fixtures.grid_charged_arrays()
    config = fixtures.grid_charged_config(a)._replace(cells_per_dim=8, capacity=capacity)
    st = cell_dense_init(a["pos"], a["vel"], np.ones(a["n"]), lennard_jones_atom(np.ones(a["n"]), np.ones(a["n"]),
                         device=device), config, charges=a["q"], device=device)
    assert not bool(st.overflow)
    v = st.velocities
    st = st._replace(positions=torch.where(
        st.valid[..., None], st.positions + (0.45 * fixtures.CHARGED_SKIN / float(v.abs().max())) * v, 0.0))
    kw = fixtures.grid_charged_kwargs(device)
    tags = make_exclusion_aux_fn(a["n"], *kw["excl_tables"])(st)
    return st, config, LennardJonesModel.create(fixtures.CUTOFF, fixtures.SWITCH, device=device), kw["coulomb"], tags


@pytest.mark.parametrize("capacity", [24, 40, 88])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 4, 1)])
def test_k5s_mol_matches_plain_on_every_mesh_shape(device, shape, capacity):
    """K5s-mol (warp-owned cells with the cull on the ghost grids) with DSF
    and the tags over (1,1,1) (the 864-atom charged fixture) and (2,4,1)
    (the grid's charged fixture at M = 8; the (2,2,2) cases are above), C =
    24, 40, 88: against its plain version within 2e-4 of the force scale and
    1e-3 in energies and virials, reruns bitwise, after the fold against
    the one-card K5c."""
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh

    if shape == (1, 1, 1):
        st, config, model, coul, tags = fixtures.charged_fixture(device, capacity)
    else:
        st, config, model, coul, tags = _grid_charged_m8(device, capacity)
    one = streaming_kernel.cell_forces_streaming(st, model, config, backend="cuda", coulomb=coul, excl=tags[:3])[0]
    mesh = make_grid_mesh(shape, device=device)
    sh = distribute_grid(st, config, mesh)
    shard = lambda t: distribute_grid(st._replace(positions=t), config, mesh).positions  # noqa: E731
    _k5s_vs_plain(sh, mesh, config, model, one, 2e-4, 1e-3, 1e-3, 0.0, coulomb=coul,
                  excl=tuple(shard(t) for t in tags[:3]))
    res = streaming_kernel.k5s_mol_resources(config, coul, tags[:3], True)
    assert res["registers"] > 0 and res["blocks_per_sm"] >= 1


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 4, 1)])
@pytest.mark.parametrize("capacity", [24, 88])
@pytest.mark.parametrize("kernel", ["K5s-mol", "K2c-G"])
def test_k5s_mol_cull_keeps_pairs_just_inside_the_cutoff(device, kernel, capacity, shape):
    """K5s-mol's cull (and K2c-G's: the warp's centre box against each of
    the 27 ghost neighbours) drops no pair inside the cutoff (`_CULL_PAIRS`
    tiled into a 24³ box of 8³ cells: a face, an edge and a corner offset,
    the periodic seam, an overhang, and on these meshes shard faces, some of
    them seams) on the ghost grids.
    The grid keeps its bonds as term rows, so each pair is held by its DSF
    Coulomb alone (its LJ excluded by the tags): at r = rc − 0.02…0.03 the
    shifted force is small, and each atom's force is held within 1e-3 of its
    own magnitude, before the fold against the plain ghost pass and after
    it against the one-card plain forces (K2c-G has no fold: its forces are
    the totals); a dropped pair misses by all of it."""
    from emdee_tpu_torch import make_exclusion_aux_fn
    from emdee_tpu_torch.distributed.grid_sharded import _fold3, distribute_grid, gather_grid_state
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh

    st, config, model, coul, _, tabs = _cull_pairs_state(device, capacity, bonded=False, copies=2)
    n = config.num_atoms
    one = streaming_kernel.cell_forces_streaming(st, model, config, backend="torch", coulomb=coul,
                                                 excl=make_exclusion_aux_fn(n, *tabs)(st)[:3])[0]
    v1 = st.valid
    assert float(one[v1].norm(dim=-1).min()) > 1e-4  # every atom feels its partner
    mesh = make_grid_mesh(shape, device=device)
    sh = distribute_grid(st, config, mesh)
    gh = _ghost_stack(sh, mesh, coulomb=True, excl=True)
    kw = dict(coulomb=coul, excl=make_exclusion_aux_fn(n, *tabs)(sh)[:3])
    args = (gh, mesh.local_shape, mesh.base, config, model)
    fn = cell_kernel.ghost_forces if kernel == "K2c-G" else streaming_kernel.streaming_ghost_forces
    for energy in (False, True):
        k = fn(*args, compute_energy=energy, backend="cuda", **kw)
        p = fn(*args, compute_energy=energy, backend="torch", **kw)
        torch.cuda.synchronize()
        v = sh.valid
        fk, fp = k[0].movedim(0, -1)[v], p[0].movedim(0, -1)[v]
        assert bool(((fk - fp).norm(dim=-1) <= 1e-3 * fp.norm(dim=-1) + 1e-7).all())
        total = k[0]
        if kernel == "K5s-mol":
            live = ~torch.isnan(gh[0])
            rk, rp = k[1][:3].movedim(0, -1)[live], p[1][:3].movedim(0, -1)[live]
            assert bool(((rk - rp).norm(dim=-1) <= 1e-3 * rp.norm(dim=-1) + 1e-7).all())
            total = k[0] + _fold3(k[1], mesh)[:3]
        if energy:
            for a, b in zip(k[-2:], p[-2:]):
                assert float((a - b)[v].abs().max()) <= 1e-3
        f = gather_grid_state(sh._replace(positions=total.movedim(0, -1)), config, mesh).positions[v1]
        assert bool(((f - one[v1]).norm(dim=-1) <= 1e-3 * one[v1].norm(dim=-1)).all())


def test_streaming_ghost_geometry_refusals_and_cpu(device, monkeypatch):
    """K5s refuses what its C entries would, before any launch, and nothing
    else: its block is K5's whatever the shards' rows, so a (1,1,1) shard
    row of 60 cells at C = 96 with energies (which the pencil's shared
    memory refused past 49) launches, and the pass writes exact zeros on an
    empty row; C = 1025 is refused, and so is a C whose one warp's chunks
    and rows pass Hopper's 232,448 B a block (C = 2,600 with the capacity
    limit lifted); K5s-mol takes the same row with eight tags; 'cuda' on
    CPU tensors and the 'cuda_streaming' family on a CPU mesh raise, with
    no fallback."""
    from emdee_tpu_torch.distributed import grid_sharded as gs
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh

    st, config, model = _state(device)
    row = config._replace(cells_per_dim=60, capacity=96)
    streaming_kernel._check_geometry(row, True)
    streaming_kernel._check_geometry(row, True, True, 8)
    gh = torch.full((5, 1, 1, 1, 3, 3, 62, 96), float("nan"), device=device)  # one shard row, mz = my = 1
    gh[3:] = 1.0
    f, react, e, w = streaming_kernel.streaming_ghost_forces(gh, (1, 1, 1), (0, 0, 0), row, model,
                                                             compute_energy=True, backend="cuda")
    torch.cuda.synchronize()
    assert not any(bool(t.any()) for t in (f, react, e, w))
    del gh
    with pytest.raises(ValueError, match="C ≤ 1024"):
        streaming_kernel._check_geometry(config._replace(capacity=1025), False)
    assert (streaming_kernel.smem_bytes(config._replace(capacity=1024), True) <= 232_448
            < streaming_kernel.smem_bytes(config._replace(capacity=2600), True))
    monkeypatch.setattr(streaming_kernel, "MAX_CAPACITY", 4096)
    streaming_kernel._check_geometry(config._replace(capacity=1024), True)
    with pytest.raises(ValueError, match="shared memory"):
        streaming_kernel._check_geometry(config._replace(capacity=2600), True)
    monkeypatch.undo()
    wide = config._replace(capacity=1025)
    gh = torch.full((5, 1, 1, 1, 5, 5, 5, 1025), float("nan"), device=device)
    with pytest.raises(ValueError, match="C ≤ 1024"):
        streaming_kernel.streaming_ghost_forces(gh, (1, 1, 1), (0, 0, 0), wide, model, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        streaming_kernel.streaming_ghost_forces(gh.cpu(), (1, 1, 1), (0, 0, 0), wide, model, backend="cuda")
    for backend in ("cuda_streaming", "pallas_streaming"):
        with pytest.raises(ValueError, match="CUDA"):
            gs.make_grid_sharded_sim(config, model, 0.002, make_grid_mesh((1, 1, 1), device="cpu"), backend=backend)


def test_streaming_grid_rollout_matches_plain_and_reruns_bitwise(device):
    """The grid on 'cuda_streaming' (K5s + the fold, K6): (1,1,1) and
    (2,2,2) rerun bitwise, within 2e-5 of 'torch_streaming' and of K2-G
    after 12 steps; two K5s launches a force evaluation, three K6 a rebin.
    Decompositions agree to roundoff (the fold's order), not bit for bit."""
    from emdee_tpu_torch.distributed import grid_sharded as gs
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors import rebin_window_kernel as k6

    st, config, model = _state(device, varied=False, geometry={"cells_per_dim": 4, "capacity": 56})
    uni = (0.5, 2.0)
    outs = {}
    for shape in ((1, 1, 1), (2, 2, 2)):
        mesh = make_grid_mesh(shape, device=device)
        sh = gs.distribute_grid(st, config, mesh)
        roll, _ = gs.make_grid_sharded_sim(config, model, 0.002, mesh, uniform_params=uni, backend="cuda_streaming")
        assert roll.family == "cuda_streaming"
        k5, k6_before = streaming_kernel.LAUNCHES, k6.LAUNCHES
        out = roll(sh, num_steps=12, rebin_every=3)
        assert (streaming_kernel.LAUNCHES - k5, k6.LAUNCHES - k6_before) == (28, 12)
        again = roll(sh, num_steps=12, rebin_every=3)
        assert all(torch.equal(a, b) for a, b in zip(out, again) if isinstance(a, torch.Tensor))
        assert not bool(out.overflow)
        outs[shape] = gs.gather_grid_state(out, config, mesh)
        for backend in ("torch_streaming", "cuda"):
            other, _ = gs.make_grid_sharded_sim(config, model, 0.002, mesh, uniform_params=uni, backend=backend)
            ref = gs.gather_grid_state(other(sh, num_steps=12, rebin_every=3), config, mesh)
            assert torch.equal(ref.atom_id, outs[shape].atom_id)
            assert float((ref.positions - outs[shape].positions).abs().max()) <= 2e-5
    a, b = outs[(1, 1, 1)], outs[(2, 2, 2)]
    assert torch.equal(a.atom_id, b.atom_id) and float((a.positions - b.positions).abs().max()) <= 2e-5
