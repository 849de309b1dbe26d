"""The sort rebin (`cell_dense._rebin`): its kernel (`sort_rebin_kernel.py`,
`csrc/sort_rebin.cu`) and its plain version.

On the CPU: the kernel wrapper's refusals, and the dispatch — CPU tensors,
or backend 'torch', run the plain torch ops (held against a numpy
transcription of the stable-argsort rebin, bit for bit) and launch nothing.
Marked `gpu` (skipping without a CUDA device, decided in a fixture): the
kernel against the plain version bit for bit in every slot and the flag,
over displacements of up to two cells across the periodic seam, forces and
charges, an empty and an exactly full cell, a scaled (NPT) box, cells over
C (which keep the argsort's first C atoms), at C = 32 and C = 72; a 1,000-step NVE rollout of the
97,556-atom melt on the sort rebin against the same rollout with the plain
rebin, bit for bit; and a water box on the sort rebin with backend 'auto'
against its plain path.  Run on the card with
`python -m pytest tests/test_torch_sort_rebin.py -m gpu -q`.  This file
imports no JAX."""

import numpy as np
import pytest
import torch

from emdee_tpu_torch import cell_dense_init, lennard_jones_atom, make_cell_dense_sim, suggest_cell_dense_config
from emdee_tpu_torch.neighbors import cell_dense, sort_rebin_kernel
from emdee_tpu_torch.neighbors.cell_dense import _rebin
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel
from emdee_tpu_torch.utils.lattice import cubic_lattice, maxwell_boltzmann

N = 2048
FULL, EMPTY = 7, 8  # the cells that "empty+full" fills to C and empties
SEAM_CASES = ("drift2", "drift2+forces", "drift2+charges", "drift2+forces+charges", "empty+full", "npt+forces")


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _base(device, capacity):
    """A 2,048-atom jittered lattice (M = 5) at capacity `capacity`, with
    per-atom masses and LJ parameters, so that every field differs slot to
    slot."""
    pos, box = cubic_lattice(N, 0.6, jitter=0.15, seed=11)
    rng = np.random.default_rng(11)
    eps, sig, mass = rng.uniform(0.8, 1.2, N), rng.uniform(0.9, 1.1, N), rng.uniform(0.5, 2.0, N)
    config = suggest_cell_dense_config(N, box, cutoff=2.5, switch=2.0, skin=0.35)._replace(capacity=capacity)
    st = cell_dense_init(pos, maxwell_boltzmann(N, 1.3, seed=12), mass,
                         lennard_jones_atom(eps, sig, device=device), config, device=device)
    assert not bool(st.overflow)
    return st, config


def _designed(st, config, counts, rng):
    """The live slots' positions replaced, in a random order, by atoms
    placed uniformly inside cells with `counts` atoms in each."""
    m, h = config.cells_per_dim, config.box / config.cells_per_dim
    cells = np.repeat(np.arange(m**3), counts)
    corner = np.stack([cells % m, (cells // m) % m, cells // (m * m)], axis=1)
    pos = ((corner + rng.uniform(0.001, 0.999, corner.shape)) * h).astype(np.float32)
    out = st.positions.clone()
    out[st.valid] = torch.from_numpy(pos[rng.permutation(len(pos))]).to(out.device)
    return st._replace(positions=out)


def _case(device, case, capacity):
    """(state, config, forces or None) of `case` at capacity `capacity`."""
    st, config = _base(device, capacity)
    rng = np.random.default_rng(5)
    m, h, box = config.cells_per_dim, config.box / config.cells_per_dim, np.float32(config.box)
    valid = st.valid.cpu().numpy()
    if case == "pileup":  # every atom in the first three cells along x
        counts = np.zeros(m**3, dtype=np.int64)
        share, extra = divmod(int(valid.sum()), 3)
        counts[:3] = share
        counts[:extra] += 1
        st = _designed(st, config, counts, rng)
    elif case.startswith("empty") or case == "overflow":
        counts = np.zeros(m**3, dtype=np.int64)
        counts[FULL] = capacity + (case == "overflow")
        rest = [k for k in range(m**3) if k not in (FULL, EMPTY)]
        share, extra = divmod(int(valid.sum()) - counts[FULL], len(rest))
        counts[rest] = share
        counts[rest[:extra]] += 1
        st = _designed(st, config, counts, rng)
    else:  # up to two cells each way on every axis, across the seam
        pos = st.positions.cpu().numpy()
        pos = pos + np.where(valid[..., None], rng.uniform(-2 * h, 2 * h, pos.shape), 0.0).astype(np.float32)
        live = np.argwhere(valid)
        tiny = np.float32(np.nextafter(np.float32(0), np.float32(1)))
        seam = [-tiny, -np.float32(1e-7), -np.spacing(box), np.float32(0), box, np.nextafter(box, np.float32(0)),
                box + np.spacing(box), np.float32(-0.0)]
        for i, x in enumerate(seam):
            cell, slot = live[5 * i]
            pos[cell, slot, i % 3] = x
        st = st._replace(positions=torch.from_numpy(pos).to(device))
    if case.startswith("npt"):
        scale = np.float32(0.97)
        st = st._replace(positions=st.positions * float(scale),
                         box=torch.full((), float(box * scale), dtype=torch.float32, device=device))
    if "charges" in case:
        q = torch.from_numpy(rng.uniform(-1, 1, valid.shape).astype(np.float32)).to(device)
        st = st._replace(charges=torch.where(st.valid, q, 0.0))
    forces = None
    if "forces" in case:
        forces = torch.from_numpy(rng.normal(size=st.positions.shape).astype(np.float32)).to(device)
    return st, config, forces


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b, rows=slice(None)):
    """Two rebins' (state, forces) bit for bit in every field, on `rows`."""
    sa, fa = (a, None) if isinstance(a, cell_dense.CellDenseState) else a
    sb, fb = (b, None) if isinstance(b, cell_dense.CellDenseState) else b
    for name in sa._fields:
        x, y = getattr(sa, name), getattr(sb, name)
        if x is None or y is None:
            assert x is None and y is None, name
            continue
        x, y = _bits(x), _bits(y)
        if x.dim() >= 2:
            x, y = x[rows], y[rows]
        assert torch.equal(x, y), name
    assert (fa is None) == (fb is None)
    if fa is not None:
        assert torch.equal(_bits(fa)[rows], _bits(fb)[rows]), "forces"


def _numpy_rebin(st, config, forces=None):
    """The stable-argsort rebin transcribed in numpy float32 (each
    operation rounded on its own, as the torch ops): {field: array}."""
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    nc = m**3
    box = np.float32(config.box if st.box is None else float(st.box))
    pos = st.positions.numpy().reshape(ns, 3)
    valid = st.valid.numpy().reshape(ns)
    q = pos / box
    t = np.clip(np.floor(np.float32(m) * (q - np.floor(q))).astype(np.int64), 0, m - 1)
    key = np.where(valid, t[:, 0] + m * (t[:, 1] + m * t[:, 2]), nc)
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=nc + 1)[:nc]
    starts = np.concatenate([[0], np.cumsum(counts)])
    rank = np.tile(np.arange(c), nc)
    new_valid = rank < np.repeat(counts, c)
    src = order[np.minimum(np.repeat(starts[:nc], c) + rank, ns - 1)]
    fields = {"velocities": st.velocities, "inv_masses": st.inv_masses, "half_sigma": st.half_sigma,
              "twice_sqrt_eps": st.twice_sqrt_eps, "charges": st.charges, "forces": forces}
    out = {}
    for name, f in fields.items():
        if f is not None:
            a = f.numpy().reshape(ns, -1)[src]
            out[name] = np.where(new_valid[:, None], a, np.float32(0)).reshape(f.shape)
    p = pos[src]
    p = np.where(new_valid[:, None], p - np.floor(p / box) * box, np.float32(0))
    out["positions"] = out["ref_positions"] = p.reshape(nc, c, 3)
    out["atom_id"] = np.where(new_valid, st.atom_id.numpy().reshape(ns)[src], ns).reshape(nc, c)
    out["valid"] = new_valid.reshape(nc, c)
    out["overflow"] = np.bool_(st.overflow.numpy() | (counts.max() > c))
    return out


def _no_kernel(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the sort rebin kernel was called")

    monkeypatch.setattr(sort_rebin_kernel, "sort_rebin", refuse)


# ---------------------------------------------------------------------------
# The CPU: refusals and dispatch
# ---------------------------------------------------------------------------


def _refused(case):
    """(state, config, forces) of the CPU fixture broken as `case` says."""
    st, config = _base(torch.device("cpu"), 32)
    nc, c = config.num_cells, config.capacity
    forces = None
    if case == "positions dtype":
        st = st._replace(positions=st.positions.double())
    elif case == "atom_id dtype":
        st = st._replace(atom_id=st.atom_id.long())
    elif case == "valid dtype":
        st = st._replace(valid=st.valid.to(torch.uint8))
    elif case == "shape":
        config = config._replace(capacity=c + 8)
    elif case == "capacity":
        config = config._replace(capacity=1032)
    elif case == "strides":
        st = st._replace(velocities=st.velocities.transpose(0, 1).contiguous().transpose(0, 1))
    elif case == "forces shape":
        forces = torch.zeros((nc, c), dtype=torch.float32)
    return st, config, forces


@pytest.mark.parametrize("case, match", [
    ("positions dtype", "positions: expected torch.float32"),
    ("atom_id dtype", "atom_id: expected torch.int32"),
    ("valid dtype", "valid: expected torch.bool"),
    ("shape", r"positions: expected torch.float32 \(125, 40, 3\)"),
    ("capacity", "capacity 1032"),
    ("strides", "velocities: strides"),
    ("forces shape", "forces: expected"),
    ("cpu", "needs tensors on a CUDA device"),
])
def test_sort_rebin_wrapper_refuses(case, match):
    """The wrapper refuses, before any launch, fields of another type,
    shape or layout, a capacity above F1's 1,024, and CPU tensors."""
    st, config, forces = _refused(case)
    before = sort_rebin_kernel.LAUNCHES
    with pytest.raises(ValueError, match=match):
        sort_rebin_kernel.sort_rebin(st, config, forces)
    assert sort_rebin_kernel.LAUNCHES == before


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("case", ["drift2+forces+charges", "npt+forces", "overflow", "pileup"])
def test_sort_rebin_on_cpu_is_the_plain_version(monkeypatch, backend, case):
    """CPU tensors with 'auto', and 'torch', reach the plain torch ops: the
    kernel is never called, its launch count stays 0, and every field and
    the flag equal a numpy transcription of the stable-argsort rebin bit
    for bit, overflowing cell included."""
    _no_kernel(monkeypatch)
    st, config, forces = _case(torch.device("cpu"), case, 32)
    before = sort_rebin_kernel.LAUNCHES
    out = _rebin(st, config, forces, backend)
    got, f = out if forces is not None else (out, None)
    assert sort_rebin_kernel.LAUNCHES == before
    want = _numpy_rebin(st, config, forces)
    assert bool(got.overflow) == bool(want["overflow"]) == (case in ("overflow", "pileup"))
    for name, a in want.items():
        x = f if name == "forces" else getattr(got, name)
        np.testing.assert_array_equal(_bits(x).numpy(), a.view(np.int32) if a.dtype == np.float32 else a, name)
    assert int(((got.atom_id != st.atom_id) & got.valid).sum()) > 50


def test_sort_rebin_backend_cuda_needs_the_card():
    st, config = _base(torch.device("cpu"), 32)
    with pytest.raises(ValueError, match="needs tensors on a CUDA device"):
        _rebin(st, config, backend="cuda")


def test_sort_rollout_on_cpu_launches_nothing(monkeypatch):
    """A sort-rebin rollout of the engine on the CPU ('auto') runs the
    plain rebin: the kernel is never called."""
    _no_kernel(monkeypatch)
    st, config = _base(torch.device("cpu"), 40)
    model = LennardJonesModel.create(2.5, 2.0, device="cpu")
    rollout, _ = make_cell_dense_sim(config, model, dt=0.005, rebin="sort")
    before = sort_rebin_kernel.LAUNCHES
    out = rollout(st, num_steps=4, rebin_every=2)
    assert sort_rebin_kernel.LAUNCHES == before and not bool(out.overflow)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("capacity", [32, 72])
@pytest.mark.parametrize("case", SEAM_CASES)
def test_sort_rebin_kernel_matches_plain(device, case, capacity):
    """One launch, bit for bit the plain rebin in every slot and the flag;
    every output field contiguous."""
    st, config, forces = _case(device, case, capacity)
    before = sort_rebin_kernel.LAUNCHES
    a = _rebin(st, config, forces, "cuda")
    b = _rebin(st, config, forces, "torch")
    assert sort_rebin_kernel.LAUNCHES == before + 1
    _same(a, b)
    sa = a[0] if forces is not None else a
    assert not bool(sa.overflow)
    assert all(t.is_contiguous() for t in (sa.positions, sa.velocities, sa.inv_masses, sa.half_sigma,
                                           sa.twice_sqrt_eps, sa.atom_id, sa.valid))
    assert int(((sa.atom_id != st.atom_id) & sa.valid).sum()) > 100
    if case.startswith("empty"):
        counts = sa.valid.sum(dim=1)
        assert int(counts[FULL]) == capacity and int(counts[EMPTY]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("capacity", [32, 72])
@pytest.mark.parametrize("case", ["overflow", "pileup"])
def test_sort_rebin_kernel_overflow_matches_plain(device, case, capacity):
    """Cells over C — one cell of C + 1 atoms, or every atom piled into
    three cells — raise the flag as the plain rebin does, and every slot
    still holds the plain rebin's bits: an overflowing cell keeps its first
    C atoms by source slot."""
    st, config, forces = _case(device, case, capacity)
    a = _rebin(st, config, forces, "cuda")
    b = _rebin(st, config, forces, "torch")
    assert bool(a.overflow) and bool(b.overflow)
    _same(a, b)
    assert int(a.valid.sum()) < int(st.valid.sum())


@pytest.mark.gpu
def test_sort_rebin_rollout_matches_plain_rebin_bitwise(device, monkeypatch):
    """1,000 NVE steps of the 97,556-atom melt on the sort rebin every 2
    ('auto': K2a and the sort rebin kernel) against the same rollout with
    the plain rebin (backend 'torch' for the rebin alone): bit for bit."""
    from emdee_tpu_torch.tools.melt import DT, melt

    st, config, model, _, uni, _ = melt(device)
    rollout, _ = make_cell_dense_sim(config, model, dt=DT, uniform_params=uni, uniform_mass=1.0, rebin="sort")
    before = sort_rebin_kernel.LAUNCHES
    a = rollout(st, num_steps=1000, rebin_every=2)
    torch.cuda.synchronize()
    assert sort_rebin_kernel.LAUNCHES == before + 500
    plain = cell_dense._rebin
    monkeypatch.setattr(cell_dense, "_rebin", lambda s, c, f=None, backend="auto": plain(s, c, f, "torch"))
    b = rollout(st, num_steps=1000, rebin_every=2)
    assert sort_rebin_kernel.LAUNCHES == before + 500
    assert not bool(a.overflow)
    _same(a, b)


@pytest.mark.gpu
def test_molecular_water_on_the_sort_rebin(device):
    """The 1,536-atom water box on rebin='sort' with backend 'auto' (the
    sort rebin kernel hands the molecular kernels contiguous fields) runs,
    reruns bitwise, and after 20 steps lies within 2e-3 / 5e-2 of its plain
    path ('torch')."""
    from emdee_tpu_torch import gather_dense_atoms
    from emdee_tpu_torch.neighbors.cell_dense_molecular import make_molecular_dense_sim
    from emdee_tpu_torch.tools import water

    box, config, model, coul, params = water.water_setup(device, n_side=8, spill=False)
    st = cell_dense_init(box["positions"], box["velocities"], box["masses"], params, config,
                         charges=box["charges"], device=device)
    n = len(box["masses"])
    roll_k, roll_p = (make_molecular_dense_sim(
        config, model, water.DT, n, params=params, charges=box["charges"], coulomb=coul,
        exclusion_pairs=box["exclusion_pairs"], exclusion_scales=box["exclusion_scales"],
        bonded=water.bonded_system(box, device), backend=backend, rebin="sort")[0] for backend in ("auto", "torch"))
    before = sort_rebin_kernel.LAUNCHES
    a = roll_k(st, num_steps=20, rebin_every=5)
    assert sort_rebin_kernel.LAUNCHES == before + 4
    b = roll_k(st, num_steps=20, rebin_every=5)
    p = roll_p(st, num_steps=20, rebin_every=5)
    _same(a, b)
    assert not bool(a.overflow) and not bool(p.overflow)
    (pa, va), (pp, vp) = gather_dense_atoms(a, n), gather_dense_atoms(p, n)
    assert np.abs(pa - pp).max() < 2e-3 and np.abs(va - vp).max() < 5e-2
