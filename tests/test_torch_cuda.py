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
from emdee_tpu_torch.neighbors import cell_kernel, rebin_kernel
from emdee_tpu_torch.neighbors.cell_dense import _rebin_shift
from emdee_tpu_torch.utils.lattice import cubic_lattice, maxwell_boltzmann

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _state(device, n=2048, varied=True, drift=False):
    pos, box = cubic_lattice(n, 0.6, jitter=0.15, seed=11)
    rng = np.random.default_rng(11)
    eps, sig = (rng.uniform(0.8, 1.2, n), rng.uniform(0.9, 1.1, n)) if varied else (np.ones(n), np.ones(n))
    config = suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.35)
    st = cell_dense_init(pos, maxwell_boltzmann(n, 1.3, seed=12), np.ones(n),
                         lennard_jones_atom(eps, sig), config, device=device)
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
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert not bool(a.overflow) and torch.equal(a.atom_id, p.atom_id)
    assert float((a.positions - p.positions).abs().max()) < 2e-5
    pe, _, ke = energy(a)
    assert torch.isfinite(pe) and torch.isfinite(ke)
