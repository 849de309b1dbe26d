"""The streaming force pass (K5, `streaming_kernel.cell_forces_streaming` and
`cell_forces_streaming_split`) on CPU tensors — where the wrappers run the
plain version — against the TPU streaming kernel in interpret mode, on
tests/test_pallas_kernel.py's 864-atom setup at that file's tolerances; and
the engine's backend resolution against the TPU engine's VMEM estimate and
13 MB threshold, at the 864, 97,556 and 1,000,188-atom configs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.neighbors.pallas_cell_kernel import (
    pallas_cell_forces_streaming,
    pallas_cell_forces_streaming_split,
)
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.neighbors import cell_kernel, streaming_kernel
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel
from torch_port_utils import lj_setup, to_port

torch.set_num_threads(2)

TMODEL = LennardJonesModel.create(2.5, 2.0, device="cpu")
UNI = (0.5, 2.0)


def _state():
    pos, vel, params, config, model = lj_setup(864, 0.5, seed=3)
    return jcd.cell_dense_init(pos, vel, np.ones(len(pos)), params, config), config, model


ST, CONFIG, MODEL = _state()
VALID = np.asarray(ST.valid)


def _assert_forces_close(f, f_ref):
    scale = np.abs(f_ref[VALID]).max()
    np.testing.assert_allclose(f[VALID], f_ref[VALID], atol=2e-5 * max(scale, 1.0))
    assert (f[~VALID] == 0).all()


def test_streaming_matches_pallas_streaming():
    """The stacked entry with energies against `pallas_cell_forces_streaming`."""
    ref = pallas_cell_forces_streaming(ST, MODEL, CONFIG, compute_energy=True, interpret=True)
    f, e, w = streaming_kernel.cell_forces_streaming(to_port(ST), TMODEL, CONFIG, compute_energy=True)
    _assert_forces_close(f.numpy(), np.asarray(ref[0]))
    e, w = e.numpy(), w.numpy()
    np.testing.assert_allclose(e[VALID], np.asarray(ref[1])[VALID], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(w[VALID], np.asarray(ref[2])[VALID], rtol=1e-4, atol=2e-3)
    assert (e[~VALID] == 0).all() and (w[~VALID] == 0).all()


def test_streaming_split_matches_pallas_streaming_split():
    """The split entry, with an explicit box, against
    `pallas_cell_forces_streaming_split`."""
    px, py, pz = (ST.positions[..., i] for i in range(3))
    ref = pallas_cell_forces_streaming_split(
        px, py, pz, ST.valid, CONFIG, uniform_params=UNI, interpret=True, box=jnp.float32(CONFIG.box),
    )
    t = to_port(ST)
    comps = [t.positions[..., i].contiguous() for i in range(3)]
    got = streaming_kernel.cell_forces_streaming_split(*comps, t.valid, CONFIG, uniform_params=UNI, box=CONFIG.box)
    _assert_forces_close(torch.stack(got, -1).numpy(), np.stack([np.asarray(a) for a in ref], -1))


@pytest.mark.parametrize("compute_energy", [False, True])
def test_streaming_uniform_equals_per_atom(compute_energy):
    """For one LJ type the uniform entries equal the per-atom one, and the
    streaming entries equal the resident ones (both run the plain half
    shell on the CPU, launching nothing)."""
    t = to_port(ST)
    before = (streaming_kernel.LAUNCHES, cell_kernel.LAUNCHES)
    per_atom = streaming_kernel.cell_forces_streaming(t, TMODEL, CONFIG, compute_energy=compute_energy)
    uniform = streaming_kernel.cell_forces_streaming(
        t, TMODEL, CONFIG, compute_energy=compute_energy, uniform_params=UNI,
    )
    resident = cell_kernel.cell_forces(t, TMODEL, CONFIG, compute_energy=compute_energy)
    comps = [t.positions[..., i].contiguous() for i in range(3)]
    split = streaming_kernel.cell_forces_streaming_split(*comps, t.valid, CONFIG, uniform_params=UNI)
    for a, b, r in zip(per_atom, uniform, resident):
        if a is None:
            assert b is None and r is None and not compute_energy
        else:
            assert torch.equal(a, b) and torch.equal(a, r)
    assert torch.equal(torch.stack(split, -1), per_atom[0])
    assert (streaming_kernel.LAUNCHES, cell_kernel.LAUNCHES) == before


def _config(n, density=0.8442, skin=0.35):
    """The melt's config at n atoms (FCC box) from both packages."""
    box = (n / density) ** (1.0 / 3.0)
    return (jcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=skin),
            tcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=skin))


@pytest.mark.parametrize("n", [864, 97_556, 1_000_188])
@pytest.mark.parametrize("coulomb,excl", [(False, False), (True, False), (True, True)])
def test_backend_resolution_follows_vmem_estimate(n, coulomb, excl):
    jconfig, config = _config(n)
    assert tuple(config) == tuple(jconfig)
    est = jcd.estimate_kernel_vmem_bytes(jconfig)
    assert tcd.estimate_kernel_vmem_bytes(config) == est
    est = est * 7 // 5 if coulomb else est
    est = est * 6 // 5 if excl else est
    want = "cuda_streaming" if est > 13_000_000 else "cuda"
    kw = {"with_coulomb": coulomb, "with_excl": excl}
    assert tcd.resolve_dense_backend(config, "auto", device="cuda", **kw) == want
    assert tcd.resolve_dense_backend(config, "auto", device="cpu", **kw) == "torch"
    assert tcd.resolve_dense_backend(config, "torch", device="cuda", **kw) == "torch"


def test_backend_resolution_at_the_melts():
    """bench_all.py's 1M melt resolves to the streaming family (M = 37,
    C = 32, as the TPU engine suggests), the 97,556-atom melt to the
    resident one."""
    _, config = _config(1_000_188)
    assert (config.cells_per_dim, config.capacity) == (37, 32)
    assert tcd.resolve_dense_backend(config, device="cuda") == "cuda_streaming"
    assert tcd.resolve_dense_backend(config, device=torch.device("cuda", 0)) == "cuda_streaming"
    assert tcd.resolve_dense_backend(_config(97_556)[1], device="cuda") == "cuda"
    with pytest.raises(ValueError, match="unknown backend"):
        tcd.resolve_dense_backend(config, "pallas_streaming", device="cuda")


# The 864-atom setup (M = 4, ~14 atoms a cell) at C = 104, a capacity the
# kernels take as two 96-entry chunks a cell and the TPU kernel as it is.
def _state_c104():
    pos, vel, params, config, model = lj_setup(864, 0.5, seed=3)
    config = config._replace(capacity=104)
    return jcd.cell_dense_init(pos, vel, np.ones(len(pos)), params, config), config, model


def test_streaming_matches_pallas_streaming_at_c104():
    """F1: at C = 104, above the three centre slots a lane, the port's
    streaming pass (its plain version, as on the CPU; the kernel there runs
    its chunked variant) against `pallas_cell_forces_streaming` in
    interpret mode, which has no capacity limit, with energies, at this
    file's tolerances; and the split entry against the split TPU entry."""
    st, config, model = _state_c104()
    valid = np.asarray(st.valid)
    ref = pallas_cell_forces_streaming(st, model, config, compute_energy=True, interpret=True)
    f, e, w = streaming_kernel.cell_forces_streaming(to_port(st), TMODEL, config, compute_energy=True)
    f_ref = np.asarray(ref[0])
    scale = np.abs(f_ref[valid]).max()
    np.testing.assert_allclose(f.numpy()[valid], f_ref[valid], atol=2e-5 * max(scale, 1.0))
    assert (f.numpy()[~valid] == 0).all()
    np.testing.assert_allclose(e.numpy()[valid], np.asarray(ref[1])[valid], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(w.numpy()[valid], np.asarray(ref[2])[valid], rtol=1e-4, atol=2e-3)
    px, py, pz = (st.positions[..., i] for i in range(3))
    ref_s = pallas_cell_forces_streaming_split(px, py, pz, st.valid, config, uniform_params=UNI, interpret=True)
    t = to_port(st)
    comps = [t.positions[..., i].contiguous() for i in range(3)]
    got = streaming_kernel.cell_forces_streaming_split(*comps, t.valid, config, uniform_params=UNI)
    f_s, f_ref_s = torch.stack(got, -1).numpy(), np.stack([np.asarray(a) for a in ref_s], -1)
    np.testing.assert_allclose(f_s[valid], f_ref_s[valid], atol=2e-5 * max(np.abs(f_ref_s[valid]).max(), 1.0))


@pytest.mark.parametrize("energy", [False, True])
def test_streaming_family_takes_m12_c104(energy):
    """F1: the geometry checks of the streaming family take M = 12, C = 104
    — K5 (uniform and per-atom parameters) and K5c (the water tags, E = E_b
    = 2) on one card, K5s (K5's block) and K5s-mol (E = 2) on the grid's
    shards — with the chunked blocks' shared memory as the C entries count
    it: two 96-entry chunks a cell, four warps a block."""
    config = CONFIG._replace(cells_per_dim=12, capacity=104)
    nr = 5 if energy else 3
    for uniform, fields in ((True, 4), (False, 6)):
        assert streaming_kernel._k5_block(104, energy, uniform) == (4 * 4 * (6 * fields * 96 + 2 * nr * 104), 4)
        assert streaming_kernel.smem_bytes(config, energy, uniform=uniform) == 4 * 4 * (6 * fields * 96
                                                                                        + 2 * nr * 104)
    streaming_kernel._check_geometry(config, energy)
    streaming_kernel._check_geometry(config, energy, True, 2, 2)
    assert streaming_kernel.smem_bytes(config, energy, True, 2, 2) == 4 * 4 * (6 * 8 * 96 + 3 * 4 * 96
                                                                               + 2 * nr * 104)
    streaming_kernel._check_geometry(config, energy, True, 2)
    assert streaming_kernel.smem_bytes(config, energy, True, 2) == 4 * 4 * (6 * 8 * 96 + 3 * 2 * 96 + 2 * nr * 104)


def test_m12_c104_resolves_to_the_streaming_family():
    """F1's worked config: the LJ melt's M = 12, C = 104 has the TPU
    engine's VMEM estimate 13,310,336 B, past the 13 MB threshold, so
    'auto' on the card resolves to 'cuda_streaming' (as the reference's to
    its streaming kernel), which now takes it."""
    config = CONFIG._replace(cells_per_dim=12, capacity=104)
    est = tcd.estimate_kernel_vmem_bytes(config)
    assert est == jcd.estimate_kernel_vmem_bytes(config) == 13_310_336
    assert tcd.resolve_dense_backend(config, "auto", device="cuda") == "cuda_streaming"
    assert tcd.resolve_dense_backend(config, "auto", device="cpu") == "torch"
    streaming_kernel._check_geometry(config, False)


def test_cuda_streaming_raises_on_cpu_tensors():
    t = to_port(ST)
    with pytest.raises(ValueError, match="CUDA"):
        streaming_kernel.cell_forces_streaming(t, TMODEL, CONFIG, backend="cuda")
    comps = [t.positions[..., i].contiguous() for i in range(3)]
    with pytest.raises(ValueError, match="CUDA"):
        streaming_kernel.cell_forces_streaming_split(*comps, t.valid, CONFIG, uniform_params=UNI, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tcd.resolve_dense_backend(CONFIG, "cuda_streaming", device="cpu")
    for kw in ({}, {"uniform_params": UNI, "uniform_mass": 1.0}):
        rollout, energy = tcd.make_cell_dense_sim(CONFIG, TMODEL, dt=0.004, backend="cuda_streaming", **kw)
        with pytest.raises(ValueError, match="CUDA"):
            rollout(t, num_steps=2, rebin_every=2)
        with pytest.raises(ValueError, match="CUDA"):
            energy(t)


def test_streaming_kernel_refuses_geometry_it_cannot_take():
    """K5's entries refuse C > 1024 (the resident family's limit) and M < 3
    (a cell would meet itself through the seam); at every C up to 1024 a
    block holds at least one warp's chunks and rows (two at C = 1024 with
    per-atom parameters and energies), and the warp-owned block does not
    grow with M, so the 1M melt, M = 300 and C = 1024 pass."""
    with pytest.raises(ValueError, match="C ≤ 1024"):
        streaming_kernel._check_geometry(CONFIG._replace(capacity=1025), energy=False)
    with pytest.raises(ValueError, match="M ≥ 3"):
        streaming_kernel._check_geometry(CONFIG._replace(cells_per_dim=2), energy=True)
    streaming_kernel._check_geometry(_config(1_000_188)[1], energy=True)
    streaming_kernel._check_geometry(CONFIG._replace(cells_per_dim=300, capacity=96), energy=True)
    streaming_kernel._check_geometry(CONFIG._replace(capacity=1024), energy=True)
    assert streaming_kernel._k5_block(1024, True, False) == (2 * 4 * (24 * 6 * 96 + 2 * 5 * 1024), 2)
