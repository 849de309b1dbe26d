"""The PyTorch port's leaf modules against the JAX package: lattices,
LJ parameters and pair terms, PBC helpers, config suggestion — and a static
check that the port never imports JAX or the JAX package."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.core import pbc as jpbc
from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.potentials import lennard_jones as jlj
from emdee_tpu.utils import lattice as jlat
from emdee_tpu_torch.core import pbc as tpbc
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.potentials import lennard_jones as tlj
from emdee_tpu_torch.utils import lattice as tlat

torch.set_num_threads(2)

PORT = Path(__file__).resolve().parent.parent / "emdee_tpu_torch"


def test_lattices_byte_identical():
    for args in ((1000, 0.65, 0.2, 11), (2048, 0.6, 0.0, 3)):
        a, la = jlat.cubic_lattice(*args)
        b, lb = tlat.cubic_lattice(*args)
        assert a.tobytes() == b.tobytes() and la == lb
    a, la = jlat.fcc_lattice(7, 0.8442)
    b, lb = tlat.fcc_lattice(7, 0.8442)
    assert a.tobytes() == b.tobytes() and la == lb
    masses = np.linspace(1.0, 3.0, 500)
    for kw in ({}, {"masses": masses, "zero_momentum": False}):
        a = jlat.maxwell_boltzmann(500, 1.44, seed=7, **kw)
        b = tlat.maxwell_boltzmann(500, 1.44, seed=7, **kw)
        assert a.tobytes() == b.tobytes()


def test_lennard_jones_params_bitexact():
    rng = np.random.default_rng(5)
    eps, sig = rng.uniform(0.1, 3.0, 4000), rng.uniform(0.5, 2.0, 4000)
    a = jlj.lennard_jones_atom(eps, sig)
    b = tlj.lennard_jones_atom(eps, sig, device="cpu")
    np.testing.assert_array_equal(b.half_sigma.numpy(), np.asarray(a.half_sigma))
    np.testing.assert_array_equal(b.twice_sqrt_eps.numpy(), np.asarray(a.twice_sqrt_eps))
    ma, mb = jlj.LennardJonesModel.create(2.5, 2.0), tlj.LennardJonesModel.create(2.5, 2.0, device="cpu")
    for name in ("rc2", "rs2", "inv_delta2"):
        assert float(getattr(ma, name)) == float(getattr(mb, name))


@pytest.mark.parametrize("parity_mode", [False, True])
def test_pair_energy_matches(parity_mode):
    """`pair_energy` (`pair_interaction` on `LJParams` tuples): bit for bit
    the port's `pair_interaction`, and JAX's `pair_energy` at the
    tolerance `pair_interaction` is held to."""
    rng = np.random.default_rng(10)
    k = 5000
    r2 = rng.uniform(0.7, 12.0, k).astype(np.float32)
    eps, sig = rng.uniform(0.5, 2.0, (2, 2, k))
    jp = [jlj.lennard_jones_atom(eps[i], sig[i]) for i in range(2)]
    tp = [tlj.lennard_jones_atom(eps[i], sig[i], device="cpu") for i in range(2)]
    tm = tlj.LennardJonesModel.create(2.5, 2.0, device="cpu")
    got = tlj.pair_energy(torch.from_numpy(r2), tm, tp[0], tp[1], parity_mode=parity_mode)
    same = tlj.pair_interaction(torch.from_numpy(r2), tm, *tp[0], *tp[1], parity_mode=parity_mode)
    ref = jlj.pair_energy(jnp.asarray(r2), jlj.LennardJonesModel.create(2.5, 2.0), jp[0], jp[1], parity_mode=parity_mode)
    for g, s, a in zip(got, same, ref):
        assert torch.equal(g.view(torch.int32), s.view(torch.int32))
        a = np.asarray(a)
        np.testing.assert_allclose(g.numpy(), a, rtol=1e-6, atol=1e-6 * np.abs(a).max())


@pytest.mark.parametrize("parity_mode", [False, True])
def test_pair_interaction_matches(parity_mode):
    """Pair energy and −r·dE/dr over r from the core to beyond the cutoff
    (where the two cutoff modes differ): rtol 1e-6, with an absolute floor
    of 1e-6 of the largest term for values that cross zero."""
    rng = np.random.default_rng(9)
    k = 20000
    r2 = rng.uniform(0.7, 12.0, k).astype(np.float32)
    hs_i, hs_j = rng.uniform(0.4, 0.6, (2, k)).astype(np.float32)
    tse_i, tse_j = rng.uniform(1.5, 2.5, (2, k)).astype(np.float32)
    ref = jlj.pair_interaction(
        jnp.asarray(r2), jlj.LennardJonesModel.create(2.5, 2.0),
        jnp.asarray(hs_i), jnp.asarray(tse_i), jnp.asarray(hs_j), jnp.asarray(tse_j),
        parity_mode=parity_mode,
    )
    got = tlj.pair_interaction(
        torch.from_numpy(r2), tlj.LennardJonesModel.create(2.5, 2.0, device="cpu"),
        torch.from_numpy(hs_i), torch.from_numpy(tse_i),
        torch.from_numpy(hs_j), torch.from_numpy(tse_j),
        parity_mode=parity_mode,
    )
    for a, b in zip(ref, got):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-6 * np.abs(a).max())
    beyond = r2 > 6.25
    assert beyond.any()
    # True-cutoff mode is exactly zero beyond rc; parity mode is not.
    assert (np.asarray(got[0].numpy())[beyond] == 0).all() != parity_mode


def test_pbc_helpers_bitexact():
    s = np.random.default_rng(4).uniform(-3.0, 3.0, 10000).astype(np.float32)
    s[:4] = [0.5, -0.5, 1.5, -2.5]  # halves round to even on both sides
    t = torch.from_numpy(s)
    np.testing.assert_array_equal(tpbc.minimum_image(t).numpy(), np.asarray(jpbc.minimum_image(jnp.asarray(s))))
    np.testing.assert_array_equal(tpbc.wrap_scaled(t).numpy(), np.asarray(jpbc.wrap_scaled(jnp.asarray(s))))


def test_config_suggestions_equal():
    for n, box, skin in ((97556, 48.37, 0.35), (864, 12.0, 0.3), (1000, 11.54, 0.35), (20000, 30.0, 0.4)):
        assert tcd.suggest_cell_dense_config(n, box, 2.5, 2.0, skin) == jcd.suggest_cell_dense_config(
            n, box, 2.5, 2.0, skin
        )
    for temp in (0.72, 1.44, 3.0):
        assert tcd.suggest_rebin_interval(0.35, 0.005, temp) == jcd.suggest_rebin_interval(0.35, 0.005, temp)
    uni = jlj.lennard_jones_atom(np.ones(10), np.ones(10))
    var = jlj.lennard_jones_atom(np.ones(10), np.linspace(1.0, 1.1, 10))
    for p in (uni, var):
        assert tcd.detect_uniform_params(tcd.lj_params_from_numpy(p, "cpu")) == jcd.detect_uniform_params(p)
    with pytest.raises(ValueError):
        tcd.suggest_cell_dense_config(100, 5.0, 2.5, 2.0)
    # Spill configs (ported): the same geometry as the reference's.
    for margin in (0.15, 0.3):
        assert tcd.suggest_cell_dense_config(864, 12.0, 2.5, 2.0, 0.3, spill=True, spill_margin=margin) == (
            jcd.suggest_cell_dense_config(864, 12.0, 2.5, 2.0, 0.3, spill=True, spill_margin=margin)
        )


def test_entry_points_default_to_the_card():
    """With no device named, the entry points build on the CUDA card; with
    no card they raise rather than return CPU tensors."""
    from emdee_tpu_torch.distributed import cell_dense_sharded as tcs
    from emdee_tpu_torch.distributed import domain as tdom
    from emdee_tpu_torch.distributed.mesh import make_mesh
    from emdee_tpu_torch.neighbors import cell_dense_straggler as tsd

    pos, box = tlat.cubic_lattice(864, 0.5, jitter=0.1, seed=1)
    vel = tlat.maxwell_boltzmann(864, 1.0, seed=2)
    config = tcd.suggest_cell_dense_config(864, box, 2.5, 2.0, 0.3)
    sconfig = tsd.StragglerConfig(config._replace(capacity=config.capacity - 4), config.capacity + 8, 64, 32)
    params = tlj.lennard_jones_atom(np.ones(864), np.ones(864), device="cpu")
    calls = [
        lambda: tlj.lennard_jones_atom(np.ones(864), np.ones(864)).half_sigma,
        lambda: tlj.LennardJonesModel.create(2.5, 2.0).rc2,
        lambda: tcd.cell_dense_init(pos, vel, np.ones(864), params, config).positions,
        lambda: tsd.straggler_init(pos, vel, np.ones(864), params, sconfig).aux_positions,
        lambda: make_mesh(2).axis_index(0),
        lambda: tdom.distribute(pos, vel, np.ones(864), params, tdom.suggest_domain_config(864, box, 2.5, 1),
                                make_mesh()).positions,
        lambda: tcs.distribute_cell_dense(tcd.cell_dense_init(pos, vel, np.ones(864), params, config, device="cpu"),
                                          make_mesh()).positions,
    ]
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_port_imports_no_jax():
    """No line of the port imports JAX or the JAX package (the GPU machine
    has no JAX); comments may still name counterpart files."""
    pattern = re.compile(r"^\s*(from|import)\s+(jax|emdee_tpu)\b")
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 10
    offenders = [
        f"{f.relative_to(PORT)}:{i}"
        for f in files
        for i, line in enumerate(f.read_text().splitlines(), 1)
        if pattern.match(line)
    ]
    assert not offenders, offenders
    smoke = PORT.parent / "chip_smoke.py"
    assert not [line for line in smoke.read_text().splitlines() if pattern.match(line)]


def test_static_box_is_made_once_per_device():
    """A static box reaches the kernels by pointer, like a dynamic one: the
    number becomes one cached 0-d float32 tensor per device (no launch per
    force call), holding the same bits as a fresh tensor of it; a box of
    another dtype or shape is refused."""
    like = torch.zeros(3)
    box = 17.123456789
    a, b = tcd._box(box, like), tcd._box(box, like)
    assert a is b and tcd.box_ptr(box, like) == a.data_ptr()
    assert a.dtype == torch.float32 and a.dim() == 0
    assert a.view(torch.int32) == torch.tensor(box, dtype=torch.float32).view(torch.int32)
    dyn = torch.full((), box, dtype=torch.float32)
    assert tcd._box(dyn, like) is dyn and tcd.box_ptr(dyn, like) == dyn.data_ptr()
    for bad in (torch.full((), box, dtype=torch.float64), torch.full((1,), box)):
        with pytest.raises(ValueError, match="box"):
            tcd.box_ptr(bad, like)
