"""The port's all-pairs pass (`emdee_tpu_torch.neighbors.allpairs`) against
the JAX package's and the float64 oracle, on the CPU.

Both sides get the same numpy inputs (the oracle the float32-rounded
positions the engines see).  Port against JAX at the reference's force
tolerance (rtol 1e-4, atol 5e-4: tests/test_cell_dense.py:55-57); against
the float64 oracle at tests/test_allpairs.py's float32-vs-float64 mixture
tolerance (rtol 2e-4, atol 1e-3).  The reference's own `lj_sample` gate
falls back to uniform random positions when its fixture is not mounted
(ROADMAP fault R1: a pair at 0.07σ puts float32 rounding outside its
tolerance), so the gate here runs on a well-separated jittered lattice of
the same size and box, as tests/test_pallas_kernel.py:120 builds one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.core.types import ALL_OUTPUTS as J_ALL
from emdee_tpu.neighbors.allpairs import compute_nonbonded_allpairs as jax_allpairs
from emdee_tpu.potentials.lennard_jones import LennardJonesModel as JModel
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom as jlj
from emdee_tpu.utils.lattice import cubic_lattice
from emdee_tpu_torch.core.types import ALL_OUTPUTS, ENERGIES, FORCES, VIRIALS
from emdee_tpu_torch.neighbors.allpairs import compute_nonbonded_allpairs
from emdee_tpu_torch.neighbors.api import NonbondedConfig, make_force_fn
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel, lennard_jones_atom
from tests.oracle import allpairs_oracle, lj_interaction_f64
from tests.test_coulomb import _dsf_f64

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 5e-4


def _port(pos, box, rc, rs, eps, sigma, **kw):
    n = len(pos)
    return compute_nonbonded_allpairs(
        torch.from_numpy(np.asarray(pos, np.float32)), box, LennardJonesModel.create(rc, rs, device="cpu"),
        lennard_jones_atom(np.broadcast_to(eps, n), np.broadcast_to(sigma, n), device="cpu"), **kw)


def _jax(pos, box, rc, rs, eps, sigma, **kw):
    n = len(pos)
    return jax_allpairs(jnp.asarray(pos, jnp.float32), jnp.float32(box), JModel.create(rc, rs),
                        jlj(np.broadcast_to(eps, n), np.broadcast_to(sigma, n)), **kw)


def _close(got, want, rtol=RTOL, atol=ATOL):
    for name in ("forces", "energies", "virials"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def _lattice_sample():
    """800 atoms on a jittered lattice in the reference gate's box (L = 10,
    rc = 3, rs = 2.5, ε = σ = 1), rounded to float32: force scale ~55."""
    pos, box = cubic_lattice(800, 0.8, jitter=0.03, seed=20260816)
    return pos.astype(np.float32).astype(np.float64), box, 3.0, 2.5


@pytest.mark.parametrize("parity_mode", [True, False])
def test_allpairs_matches_jax_and_oracle(parity_mode):
    """The reference's differential gate (runtests.jl:19-42) in both cutoff
    semantics: the port, JAX and the float64 oracle agree."""
    pos, box, rc, rs = _lattice_sample()
    got = _port(pos, box, rc, rs, 1.0, 1.0, parity_mode=parity_mode)
    _close(got, _jax(pos, box, rc, rs, 1.0, 1.0, parity_mode=parity_mode))
    f, e, w = allpairs_oracle(pos, box, rc, rs, 0.5, 2.0, parity_mode=parity_mode)
    np.testing.assert_allclose(got.forces.numpy(), f, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(got.energies.numpy(), e, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(got.virials.numpy(), w, rtol=2e-4, atol=1e-3)


def test_output_bitmask_selection_and_row_chunks():
    """Only the outputs asked for; each equals its ALL_OUTPUTS value; the
    row-block size changes no bit."""
    pos, box, rc, rs = _lattice_sample()
    out_f = _port(pos, box, rc, rs, 1.0, 1.0, outputs=FORCES)
    assert out_f.forces is not None and out_f.energies is None and out_f.virials is None
    out_ev = _port(pos, box, rc, rs, 1.0, 1.0, outputs=ENERGIES | VIRIALS)
    assert out_ev.forces is None and out_ev.energies is not None and out_ev.virials is not None
    out_all = _port(pos, box, rc, rs, 1.0, 1.0, outputs=ALL_OUTPUTS)
    assert torch.equal(out_all.forces, out_f.forces) and torch.equal(out_all.energies, out_ev.energies)
    for chunk in (64, 300):
        other = _port(pos, box, rc, rs, 1.0, 1.0, row_chunk=chunk)
        for name in ("forces", "energies", "virials"):
            assert torch.equal(getattr(other, name), getattr(out_all, name)), (chunk, name)


def test_padding_mask():
    """Masked rows are inert: the padded system's real rows equal the
    unpadded system's, its pad rows are exactly 0, and both match JAX."""
    pos, box = cubic_lattice(100, 0.2, jitter=0.2, seed=1)
    n, n_pad = 100, 160
    pos_p = np.concatenate([pos, np.full((n_pad - n, 3), 1.234)])
    mask = np.arange(n_pad) < n
    out = _port(pos, box, 2.5, 2.0, 1.0, 1.0)
    out_p = _port(pos_p, box, 2.5, 2.0, 1.0, 1.0, mask=torch.from_numpy(mask))
    for name in ("forces", "energies", "virials"):
        got = getattr(out_p, name)
        np.testing.assert_allclose(got[:n].numpy(), getattr(out, name).numpy(), rtol=1e-5, atol=1e-5)
        assert (got[n:] == 0).all(), name
    _close(out_p, _jax(pos_p, box, 2.5, 2.0, 1.0, 1.0, mask=jnp.asarray(mask)))


def test_binary_mixture_mixing():
    """Per-atom parameters (Lorentz–Berthelot in σ/2, 2√ε) against JAX and
    the float64 oracle (tests/test_allpairs.py's mixture tolerances)."""
    n = 128
    pos, box = cubic_lattice(n, 0.4, jitter=0.05, seed=2)
    pos = pos.astype(np.float32).astype(np.float64)
    eps = np.where(np.arange(n) % 2 == 0, 1.0, 0.5)
    sigma = np.where(np.arange(n) % 2 == 0, 1.0, 1.3)
    got = _port(pos, box, 2.5, 2.0, eps, sigma)
    _close(got, _jax(pos, box, 2.5, 2.0, eps, sigma))
    f, e, w = allpairs_oracle(pos, box, 2.5, 2.0, 0.5 * sigma, 2.0 * np.sqrt(eps))
    np.testing.assert_allclose(got.forces.numpy(), f, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(got.energies.numpy(), e, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(got.virials.numpy(), w, rtol=2e-4, atol=1e-3)


def test_newton_third_law():
    """Total force vanishes on a jittered lattice (momentum conservation)."""
    rng = np.random.default_rng(3)
    side = 6
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = grid * 1.2 + rng.uniform(-0.1, 0.1, grid.shape)
    out = _port(pos, side * 1.2, 3.0, 2.5, 1.0, 1.0)
    np.testing.assert_allclose(out.forces.numpy().sum(axis=0), 0.0, atol=1e-3)


def test_dsf_charges_vs_bruteforce_and_jax():
    """LJ + DSF Coulomb through `make_force_fn(method='allpairs')` against
    tests/test_coulomb.py's float64 brute force (atol 2e-3) and the JAX
    package's all-pairs with charges."""
    from emdee_tpu.neighbors.api import NonbondedConfig as JConfig
    from emdee_tpu.neighbors.api import make_force_fn as jax_make_force_fn

    rng = np.random.default_rng(5)
    n = 64
    pos, box = cubic_lattice(n, 0.3, jitter=0.2, seed=5)
    q = rng.choice([0.5, -0.5], size=n)
    q -= q.mean()
    kw = dict(cutoff=2.5, switch=2.0, method="allpairs", coulomb_alpha=0.3, coulomb_constant=1.0)
    nb = make_force_fn(NonbondedConfig(**kw), lennard_jones_atom(np.ones(n), np.ones(n), device="cpu"), box, n,
                       charges=q, device="cpu")
    out = nb.compute(torch.from_numpy(pos.astype(np.float32)), ())
    e_tot, f_ref = 0.0, np.zeros((n, 3))
    for i in range(n):
        for j in range(i + 1, n):
            d = pos[i] - pos[j]
            d -= box * np.round(d / box)
            r2 = (d**2).sum()
            e, mre = lj_interaction_f64(r2, 2.5, 2.0, 0.5, 2.0, 0.5, 2.0) if r2 < 2.5**2 else (0.0, 0.0)
            ec, mrec = _dsf_f64(np.sqrt(r2), 2.5, 0.3, q[i] * q[j])
            e_tot += e + ec
            f = (mre + mrec) / r2 * d
            f_ref[i] += f
            f_ref[j] -= f
    assert float(out.energies.sum()) == pytest.approx(e_tot, abs=2e-3)
    np.testing.assert_allclose(out.forces.numpy(), f_ref, atol=2e-3)
    jnb = jax_make_force_fn(JConfig(**kw), jlj(np.ones(n), np.ones(n)), box, n, charges=q)
    _close(out, jnb.compute(jnp.asarray(pos, jnp.float32), (), outputs=J_ALL))
