"""The port's DSF Coulomb (`emdee_tpu_torch.potentials.coulomb`) against the
JAX package's and against float64, on the cases of tests/test_coulomb.py:
28-44 (tolerance 2e-6 absolute against float64, as there)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.potentials import coulomb as jc
from emdee_tpu_torch.potentials import coulomb as tc

torch.set_num_threads(2)


def _dsf_f64(r, rc, alpha, qq):
    g = lambda x: math.erfc(alpha * x) / x**2 + (2 * alpha / math.sqrt(math.pi)) * math.exp(  # noqa: E731
        -((alpha * x) ** 2)) / x
    if r >= rc:
        return 0.0, 0.0
    e = qq * (math.erfc(alpha * r) / r - math.erfc(alpha * rc) / rc + g(rc) * (r - rc))
    return e, qq * r * (g(r) - g(rc))


def test_constants_match_jax():
    """`DSFCoulomb.create` equals JAX's bit for bit, and a JAX model crosses
    to the port unchanged (`coulomb_from_numpy`)."""
    for args in ((3.0, 0.3, 1.0), (7.0, 0.2, tc.KJMOL_ANGSTROM), (2.5, 0.25, 1.0)):
        j = jax.device_get(jc.DSFCoulomb.create(*args))
        t = tc.DSFCoulomb.create(*args, device="cpu")
        for a, b in zip(j, t):
            assert np.asarray(a, np.float32).view(np.int32) == b.numpy().view(np.int32)
        assert tc.coulomb_consts(tc.coulomb_from_numpy(j, "cpu")) == jc.coulomb_consts(jc.DSFCoulomb.create(*args))
    assert (tc.KJMOL_NM, tc.KJMOL_ANGSTROM) == (jc.KJMOL_NM, jc.KJMOL_ANGSTROM)


@pytest.mark.parametrize("r", [0.5, 1.0, 2.0, 2.9, 3.0, 4.0])
def test_dsf_matches_f64_and_jax(r):
    jm = jc.DSFCoulomb.create(3.0, alpha=0.3, coulomb_constant=1.0)
    tm = tc.DSFCoulomb.create(3.0, alpha=0.3, coulomb_constant=1.0, device="cpu")
    r2 = np.float32(r * r)
    e, mre = tc.coulomb_interaction(torch.tensor(r2), tm, 0.8, -0.4)
    e64, mre64 = _dsf_f64(r, 3.0, 0.3, 0.8 * -0.4)
    assert float(e) == pytest.approx(e64, abs=2e-6)
    assert float(mre) == pytest.approx(mre64, abs=2e-6)
    ej, mrej = jc.coulomb_interaction(jnp.float32(r2), jm, 0.8, -0.4)
    assert float(e) == pytest.approx(float(ej), rel=1e-6, abs=1e-7)
    assert float(mre) == pytest.approx(float(mrej), rel=1e-6, abs=1e-7)


def test_dsf_smooth_and_zero_at_cutoff():
    """Energy and force vanish smoothly at rc and are exactly 0 beyond it;
    elementwise on a sweep, port and JAX agree at float32 roundoff."""
    tm = tc.DSFCoulomb.create(3.0, alpha=0.25, device="cpu")
    eps = 1e-3
    e_lo, f_lo = tc.coulomb_interaction(torch.tensor((3.0 - eps) ** 2, dtype=torch.float32), tm, 1.0, 1.0)
    assert abs(float(e_lo)) < 1e-3 and abs(float(f_lo)) < 5e-3
    e_hi, f_hi = tc.coulomb_interaction(torch.tensor([9.0, 9.5, 100.0]), tm, 1.0, 1.0)
    assert (e_hi == 0).all() and (f_hi == 0).all()
    r2 = np.linspace(0.04, 10.0, 997).astype(np.float32)
    q = np.random.default_rng(3).uniform(-1, 1, (2, r2.size)).astype(np.float32)
    et, ft = tc.coulomb_interaction(torch.from_numpy(r2), tm, torch.from_numpy(q[0]), torch.from_numpy(q[1]))
    ej, fj = jc.coulomb_interaction(jnp.asarray(r2), jc.DSFCoulomb.create(3.0, alpha=0.25), q[0], q[1])
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=2e-6, atol=2e-6)
