"""The TPU probes' plain versions (`emdee_tpu_torch.tools.probes`) on the
CPU: P1 against a numpy oracle, bit for bit, and P2 against the reference
probe's own kernel bodies (`_std3`, `_dgt3` of tools/perf_probe_cen_layout.py)
run through `pl.pallas_call` in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from emdee_tpu_torch.tools import probes
from tools.perf_probe_cen_layout import _dgt3, _std3


def _fma_oracle(ghost, centers, m, c, k_ops, tiles):
    a, b = np.float32(probes.FMA_A), np.float32(probes.FMA_B)
    g, mc = m + 2, m * c
    out = np.zeros_like(centers)
    for i in range(m * m):
        cz, cy = divmod(i, m)
        acc = np.zeros((c, mc), np.float32)
        for t in range(tiles):
            row = (cz + t % 3) * g + (cy + (t // 3) % 3)
            x = centers[i] - ghost[row, (t % 3) * c : (t % 3) * c + mc][None, :]
            for _ in range(k_ops):
                x = x * a + b
            acc = acc + x
        out[i] = acc
    return out


@pytest.mark.parametrize("k_ops", [0, 5, 15])
def test_probe_fma_plain_matches_numpy(k_ops):
    m, c = 4, 8
    ghost, centers = probes.probe_fma_inputs(m, c, "cpu", seed=3)
    ghost = ghost + torch.from_numpy(np.random.default_rng(4).random(ghost.shape, dtype=np.float32))
    got = probes.probe_fma(ghost, centers, m, c, k_ops, backend="auto").numpy()
    want = _fma_oracle(ghost.numpy(), centers.numpy(), m, c, k_ops, probes.TILES)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    lanes, ops, _ = probes.fma_counts(m, c, k_ops)
    assert lanes == m * m * probes.TILES * c * m * c and ops == lanes * (2 * k_ops + 2)


def _reference_cen(cen, expand):
    progs, d1, d2 = cen.shape
    transposed = d1 == probes.M
    nc, ncol = (d2 if transposed else d1), expand.shape[1]
    call = pl.pallas_call(
        _dgt3 if transposed else _std3,
        grid=(progs,),
        in_specs=[pl.BlockSpec((1, d1, d2), lambda i: (i, 0, 0)),
                  pl.BlockSpec(expand.shape, lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, nc, ncol), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((progs, nc, ncol), jnp.float32),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(cen), jnp.asarray(expand)))


@pytest.mark.parametrize("transposed", [False, True])
def test_probe_cen_plain_matches_reference_kernels(transposed):
    cen, expand = probes.probe_cen_inputs(transposed, "cpu", progs=3, seed=5)
    got = probes.probe_cen(cen, expand, transposed, backend="torch").numpy()
    want = _reference_cen(cen.numpy(), expand.numpy())
    assert got.shape == (3, probes.NC, probes.M * probes.C)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
