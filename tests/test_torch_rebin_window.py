"""The grid's routing pass (K6) on CPU tensors — where it runs its plain
version — against the TPU kernel `rebin_window_pass_pallas` in interpret
mode: the former entry over pre-built windows (`rebin_window_pass`, the
halo kernel's witness) on windows from a drifted state, for all three
axes, and, on a one-shard grid, three window passes against the whole-grid
routing's plain version (K4's); the halo entry (`rebin_halo_plain`) on
(2,2,2) and (2,4,1) shards, its halo planes exchanged by `LocalMesh`,
against the TPU kernel on windows of the whole periodic grid: bit-exact in
every slot and the flag."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.neighbors.pallas_rebin import rebin_window_pass_pallas
from emdee_tpu_torch.neighbors import rebin_kernel, rebin_window_kernel
from emdee_tpu_torch.neighbors.cell_dense import _PASSES
from torch_port_utils import drifted_state
from test_torch_rebin_kernel import _routing_fields

torch.set_num_threads(2)

DRIFTED = drifted_state(1200, seed=11, varied=True)


def _stacked(fields):
    """(nf, M³, C) int32 from the routing fields (float32 viewed as int32)."""
    return torch.stack([torch.from_numpy(np.array(f)).view(torch.int32) for f in fields])


@pytest.mark.parametrize("axis,jump", [(0, False), (1, False), (2, False), (2, True)])
def test_window_pass_matches_pallas(axis, jump):
    st, config, _ = DRIFTED
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    x, wl, wr, b = rebin_window_kernel.periodic_windows(_stacked(_routing_fields(st, config, jump)), m, axis)
    cf = _PASSES[axis][2]
    got, ovf = rebin_window_kernel.rebin_window_pass(x, wl, wr, b, config.box, cf, m, c, ns)
    ref, ref_ovf = rebin_window_pass_pallas(
        jnp.asarray(x.numpy()), jnp.asarray(wl.numpy()), jnp.asarray(wr.numpy()), jnp.asarray(b.numpy()),
        config.box, cf, m, c, ns, planes=m, interpret=True,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert bool(ovf) == bool(ref_ovf) == jump
    moved = int((got[-1] != x[-1]).sum())
    assert moved > 10, f"fixture too static: only {moved} slots changed"


def test_window_passes_match_whole_grid_routing():
    st, config, _ = DRIFTED
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    fields = _routing_fields(st, config)
    x = _stacked(fields)
    flag = torch.zeros((), dtype=torch.bool)
    for axis, _, cf in _PASSES:
        args = rebin_window_kernel.periodic_windows(x, m, axis)
        out, ovf = rebin_window_kernel.rebin_window_pass(*args, config.box, cf, m, c, ns, backend="torch")
        x, flag = out.reshape(x.shape), flag | ovf
    ref, ref_ovf = rebin_kernel.rebin_routing(tuple(torch.from_numpy(np.array(f)) for f in fields), config.box, m, c, ns)
    for i, r in enumerate(ref):
        np.testing.assert_array_equal(x[i].numpy(), r.view(torch.int32).numpy(), err_msg=f"field {i}")
    assert bool(flag) == bool(ref_ovf) is False


def _sharded(a, shape, m):
    """(k, M³, C) → (k, sz, sy, sx, mz, my, mx, C), as `distribute_grid`
    lays out the shards of a (sz, sy, sx) mesh."""
    k, _, c = a.shape
    (sz, sy, sx), (mz, my, mx) = shape, (m // shape[0], m // shape[1], m // shape[2])
    return a.reshape(k, sz, mz, sy, my, sx, mx, c).permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous()


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 4, 1)])
def test_halo_pass_plain_matches_pallas_on_shards(shape):
    """K6's halo mode as the grid's rebin runs it — each shard's own rows
    and the two halo planes `LocalMesh.shift` brings, the first pass on the
    raw fields (strided position and velocity views, per-atom parameters,
    atom id), parked and wrapped by the pass — through its plain version,
    against the TPU kernel in interpret mode on windows built from the
    whole periodic grid (rolled one cell down and up the pass axis, then
    sharded): every slot and the flag, bit for bit, pass after pass, on
    the drifted per-atom lattice at M = 8, C = 24."""
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid
    from emdee_tpu_torch.distributed.mesh import LocalMesh
    from emdee_tpu_torch.neighbors.cell_dense import _roll_cells

    st, config = _halo_fixture()
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    mesh = LocalMesh(shape, "cpu")
    local = tuple(m // s for s in shape)
    sh = distribute_grid(st, config, mesh)
    pos3, vel3 = sh.positions.movedim(-1, 0), sh.velocities.movedim(-1, 0)
    x = ([pos3[i] for i in range(3)] + [vel3[i] for i in range(3)]
         + [sh.inv_masses, sh.half_sigma, sh.twice_sqrt_eps, torch.where(sh.valid, sh.atom_id, ns)])
    # The reference's input of the first pass: the one-card fields parked
    # and wrapped, as the grid engine parks them.
    box = torch.full((), config.box, dtype=torch.float32)
    pos = torch.where(st.valid[..., None], st.positions - torch.floor(st.positions / box) * box,
                      torch.full((), rebin_kernel.SENTINEL_BITS, dtype=torch.int32).view(torch.float32))
    whole = torch.stack([pos[..., i].view(torch.int32) for i in range(3)]
                        + [st.velocities[..., i].view(torch.int32) for i in range(3)]
                        + [f.view(torch.int32) for f in (st.inv_masses, st.half_sigma, st.twice_sqrt_eps)]
                        + [torch.where(st.valid, st.atom_id, ns)])
    flat = (whole.shape[0], -1, local[1] * local[2], c)
    start = x[-1]
    for axis, off, cf in _PASSES:
        lo, hi = rebin_window_kernel.halo_planes(x, mesh, axis)
        b = rebin_window_kernel.global_coords(mesh, local, axis)
        got, ovf = rebin_window_kernel.rebin_halo_plain(x, lo, hi, b, config.box, axis, m, c, ns, raw=axis == 0)
        cells = whole.transpose(0, 1)
        nbr = lambda d: _sharded(_roll_cells(cells, tuple(d * o for o in off), m).transpose(0, 1), shape, m)  # noqa: E731
        ref, ref_ovf = rebin_window_pass_pallas(
            jnp.asarray(_sharded(whole, shape, m).reshape(flat).numpy()), jnp.asarray(nbr(-1).reshape(flat).numpy()),
            jnp.asarray(nbr(+1).reshape(flat).numpy()), jnp.asarray(b.numpy()), config.box, cf, m, c, ns,
            planes=b.shape[0], interpret=True,
        )
        np.testing.assert_array_equal(got.reshape(flat).numpy(), np.asarray(ref), err_msg=f"axis {axis}")
        assert bool(ovf) == bool(ref_ovf) is False
        x = got
        # The next pass's whole grid: this pass's output gathered back.
        whole = got.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(whole.shape)
    moved = int((x[-1] != start).sum())
    assert moved > 100, moved


def _halo_fixture():
    """2,048 atoms on a jittered lattice at ρ = 0.6 with per-atom σ and ε,
    binned at M = 8, C = 24 and drifted 0.45·skin along the velocities."""
    from emdee_tpu_torch.neighbors import cell_dense as tcd
    from emdee_tpu_torch.potentials.lennard_jones import lennard_jones_atom
    from emdee_tpu_torch.utils.lattice import cubic_lattice, maxwell_boltzmann

    n = 2048
    pos, box = cubic_lattice(n, 0.6, jitter=0.15, seed=11)
    rng = np.random.default_rng(11)
    config = tcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.35)
    config = config._replace(cells_per_dim=8, capacity=24)
    st = tcd.cell_dense_init(pos, maxwell_boltzmann(n, 1.3, seed=12), np.ones(n),
                             lennard_jones_atom(rng.uniform(0.8, 1.2, n), rng.uniform(0.9, 1.1, n), device="cpu"),
                             config, device="cpu")
    assert not bool(st.overflow)
    v = st.velocities
    pos = torch.where(st.valid[..., None], st.positions + (0.45 * 0.35 / float(v.abs().max())) * v, 0.0)
    return st._replace(positions=pos), config
