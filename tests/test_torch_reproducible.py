"""Bitwise reruns of the dry run's part 4 (`emdee_tpu_torch.distributed.dryrun`:
the grid engine with DSF charges (±0.2) and exclusion tags on every (2i,
2i+1) pair, a random start, 2 steps, rebinning every 2) on the CPU: four
gloo ranks of a (2, 2, 1) `DistMesh` against the `LocalMesh` run in this
process, and the `LocalMesh` run against itself at one thread, at the
default thread count and under `torch.use_deterministic_algorithms`.

And the cause of ROADMAP fault F2, which made that `LocalMesh` run differ
now and then: the DSF pass's erfc and exp (`potentials/coulomb.py`
`coulomb_interaction`), made as a process's first call of MKL's vector
math by several threads at once, computed a thread's chunk at another
accuracy in about one process in eight (`core/vml.py`).  Fresh processes
make that first call on a 2^20-element tile at 8 threads; each must give
this process's bits."""

import functools
import multiprocessing

import numpy as np
import pytest
import torch

from emdee_tpu_torch import LennardJonesModel, cell_dense_init, lennard_jones_atom
from emdee_tpu_torch.distributed import dryrun
from emdee_tpu_torch.distributed.grid_sharded import distribute_grid, gather_grid_state, make_grid_sharded_sim
from emdee_tpu_torch.distributed.mesh import make_grid_mesh
from emdee_tpu_torch.neighbors.cell_dense import state_from_numpy, state_to_numpy
from emdee_tpu_torch.potentials.coulomb import DSFCoulomb, coulomb_interaction

N_RANKS = 4  # the (2, 2, 1) mesh: 256 atoms, M = 8, capacity 8
# Fresh processes for the first-call check.  Without `core/vml.py` one
# process in ~8 showed F2 on an idle 8-core host, fewer under load.
N_FRESH = 16


@pytest.fixture(scope="module")
def part4():
    """(arrays, the one-card start state's fields) of part 4 at 4 ranks."""
    a = dryrun.molecular_arrays(N_RANKS)
    n = a["n"]
    st = cell_dense_init(a["pos"], a["vel"], np.ones(n), lennard_jones_atom(np.ones(n), np.ones(n), device="cpu"),
                         a["config4"], charges=a["q"], device="cpu")
    return a, state_to_numpy(st)


def _local(a, fields):
    """Part 4 on a `LocalMesh` in this process: the gathered end state."""
    cfg = a["config4"]
    mesh = make_grid_mesh(a["shape"], device="cpu")
    rollout, _ = make_grid_sharded_sim(cfg, LennardJonesModel.create(dryrun.CUTOFF, dryrun.SWITCH, device="cpu"),
                                       0.002, mesh, **dryrun.molecular_kwargs(4, N_RANKS, "cpu"))
    out = rollout(distribute_grid(state_from_numpy(fields, "cpu"), cfg, mesh), num_steps=2, rebin_every=2)
    return state_to_numpy(gather_grid_state(out, cfg, mesh))


def _assert_bitwise(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.atleast_1d(got[k]).view(np.uint8), np.atleast_1d(v).view(np.uint8),
                                      err_msg=k)


def test_part4_on_four_gloo_ranks_equals_localmesh(part4):
    a, fields = part4
    job = ((a["shape"], fields, a["config4"], 2, 2, "cpu"),
           dict(kwargs_fn=functools.partial(dryrun.molecular_kwargs, 4, N_RANKS)))
    runs = dryrun.run_ranks(N_RANKS, dryrun.grid_jobs, ([job],), timeout=240)
    local = _local(a, fields)
    for rank, (((got, _),)) in enumerate(runs):
        assert int(got["step"]) == 2, rank
        _assert_bitwise(got, local)


def test_part4_localmesh_bitwise_across_threads_and_deterministic_mode(part4):
    a, fields = part4
    threads = torch.get_num_threads()
    deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        want = _local(a, fields)
        torch.set_num_threads(1)
        one = _local(a, fields)
        torch.set_num_threads(threads)
        torch.use_deterministic_algorithms(True)
        det = _local(a, fields)
    finally:
        torch.set_num_threads(threads)
        torch.use_deterministic_algorithms(deterministic)
    _assert_bitwise(one, want)
    _assert_bitwise(det, want)


def _dsf_tile(threads):
    """The DSF pair terms (E, −r·dE/dr) of a seeded 2^20-element tile on the
    CPU at `threads` threads, as numpy: in a fresh process, its first call
    of erfc and exp."""
    torch.set_num_threads(threads)
    g = torch.Generator().manual_seed(0)
    r2 = torch.rand(1 << 20, generator=g) * 6.0 + 0.25
    q = torch.rand(1 << 20, generator=g) - 0.5
    e, mre = coulomb_interaction(r2, DSFCoulomb.create(2.5, alpha=0.25, device="cpu"), q, q)
    return torch.stack([e, mre]).numpy()


def test_dsf_first_call_in_fresh_processes_is_bitwise():
    want = _dsf_tile(torch.get_num_threads())
    with multiprocessing.get_context("spawn").Pool(8, maxtasksperchild=1) as pool:
        got = pool.map(_dsf_tile, [8] * N_FRESH, chunksize=1)
    for k, g in enumerate(got):
        np.testing.assert_array_equal(g.view(np.uint32), want.view(np.uint32), err_msg=f"process {k}")
