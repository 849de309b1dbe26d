"""A multi-process dry run of the grid-sharded engine — counterpart of part 3
of `dryrun_multichip` in the repository's `__graft_entry__.py`: the LJ grid
engine at its tiny shapes on an (nz, ny, nx) factorisation of n ranks, one
shard a rank, over `torch.distributed` (`DistMesh`): gloo ranks on the CPU,
or NCCL when n cards are present.

    python -m emdee_tpu_torch.distributed.dryrun [N]

Parts 1 and 2 of the reference (the atom-table slab decomposition of
`distributed/domain.py` and the slab-sharded `cell_dense_sharded.py`) are not
ported: a (D, 1, 1) grid mesh covers slabs (ROADMAP item 12).  Parts 4 to 6
(charges, exclusion tags, bonded terms on the grid) are not driven here;
`grid_job` takes the molecular options, and tests/test_torch_grid_molecular.py
runs the charged and the triatomic fixtures on two gloo ranks through it.

`run_ranks` is the launcher the tests share: n spawned processes, a
`file://` rendezvous in a fresh temporary directory, results back through a
queue, one deadline for the whole run, every process stopped at the end.
"""

from __future__ import annotations

import os
import queue
import sys
import tempfile
import time
import traceback

import numpy as np
import torch


def _rank_main(rank, n, path, backend, fn, args, results):
    import torch.distributed as dist

    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(1)  # n ranks share the host's cores
        dist.init_process_group(backend, init_method=f"file://{path}", world_size=n, rank=rank)
        try:
            results.put((rank, True, fn(rank, n, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))  # the launcher reports it
        raise


def run_ranks(n: int, fn, args=(), backend: str = "gloo", timeout: float = 300.0):
    """Run `fn(rank, n, *args)` in n spawned processes that form one
    `torch.distributed` group; return their results in rank order.  Raises
    if a rank fails or the run outlasts `timeout` seconds.  `fn` and its
    results must pickle."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(r, n, path, backend, fn, args, results)) for r in range(n)]
        for proc in procs:
            proc.start()
        got = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < n:
                try:
                    rank, ok, payload = results.get(timeout=max(deadline - time.monotonic(), 0.01))
                except queue.Empty:
                    raise TimeoutError(f"{n} ranks: no result within {timeout} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = payload
        finally:
            for proc in procs:
                proc.join(timeout=10)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
    return [got[r] for r in range(n)]


def mesh_shape(n: int):
    """The reference dry run's factorisation of n devices."""
    return {8: (2, 2, 2), 4: (2, 2, 1), 2: (2, 1, 1), 1: (1, 1, 1)}.get(n, (n, 1, 1))


def tiny_setup(n_devices: int, device):
    """The reference dry run's part-3 system: 64 atoms a device at random in
    a box of M = 4·max(shape) cells of side rc + 0.4, capacity 8 — (state,
    config, model, shape)."""
    from emdee_tpu_torch import LennardJonesModel, cell_dense_init, lennard_jones_atom
    from emdee_tpu_torch.neighbors.cell_dense import CellDenseConfig
    from emdee_tpu_torch.utils.lattice import maxwell_boltzmann

    cutoff, switch = 2.5, 2.0
    n = 64 * n_devices
    shape = mesh_shape(n_devices)
    m = 4 * max(shape)
    config = CellDenseConfig(cells_per_dim=m, capacity=8, box=m * (cutoff + 0.4), cutoff=cutoff,
                             switch=switch, skin=0.4, num_atoms=n)
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.0, config.box, (n, 3))
    params = lennard_jones_atom(np.ones(n), np.ones(n), device=device)
    state = cell_dense_init(pos, maxwell_boltzmann(n, 1.0, seed=1), np.ones(n), params, config, device=device)
    return state, config, LennardJonesModel.create(cutoff, switch, device=device), shape


def grid_job(rank, n, shape, fields, config, steps, rebin_every, device_kind="cpu", kwargs_fn=None, kwargs=None,
             seed=None):
    """One rank of a grid-sharded run: the state `fields` (the one-card
    state as `cell_dense.state_to_numpy` gives it) distributed over a
    `DistMesh` of `shape`, `steps` steps, then the whole state gathered
    and the energies.  kwargs_fn(device), a module-level function, gives
    the engine's molecular options (e.g. `tools.fixtures.grid_charged_kwargs`);
    kwargs, more options (a backend, a thermostat); seed, the seed of the
    rollout's generator on the rank's device, the same on every rank.
    Returns (state fields as numpy, (pe, vir, ke))."""
    import torch.distributed as dist

    from emdee_tpu_torch import LennardJonesModel
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid, gather_grid_state, make_grid_sharded_sim
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors.cell_dense import state_from_numpy, state_to_numpy

    device = torch.device("cuda", rank) if device_kind == "cuda" else torch.device("cpu")
    mesh = make_grid_mesh(shape, group=dist.group.WORLD, device=device)
    model = LennardJonesModel.create(config.cutoff, config.switch, device=device)
    options = {**(kwargs_fn(device) if kwargs_fn else {}), **(kwargs or {})}
    rollout, energy = make_grid_sharded_sim(config, model, 0.002, mesh, **options)
    st = distribute_grid(state_from_numpy(fields, device), config, mesh)
    rng = None if seed is None else torch.Generator(device=device).manual_seed(seed)
    st = rollout(st, num_steps=steps, rebin_every=rebin_every, rng=rng)
    energies = tuple(float(x) for x in energy(st))
    return state_to_numpy(gather_grid_state(st, config, mesh)), energies


def dryrun_multichip(n_devices: int) -> None:
    """Part 3 of the reference's dry run on n ranks (NCCL with n cards,
    gloo on the CPU otherwise): 4 NVE steps, rebin every 2, then the
    energies; every rank must gather the same state, bit for bit equal to
    the same run on a `LocalMesh` in this process."""
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid, gather_grid_state, make_grid_sharded_sim
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors.cell_dense import state_to_numpy

    on_cards = torch.cuda.is_available() and torch.cuda.device_count() >= n_devices
    device = torch.device("cuda", 0) if on_cards else torch.device("cpu")
    state, config, model, shape = tiny_setup(n_devices, device)
    fields = state_to_numpy(state)
    runs = run_ranks(n_devices, grid_job, (shape, fields, config, 4, 2, device.type),
                     backend="nccl" if on_cards else "gloo")
    mesh = make_grid_mesh(shape, device=device)
    rollout, energy = make_grid_sharded_sim(config, model, 0.002, mesh)
    local = state_to_numpy(gather_grid_state(rollout(distribute_grid(state, config, mesh), 4, 2), config, mesh))
    for rank, (got, energies) in enumerate(runs):
        if int(got["step"]) != 4:
            raise AssertionError(f"rank {rank}: step {got['step']}")
        for name, want in local.items():
            if not np.array_equal(np.atleast_1d(got[name]).view(np.uint8), np.atleast_1d(want).view(np.uint8)):
                raise AssertionError(f"rank {rank}: {name} differs from the LocalMesh run")
    print(f"dryrun_multichip({n_devices}): {shape} mesh on {'NCCL' if on_cards else 'gloo'} ranks, 4 steps, "
          f"pe {runs[0][1][0]:.6f}; every rank bitwise equal to the LocalMesh run", flush=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
