"""A multi-process dry run of the sharded engines — counterpart of
`dryrun_multichip` in the repository's `__graft_entry__.py`, at its tiny
shapes, one shard a rank over `torch.distributed` (`DistMesh`): gloo ranks
on the CPU, or NCCL when n cards are present.

    python -m emdee_tpu_torch.distributed.dryrun [N]

- Part 1: the atom-table slab engine (`distributed/domain.py`) on a
  (N, 1, 1) mesh: 64·N atoms at random in a box of 6.5·N, `resort_every`
  5, one block (step 5), the energy path; no flag from N = 4 on (below
  that the random start's closest pairs throw atoms past the halo skin
  within the block, and the staleness flag rises in the reference's run
  as in this one).
- Part 2: the slab-sharded dense-cell engine
  (`distributed/cell_dense_sharded.py`): M = 2·N cells, capacity 8, 4
  steps, rebinning every 2.
- Part 3: the LJ grid engine on an (nz, ny, nx) factorisation of the N
  ranks, 4 NVE steps, rebinning every 2.
- Part 4: DSF charges (±0.2) and exclusion tags on every (2i, 2i+1) pair,
  2 steps.
- Part 5: the full molecular decomposition: pairs bonded at the LJ minimum
  on a lattice, the bonds as term rows, half of the bonded pairs in the
  tags and the other half as leftover exclusion pairs, capacity 16, 2
  steps.
- Part 6: part 5 on the kernels ('cuda' on NCCL ranks; on gloo ranks the
  plain streaming family 'torch_streaming'), its energy within 1e-4 of part
  5's.

Every rank of every part must gather a state bit for bit equal to the same
run on a `LocalMesh` in this process.

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

import functools

import numpy as np
import torch

CUTOFF, SWITCH = 2.5, 2.0


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


def tiny_arrays(n_devices: int):
    """The reference dry run's part-3 system as numpy: 64 atoms a device at
    random in a box of M = 4·max(shape) cells of side rc + 0.4, capacity 8
    — (positions, velocities, config, shape, the generator that drew the
    positions, for the later parts' draws)."""
    from emdee_tpu_torch.neighbors.cell_dense import CellDenseConfig
    from emdee_tpu_torch.utils.lattice import maxwell_boltzmann

    n = 64 * n_devices
    shape = mesh_shape(n_devices)
    m = 4 * max(shape)
    config = CellDenseConfig(cells_per_dim=m, capacity=8, box=m * (CUTOFF + 0.4), cutoff=CUTOFF, switch=SWITCH,
                             skin=0.4, num_atoms=n)
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.0, config.box, (n, 3))
    return pos, maxwell_boltzmann(n, 1.0, seed=1), config, shape, rng


def tiny_setup(n_devices: int, device):
    """Part 3's system on `device`: (state, config, model, shape)."""
    from emdee_tpu_torch import LennardJonesModel, cell_dense_init, lennard_jones_atom

    pos, vel, config, shape, _ = tiny_arrays(n_devices)
    n = len(pos)
    params = lennard_jones_atom(np.ones(n), np.ones(n), device=device)
    state = cell_dense_init(pos, vel, np.ones(n), params, config, device=device)
    return state, config, LennardJonesModel.create(CUTOFF, SWITCH, device=device), shape


def molecular_arrays(n_devices: int) -> dict:
    """Parts 4 to 6's fixtures as numpy, built as `__graft_entry__.py`
    builds them: q, ±0.2 alternating; tags4, the (2i, 2i+1) pairs that part
    4 excludes fully; pos5, n/2 lattice sites of the part-3 box each with a
    partner at the LJ minimum r_min = 2^(1/6) in a random direction; bonds,
    those (2i, 2i+1) pairs; tags5 their first half (the tag tables at scale
    0) and leftover the second half (scale 0.5 for LJ and Coulomb); config4
    part 3's config, config5 it at capacity 16 (the pairs need headroom)."""
    pos, vel, config, shape, rng = tiny_arrays(n_devices)
    n = len(pos)
    half = n // 2
    side = int(np.ceil(half ** (1 / 3)))
    g = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"), -1).reshape(-1, 3)[:half]
    off = rng.normal(size=(half, 3))
    r_min = 2.0 ** (1 / 6)
    off = r_min * off / np.linalg.norm(off, axis=1, keepdims=True)
    pos5 = np.empty((n, 3))
    pos5[0::2] = (g + 0.5) * (config.box / side)
    pos5[1::2] = pos5[0::2] + off
    base = np.arange(0, n - 1, 2)
    bonds = np.stack([np.arange(0, n, 2), np.arange(1, n, 2)], 1)
    return dict(n=n, pos=pos, vel=vel, shape=shape, q=np.where(np.arange(n) % 2 == 0, 0.2, -0.2).astype(np.float32),
                tags4=np.stack([base, base + 1], 1), pos5=pos5, bonds=bonds, r_min=r_min, tags5=bonds[: half // 2],
                leftover=bonds[half // 2:], config4=config, config5=config._replace(capacity=16))


def molecular_kwargs(part: int, n_devices: int, device) -> dict:
    """The molecular options of `make_grid_sharded_sim` for part 4, or for
    parts 5 and 6, on `device` (with `functools.partial` over the first two
    arguments, `grid_job`'s kwargs_fn)."""
    import torch

    from emdee_tpu_torch import BondedSystem, BondTable, DSFCoulomb, build_exclusion_tables, lennard_jones_atom

    a = molecular_arrays(n_devices)
    n = a["n"]
    kw = dict(coulomb=DSFCoulomb.create(CUTOFF, alpha=0.25, coulomb_constant=1.0, device=device))
    if part == 4:
        return dict(kw, excl_tables=build_exclusion_tables(n, a["tags4"], np.zeros(len(a["tags4"]), np.float32)))
    nb, left = len(a["bonds"]), a["leftover"]
    t = lambda x, dt: torch.from_numpy(np.asarray(x, dt)).to(device)  # noqa: E731
    bonded = BondedSystem(bonds=BondTable(t(a["bonds"], np.int64), t(np.full(nb, a["r_min"]), np.float32),
                                          t(np.full(nb, 10.0), np.float32), t(np.ones(nb), np.bool_)),
                          angles=None, torsions=None, impropers=None)
    half = np.full(len(left), 0.5, np.float32)
    return dict(kw, excl_tables=build_exclusion_tables(n, a["tags5"], np.zeros(len(a["tags5"]), np.float32)),
                bonded=bonded, excl_leftover=(left.astype(np.int32), half, half),
                atom_params=lennard_jones_atom(np.ones(n), np.ones(n), device=device), atom_charges=a["q"])


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


def grid_jobs(rank, n, jobs):
    """`grid_job` for each (args, options) of `jobs` in turn, in one process
    group: [result, ...]."""
    return [grid_job(rank, n, *args, **options) for args, options in jobs]


def slab_arrays(n_devices: int) -> dict:
    """Parts 1 and 2's systems as numpy, drawn as `__graft_entry__.py`
    draws them: 64·D atoms at random in a box of 6.5·D (slab ≥ 2·(rc +
    halo skin) = 6), Maxwell-Boltzmann velocities at T = 1, and part 2's
    positions, the generator's next draw, in its box of M = 2·D cells of
    side rc + 0.4 (config2, capacity 8)."""
    from emdee_tpu_torch.neighbors.cell_dense import CellDenseConfig
    from emdee_tpu_torch.utils.lattice import maxwell_boltzmann

    n, box = 64 * n_devices, 6.5 * n_devices
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.0, box, (n, 3))
    m = 2 * n_devices
    config2 = CellDenseConfig(cells_per_dim=m, capacity=8, box=m * (CUTOFF + 0.4), cutoff=CUTOFF, switch=SWITCH,
                              skin=0.4, num_atoms=n)
    return dict(n=n, box=box, pos=pos, vel=maxwell_boltzmann(n, 1.0, seed=1), config2=config2,
                pos2=rng.uniform(0.0, config2.box, (n, 3)))


def _to_numpy(state) -> dict:
    return {k: v.cpu().contiguous().numpy() for k, v in state._asdict().items() if isinstance(v, torch.Tensor)}


def domain_run(mesh, pos, vel, config, num_blocks: int):
    """The atom-table slab engine from host arrays (unit masses and LJ
    parameters, dt = 0.002) on a (D, 1, 1) mesh: (the whole state after
    `num_blocks` blocks, gathered, as numpy fields; (pe, virial))."""
    from emdee_tpu_torch import LennardJonesModel, lennard_jones_atom
    from emdee_tpu_torch.distributed import domain

    n, dev = len(pos), mesh.device
    rollout, energy = domain.make_sharded_step(config, mesh, LennardJonesModel.create(CUTOFF, SWITCH, device=dev),
                                               dt=0.002)
    params = lennard_jones_atom(np.ones(n), np.ones(n), device=dev)
    st = rollout(domain.distribute(pos, vel, np.ones(n), params, config, mesh), num_blocks=num_blocks)
    return _to_numpy(domain.gather_sharded(st, mesh)), tuple(float(x) for x in energy(st))


def slab_run(mesh, fields, config, steps: int, rebin_every: int):
    """The slab-sharded dense-cell engine from a one-card state's fields
    (`cell_dense.state_to_numpy`) on a (D, 1, 1) mesh, dt = 0.002: (the
    whole state after `steps` steps, gathered, as numpy fields; (pe,
    virial, ke))."""
    from emdee_tpu_torch import LennardJonesModel
    from emdee_tpu_torch.distributed import cell_dense_sharded as cds
    from emdee_tpu_torch.neighbors.cell_dense import state_from_numpy

    dev = mesh.device
    rollout, energy = cds.make_sharded_cell_dense_sim(config, LennardJonesModel.create(CUTOFF, SWITCH, device=dev),
                                                      0.002, mesh)
    st = rollout(cds.distribute_cell_dense(state_from_numpy(fields, dev), mesh), num_steps=steps,
                 rebin_every=rebin_every)
    return _to_numpy(cds.gather_cell_dense(st, mesh)), tuple(float(x) for x in energy(st))


def _rank_mesh(rank, n, device_kind):
    import torch.distributed as dist

    from emdee_tpu_torch.distributed.mesh import make_mesh

    device = torch.device("cuda", rank) if device_kind == "cuda" else torch.device("cpu")
    return make_mesh(n, group=dist.group.WORLD, device=device)


def domain_job(rank, n, pos, vel, config, num_blocks, device_kind="cpu"):
    """One rank of `domain_run` on an (n, 1, 1) `DistMesh`."""
    return domain_run(_rank_mesh(rank, n, device_kind), pos, vel, config, num_blocks)


def slab_job(rank, n, fields, config, steps, rebin_every, device_kind="cpu"):
    """One rank of `slab_run` on an (n, 1, 1) `DistMesh`."""
    return slab_run(_rank_mesh(rank, n, device_kind), fields, config, steps, rebin_every)


def slab_part(part: int, mesh):
    """Part 1 (`domain_run`, one block) or part 2 (`slab_run`, 4 steps,
    rebinning every 2) on a (D, 1, 1) slab mesh."""
    from emdee_tpu_torch import cell_dense_init, lennard_jones_atom
    from emdee_tpu_torch.distributed.domain import suggest_domain_config
    from emdee_tpu_torch.neighbors.cell_dense import state_to_numpy

    d = mesh.shape[0]
    a = slab_arrays(d)
    n = a["n"]
    if part == 1:
        return domain_run(mesh, a["pos"], a["vel"], suggest_domain_config(n, a["box"], CUTOFF, d, resort_every=5), 1)
    params = lennard_jones_atom(np.ones(n), np.ones(n), device=mesh.device)
    st = cell_dense_init(a["pos2"], a["vel"], np.ones(n), params, a["config2"], device=mesh.device)
    return slab_run(mesh, state_to_numpy(st), a["config2"], 4, 2)


def dryrun_jobs(rank, n, device_kind, jobs):
    """One rank of the whole dry run: parts 1 and 2 on the (n, 1, 1) slab
    mesh, then `grid_jobs(jobs)`."""
    mesh = _rank_mesh(rank, n, device_kind)
    return [slab_part(part, mesh) for part in (1, 2)], grid_jobs(rank, n, jobs)


def _bitwise_equal(got: dict, want: dict) -> bool:
    return all(np.array_equal(np.atleast_1d(got[k]).view(np.uint8), np.atleast_1d(v).view(np.uint8))
               for k, v in want.items())


def dryrun_multichip(n_devices: int) -> None:
    """Parts 1 to 6 of the reference's dry run on n ranks (NCCL with n
    cards, gloo on the CPU otherwise); every rank must gather the same
    state, bit for bit equal to the same run on a `LocalMesh` in this
    process, parts 5 and 6 (and part 1 on n ≥ 4) raise no flag, parts 1
    and 2 end at steps 5 and 4, and part 6's energy is part 5's within
    1e-4."""
    from emdee_tpu_torch import LennardJonesModel, cell_dense_init, lennard_jones_atom
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid, gather_grid_state, make_grid_sharded_sim
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh, make_mesh
    from emdee_tpu_torch.neighbors.cell_dense import state_from_numpy, state_to_numpy

    on_cards = torch.cuda.is_available() and torch.cuda.device_count() >= n_devices
    device = torch.device("cuda", 0) if on_cards else torch.device("cpu")
    a = molecular_arrays(n_devices)
    n, shape = a["n"], a["shape"]
    params = lennard_jones_atom(np.ones(n), np.ones(n), device=device)
    init = lambda pos, cfg, q=None: state_to_numpy(  # noqa: E731
        cell_dense_init(pos, a["vel"], np.ones(n), params, cfg, charges=q, device=device))
    kernels = {"backend": "cuda" if on_cards else "torch_streaming"}
    # (part, its state fields, config, steps, rebin_every, kwargs_fn, kwargs)
    parts = [
        (3, init(a["pos"], a["config4"]), a["config4"], 4, 2, None, None),
        (4, init(a["pos"], a["config4"], a["q"]), a["config4"], 2, 2, functools.partial(molecular_kwargs, 4, n_devices),
         None),
        (5, init(a["pos5"], a["config5"], a["q"]), a["config5"], 2, 2, functools.partial(molecular_kwargs, 5, n_devices),
         None),
        (6, init(a["pos5"], a["config5"], a["q"]), a["config5"], 2, 2, functools.partial(molecular_kwargs, 5, n_devices),
         kernels),
    ]
    jobs = [((shape, fields, cfg, steps, every, device.type), dict(kwargs_fn=fn, kwargs=kw))
            for _, fields, cfg, steps, every, fn, kw in parts]
    runs = run_ranks(n_devices, dryrun_jobs, (device.type, jobs), backend="nccl" if on_cards else "gloo")
    slab_mesh = make_mesh(n_devices, device=device)
    slab_pe = {}
    for k, (part, steps) in enumerate(((1, 5), (2, 4))):
        local, _ = slab_part(part, slab_mesh)
        for rank, (slab_runs, _) in enumerate(runs):
            got, energies = slab_runs[k]
            if int(got["step"]) != steps:
                raise AssertionError(f"part {part}, rank {rank}: step {got['step']}")
            if not _bitwise_equal(got, local):
                raise AssertionError(f"part {part}, rank {rank}: the state differs from the LocalMesh run")
        if part == 1 and n_devices >= 4 and bool(local["overflow"]):
            raise AssertionError("part 1: the sticky flag is raised")
        slab_pe[part] = (runs[0][0][k][1][0], bool(local["overflow"]))
    print(f"dryrun_multichip({n_devices}): ({n_devices}, 1, 1) slab mesh on {'NCCL' if on_cards else 'gloo'} ranks, "
          f"parts 1-2; pe, flag " + ", ".join(f"{p} {v:.6f} {f}" for p, (v, f) in slab_pe.items())
          + "; every rank bitwise equal to the LocalMesh run", flush=True)
    runs = [grid for _, grid in runs]
    mesh = make_grid_mesh(shape, device=device)
    model = LennardJonesModel.create(CUTOFF, SWITCH, device=device)
    pe = {}
    for k, (part, fields, cfg, steps, every, fn, kw) in enumerate(parts):
        rollout, energy = make_grid_sharded_sim(cfg, model, 0.002, mesh, **(fn(device) if fn else {}), **(kw or {}))
        out = rollout(distribute_grid(state_from_numpy(fields, device), cfg, mesh), steps, every)
        local = state_to_numpy(gather_grid_state(out, cfg, mesh))
        for rank, results in enumerate(runs):
            got, energies = results[k]
            if int(got["step"]) != steps:
                raise AssertionError(f"part {part}, rank {rank}: step {got['step']}")
            if not _bitwise_equal(got, local):
                raise AssertionError(f"part {part}, rank {rank}: the state differs from the LocalMesh run")
        if part >= 5 and bool(local["overflow"]):
            raise AssertionError(f"part {part}: the sticky flag is raised")
        pe[part] = runs[0][k][1][0]
    if abs(pe[6] - pe[5]) > 1e-4 * max(1.0, abs(pe[5])):
        raise AssertionError(f"part 6's energy {pe[6]} is not part 5's {pe[5]} within 1e-4")
    print(f"dryrun_multichip({n_devices}): {shape} mesh on {'NCCL' if on_cards else 'gloo'} ranks, parts 3-6 "
          f"(part 6 on {kernels['backend']}); pe " + ", ".join(f"{p} {v:.6f}" for p, v in pe.items())
          + "; every rank bitwise equal to the LocalMesh run", flush=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
