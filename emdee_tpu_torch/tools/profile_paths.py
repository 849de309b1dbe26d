"""Where the step time goes on the card, for each path of the LJ melt that
`chip_smoke.py` drives: at 97,556 atoms the dense component carry, the
dense stacked path, the straggler engine at bench.py's production config,
the spill config's component carry (K7 in its rebin), CSVR NVT on the wide
config, Langevin NVT on the spill config, Berendsen NPT (on the CSVR step)
on the wide config and the grid-sharded engine (every
shard on the card) on (1,1,1) at the wide config and on (2,2,2) at M = 16;
at 1,000,188 atoms the dense component carry on the streaming kernel
family; and the molecular engines on the 98,304-atom flexible-water box of
`tools/water.py` (NVE on its plain config after the CSVR equilibration
`chip_smoke.py` runs): the dense engine with backend 'cuda' (K2c) and
'auto' (the streaming family, K5c), and the grid-sharded engine on (2,2,2)
(K2c-G, bonds and angles as term rows); and the grid's streaming family and
ensembles: the 1M melt on the grid (1,1,1) at M = 37 on 'auto' (K5s and the
fold) and on (2,2,2) at M = 36, C = 40 on 'cuda_streaming' and on 'auto'
(which resolves to 'cuda' there: K2-G), Langevin and NPT (on 'auto' and on 'cuda_streaming') on the
97,556-atom melt at (2,2,2), M = 16.  `water1m`: the 985,527-atom water
box (69³ waters, M = 26, C = 88) on the grid (2,2,2) on 'auto' (K5s-mol,
bonds and angles as term rows) from the lattice start, with windows of 100
steps and a profiled window of 40.

Run from the repository root on a machine with a CUDA card:

    python3 -m emdee_tpu_torch.tools.profile_paths [lj | 1m | water | grid | water1m | portable | route]

(`lj`: the 97,556-atom paths of the dense and straggler engines alone;
`1m`: the 1,000,188-atom dense component carry alone, on 'auto' (the
streaming kernel, K5) and on 'cuda' (the resident kernel, K2a), from one
equilibrated melt; `water`, `grid`, `water1m`, `portable`: those paths
alone; `water1m` and `portable` are not in the default run.  `portable`:
the portable engine's neighbor-list NVE at 97,556 atoms, and its rebuild
and force pass apart; `route`: the paths whose rebin K7 and K6 run — the
spill component carry and Langevin, the grid on (1,1,1) and (2,2,2) at
97,556 atoms, the 1M grid (2,2,2) on 'auto' — not in the default run.)

For each path, after 60 steps of warm-up: the unprofiled ms/step of three
600-step windows (host clock around work that ends in a synchronize), then
one `torch.profiler` window of 120 steps, from which it prints per step the
device kernels, their summed device time (the device's busy time: one
stream, so kernels do not overlap), the host's CUDA runtime calls
(launches, copies, stream synchronizations), and the kernels that take the
most device time, each with its device time a launch (the force pass's
launch time: `cell_lj_kernel` on the LJ paths).  One JSON line per path
follows its text lines.
"""

from __future__ import annotations

import json
import subprocess
import time
from collections import Counter

import numpy as np
import torch

WARMUP, WINDOW, WINDOWS, PROFILED = 60, 600, 3, 120


def _sync_ms(fn, steps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(steps)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


def profile_path(name, rollout, state, rebin_every, window=WINDOW, profiled=PROFILED, **kw):
    run = lambda steps: rollout(state, num_steps=steps, rebin_every=rebin_every, **kw)  # noqa: E731
    run(WARMUP)
    windows = [_sync_ms(run, window) for _ in range(WINDOWS)]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(profiled)
        torch.cuda.synchronize()
    kernels = Counter()
    kernel_us = Counter()
    runtime = Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] += 1
            kernel_us[e.name] += e.device_time_total
        elif e.name.startswith("cuda") and e.name[4:5].isupper():
            runtime[e.name] += 1
    busy_ms = sum(kernel_us.values()) / 1e3 / profiled
    best = min(windows)
    top = [
        {"kernel": k[:80], "us_per_step": kernel_us[k] / profiled, "per_step": kernels[k] / profiled,
         "us_per_launch": kernel_us[k] / kernels[k]}
        for k, _ in kernel_us.most_common(6)
    ]
    result = {
        "path": name,
        "ms_per_step": windows,
        "device_busy_ms_per_step": busy_ms,
        "busy_share_of_best_window": busy_ms / best,
        "device_kernels_per_step": sum(kernels.values()) / profiled,
        "runtime_calls_per_step": {k: v / profiled for k, v in runtime.most_common()},
        "top_kernels": top,
    }
    print(f"{name}: ms/step {', '.join(f'{w:.4f}' for w in windows)}; device busy {busy_ms:.4f} ms/step "
          f"({100 * busy_ms / best:.1f}% of the best window); {result['device_kernels_per_step']:.1f} device "
          f"kernels/step; runtime calls/step {result['runtime_calls_per_step']}", flush=True)
    for t in top:
        print(f"  {t['us_per_step']:9.2f} us/step  {t['per_step']:6.2f}/step  {t['us_per_launch']:9.2f} us/launch  "
              f"{t['kernel']}", flush=True)
    print(json.dumps(result), flush=True)


def profile_water(device) -> None:
    from emdee_tpu_torch import cell_dense_init, gather_dense_atoms
    from emdee_tpu_torch.tools import water

    box, cfg, model, coul, params = water.water_setup(device, spill=False)
    n = len(box["masses"])
    init = lambda pos, vel: cell_dense_init(pos, vel, box["masses"], params, cfg,  # noqa: E731
                                            charges=box["charges"], device=device)
    nvt, _ = water.molecular_sim(box, cfg, model, coul, params, "cuda", device, water.csvr())
    eq = nvt(init(box["positions"], box["velocities"]), num_steps=water.EQ_STEPS, rebin_every=water.REBIN_EVERY,
             rng=torch.Generator(device=device).manual_seed(water.SEED))
    print(f"{n} atoms (water), M={cfg.cells_per_dim} C={cfg.capacity}, rebin every {water.REBIN_EVERY} steps",
          flush=True)
    start = init(*gather_dense_atoms(eq, n))
    for backend, what in (("cuda", "K2c"), ("auto", "K5c")):
        nve, _ = water.molecular_sim(box, cfg, model, coul, params, backend, device)
        profile_path(f"water '{backend}' (DSF + tags + bonds in {what})", nve, start, water.REBIN_EVERY)
    from emdee_tpu_torch import build_exclusion_tables
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid, make_grid_sharded_sim
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh

    mesh = make_grid_mesh((2, 2, 2), device=device)
    grid, _ = make_grid_sharded_sim(
        cfg, model, water.DT, mesh, coulomb=coul, bonded=water.bonded_system(box, device),
        excl_tables=build_exclusion_tables(n, box["exclusion_pairs"], box["exclusion_scales"], None))
    profile_path("grid water (2,2,2) (DSF + tags in K2c-G, bonded term rows)", grid, distribute_grid(start, cfg, mesh),
                 water.REBIN_EVERY)


def profile_1m(device, backends=("auto", "cuda")) -> None:
    """The 1M melt's dense component carry on each backend, from one
    equilibrated state ('auto' resolves to the streaming family there)."""
    from emdee_tpu_torch import cell_dense_init, make_cell_dense_sim, resolve_dense_backend
    from emdee_tpu_torch.tools.melt import DT, N_CELLS_1M, equilibrate, melt

    st, config, model, params, uni, n = melt(device, N_CELLS_1M)
    dense, _ = make_cell_dense_sim(config, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    pos_eq, vel_eq, _, k = equilibrate(dense, st, config, n)
    st0 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, config, device=device)
    print(f"{n} atoms, M={config.cells_per_dim} C={config.capacity}, rebin every {k} steps", flush=True)
    for backend in backends:
        family = resolve_dense_backend(config, backend, device=device)
        rollout, _ = make_cell_dense_sim(config, model, dt=DT, backend=backend, uniform_params=uni,
                                         uniform_mass=1.0)
        profile_path(f"1M dense component carry on {backend!r} ({family})", rollout, st0, k)


def profile_water_1m(device) -> None:
    from emdee_tpu_torch import build_exclusion_tables, cell_dense_init
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid, make_grid_sharded_sim
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.tools import water

    box, cfg, model, coul, params = water.water_setup(device, n_side=water.N_SIDE_1M, spill=False)
    n = len(box["masses"])
    st = cell_dense_init(box["positions"], box["velocities"], box["masses"], params, cfg, charges=box["charges"],
                         device=device)
    mesh = make_grid_mesh((2, 2, 2), device=device)
    grid, _ = make_grid_sharded_sim(
        cfg, model, water.DT, mesh, coulomb=coul, bonded=water.bonded_system(box, device),
        excl_tables=build_exclusion_tables(n, box["exclusion_pairs"], box["exclusion_scales"], None))
    print(f"{n} atoms (water), M={cfg.cells_per_dim} C={cfg.capacity}, grid (2,2,2) on {grid.family!r}, rebin every "
          f"{water.REBIN_EVERY} steps, from the lattice start", flush=True)
    profile_path("985,527 water grid (2,2,2) 'auto' (DSF + tags in K5s-mol, bonded term rows)", grid,
                 distribute_grid(st, cfg, mesh), water.REBIN_EVERY, window=100, profiled=40)


def profile_grid(device) -> None:
    from emdee_tpu_torch import (
        BerendsenBarostatConfig, CSVRConfig, LangevinConfig, cell_dense_init, make_cell_dense_sim,
        reconfigure_dense_state, suggest_rebin_interval,
    )
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid, make_grid_sharded_sim
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.tools.melt import (
        DT, FRICTION, KAPPA, N_CELLS_1M, P_NPT, SKIN, T_NVT, TAU_P, TAU_T, equilibrate, even_config, melt,
    )

    gen = lambda: torch.Generator(device=device).manual_seed(7)  # noqa: E731
    st, config, model, params, uni, n = melt(device)
    dense, _ = make_cell_dense_sim(config, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    pos_eq, vel_eq, _, _ = equilibrate(dense, st, config, n)
    st16, cfg16 = reconfigure_dense_state(cell_dense_init(pos_eq, vel_eq, np.ones(n), params, config, device=device),
                                          config, cells_multiple_of=2)
    mesh = make_grid_mesh((2, 2, 2), device=device)
    sh = distribute_grid(st16, cfg16, mesh)
    k_t = suggest_rebin_interval(SKIN, DT, T_NVT)
    print(f"{n} atoms, M={cfg16.cells_per_dim} C={cfg16.capacity} on (2,2,2), rebin every {k_t} steps", flush=True)
    lan, _ = make_grid_sharded_sim(cfg16, model, DT, mesh, uniform_params=uni, thermostat=LangevinConfig(T_NVT, FRICTION))
    profile_path("grid (2,2,2) M=16 Langevin (K2-G)", lan, sh, k_t, rng=gen())
    for backend in ("auto", "cuda_streaming"):
        npt, _ = make_grid_sharded_sim(cfg16, model, DT, mesh, uniform_params=uni, backend=backend,
                                       thermostat=CSVRConfig(T_NVT, TAU_T),
                                       barostat=BerendsenBarostatConfig(P_NPT, TAU_P, KAPPA))
        profile_path(f"grid (2,2,2) M=16 NPT on {npt.family!r}", npt, sh, k_t, rng=gen())
    del st, st16, sh

    st, config, model, params, uni, n = melt(device, N_CELLS_1M)
    dense, _ = make_cell_dense_sim(config, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    pos_eq, vel_eq, _, k = equilibrate(dense, st, config, n)
    st37 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, config, device=device)
    cfg36 = even_config(st37, config)
    st36 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, cfg36, device=device)
    print(f"{n} atoms, rebin every {k} steps", flush=True)
    for shape, cfg, start, backend in (((1, 1, 1), config, st37, "auto"), ((2, 2, 2), cfg36, st36, "cuda_streaming"),
                                       ((2, 2, 2), cfg36, st36, "auto")):
        mesh = make_grid_mesh(shape, device=device)
        grid, _ = make_grid_sharded_sim(cfg, model, DT, mesh, uniform_params=uni, backend=backend)
        profile_path(f"1M grid {shape} M={cfg.cells_per_dim} C={cfg.capacity} on {backend!r} -> {grid.family!r}", grid,
                     distribute_grid(start, cfg, mesh), k)


def profile_route(device) -> None:
    """The paths whose rebin K7 and K6 run: at 97,556 atoms, after the main
    path's equilibration, the spill config's component carry and Langevin
    (K7) and the grid's NVE on (1,1,1) and on (2,2,2) at M = 16 (K6); the
    1M melt on the grid (2,2,2) at M = 36, C = 40 on 'auto' (K2-G and K6)."""
    from emdee_tpu_torch import (
        LangevinConfig, cell_dense_init, make_cell_dense_sim, reconfigure_dense_state, suggest_rebin_interval,
    )
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid, make_grid_sharded_sim
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.tools.melt import (
        DT, FRICTION, N_CELLS_1M, SKIN, T_NVT, equilibrate, even_config, melt, spill_config,
    )

    st, config, model, params, uni, n = melt(device)
    dense, _ = make_cell_dense_sim(config, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    pos_eq, vel_eq, _, k = equilibrate(dense, st, config, n)
    st0 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, config, device=device)
    scfg = spill_config(config)
    sp0 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, scfg, device=device)
    print(f"{n} atoms, rebin every {k} steps", flush=True)
    spill, _ = make_cell_dense_sim(scfg, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    profile_path("spill component carry", spill, sp0, k)
    langevin, _ = make_cell_dense_sim(scfg, model, dt=DT, thermostat=LangevinConfig(T_NVT, FRICTION))
    profile_path("NVT Langevin (spill)", langevin, sp0, suggest_rebin_interval(SKIN, DT, T_NVT),
                 rng=torch.Generator(device=device).manual_seed(7))
    st16, cfg16 = reconfigure_dense_state(st0, config, cells_multiple_of=2)
    for shape, cfg, start in (((1, 1, 1), config, st0), ((2, 2, 2), cfg16, st16)):
        mesh = make_grid_mesh(shape, device=device)
        grid, _ = make_grid_sharded_sim(cfg, model, DT, mesh, uniform_params=uni)
        profile_path(f"grid {shape} M={cfg.cells_per_dim}", grid, distribute_grid(start, cfg, mesh), k)
    del st, st0, sp0, st16

    st, config, model, params, uni, n = melt(device, N_CELLS_1M)
    dense, _ = make_cell_dense_sim(config, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    pos_eq, vel_eq, _, k = equilibrate(dense, st, config, n)
    cfg36 = even_config(st, config)
    st36 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, cfg36, device=device)
    mesh = make_grid_mesh((2, 2, 2), device=device)
    grid, _ = make_grid_sharded_sim(cfg36, model, DT, mesh, uniform_params=uni)
    print(f"{n} atoms, rebin every {k} steps", flush=True)
    profile_path(f"1M grid (2, 2, 2) M={cfg36.cells_per_dim} C={cfg36.capacity} on 'auto' -> {grid.family!r}", grid,
                 distribute_grid(st36, cfg36, mesh), k)


def profile_portable(device) -> None:
    """The portable engine's NVE on the neighbor list (plain torch ops) at
    the 97,556-atom melt after the main path's equilibration, at the README
    example's config (cutoff 2.5, switch 2.0, skin 0.3), and the times of
    its two parts apart: a rebuild (`build_neighbor_list`) and a force pass
    (`compute_nonbonded_neighborlist`, at its default block and at the
    reference's 8,192 atoms a block)."""
    from emdee_tpu_torch import (
        NonbondedConfig, lennard_jones_atom, make_cell_dense_sim, make_force_fn, make_state, nve_rollout,
    )
    from emdee_tpu_torch.core.types import FORCES
    from emdee_tpu_torch.neighbors import api
    from emdee_tpu_torch.neighbors.neighbor_force import compute_nonbonded_neighborlist
    from emdee_tpu_torch.neighbors.neighbor_list import build_neighbor_list
    from emdee_tpu_torch.tools.melt import CUTOFF, DT, SWITCH, equilibrate, melt

    st, config, model, params, uni, n = melt(device)
    dense, _ = make_cell_dense_sim(config, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    pos_eq, vel_eq, _, _ = equilibrate(dense, st, config, n)
    nbc = NonbondedConfig(cutoff=CUTOFF, switch=SWITCH, skin=0.3)
    lj = lennard_jones_atom(np.ones(n), np.ones(n), device=device)
    nb = make_force_fn(nbc, lj, config.box, n, device=device)
    state = make_state(pos_eq, vel_eq, box=config.box, device=device)
    aux = nb.init(state.positions)
    list_cutoff, m = nbc.list_geometry(config.box)
    print(f"{n} atoms, neighbor list K={aux.max_neighbors}, cell capacity {aux.cell_capacity}, M={m}", flush=True)
    build = lambda: build_neighbor_list(state.positions, config.box, list_cutoff, cells_per_dim=m,  # noqa: E731
                                        cell_capacity=aux.cell_capacity, max_neighbors=aux.max_neighbors)
    force = lambda **kw: compute_nonbonded_neighborlist(state.positions, state.box, nb.model, lj, aux,  # noqa: E731
                                                        outputs=FORCES, **kw)
    for label, fn in (("rebuild", build), ("force pass", force),
                      ("force pass at the reference's atom_chunk 8192", lambda: force(atom_chunk=8192))):
        host = _sync_ms(lambda steps: [fn() for _ in range(steps)], 20)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        stop.record()
        torch.cuda.synchronize()
        print(f"  {label}: {host:.4f} ms a call on the host clock, {start.elapsed_time(stop) / 20:.4f} ms between "
              "CUDA events", flush=True)
    print(f"  forces bitwise equal at both block sizes: {torch.equal(force().forces, force(atom_chunk=8192).forces)}",
          flush=True)
    api.HOST_READS = api.REBUILDS = 0
    profile_path("portable NVE (neighbor list, plain torch ops)",
                 lambda s, num_steps, rebin_every: nve_rollout(s, aux, nb.force_fn, DT, num_steps)[0],
                 state, 0, window=200, profiled=50)
    print(f"  rebuilds {api.REBUILDS} in {api.HOST_READS} force evaluations", flush=True)


def main(paths: str = "all") -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    if paths in ("1m", "water", "grid", "water1m", "portable", "route"):
        {"1m": profile_1m, "water": profile_water, "grid": profile_grid, "water1m": profile_water_1m,
         "portable": profile_portable, "route": profile_route}[paths](device)
        return
    from emdee_tpu_torch import (
        BerendsenBarostatConfig, CSVRConfig, LangevinConfig, cell_dense_init, make_cell_dense_sim,
        make_straggler_sim, straggler_init, suggest_rebin_interval,
    )
    from emdee_tpu_torch.tools.melt import (
        DT, FRICTION, KAPPA, P_NPT, SKIN, T_NVT, TAU_P, TAU_T, equilibrate, melt, spill_config, straggler_config,
    )

    st, config, model, params, uni, n = melt(device)
    dense, _ = make_cell_dense_sim(config, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    pos_eq, vel_eq, _, k = equilibrate(dense, st, config, n)
    st0 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, config, device=device)
    production = straggler_config(config, 4, 64, 16)
    s0 = straggler_init(pos_eq, vel_eq, np.ones(n), params, production, device=device)
    stacked, _ = make_cell_dense_sim(config, model, dt=DT)
    straggler, _ = make_straggler_sim(production, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    print(f"{n} atoms, rebin every {k} steps", flush=True)
    profile_path("dense component carry", dense, st0, k)
    profile_path("dense stacked", stacked, st0, k)
    profile_path("straggler production", straggler, s0, k)
    scfg = spill_config(config)
    sp0 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, scfg, device=device)
    spill, _ = make_cell_dense_sim(scfg, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    profile_path("spill component carry", spill, sp0, k)
    k_t = suggest_rebin_interval(SKIN, DT, T_NVT)
    csvr, _ = make_cell_dense_sim(config, model, dt=DT, thermostat=CSVRConfig(T_NVT, TAU_T))
    profile_path("NVT CSVR (wide)", csvr, st0, k_t, rng=torch.Generator(device=device).manual_seed(7))
    langevin, _ = make_cell_dense_sim(scfg, model, dt=DT, thermostat=LangevinConfig(T_NVT, FRICTION))
    profile_path("NVT Langevin (spill)", langevin, sp0, k_t, rng=torch.Generator(device=device).manual_seed(7))
    npt, _ = make_cell_dense_sim(config, model, dt=DT, thermostat=CSVRConfig(T_NVT, TAU_T),
                                 barostat=BerendsenBarostatConfig(P_NPT, TAU_P, KAPPA))
    profile_path("NPT CSVR + Berendsen (wide)", npt, st0, k_t, rng=torch.Generator(device=device).manual_seed(7))
    if paths == "lj":
        return
    from emdee_tpu_torch import reconfigure_dense_state
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid, make_grid_sharded_sim
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh

    st16, cfg16 = reconfigure_dense_state(st0, config, cells_multiple_of=2)
    for shape, cfg, start in (((1, 1, 1), config, st0), ((2, 2, 2), cfg16, st16)):
        mesh = make_grid_mesh(shape, device=device)
        grid, _ = make_grid_sharded_sim(cfg, model, DT, mesh, uniform_params=uni)
        profile_path(f"grid {shape} M={cfg.cells_per_dim}", grid, distribute_grid(start, cfg, mesh), k)
    del st, st0, s0, sp0

    profile_1m(device, ("auto",))
    profile_water(device)
    profile_grid(device)


if __name__ == "__main__":
    import sys

    main(*sys.argv[1:2])
