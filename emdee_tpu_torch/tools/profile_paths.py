"""Where the step time goes on the card, for each path of the LJ melt that
`chip_smoke.py` drives: at 97,556 atoms the dense component carry, the
dense stacked path, the straggler engine at bench.py's production config,
the spill config's component carry (K7 in its rebin), CSVR NVT on the wide
config, Langevin NVT on the spill config and the grid-sharded engine (every
shard on the card) on (1,1,1) at the wide config and on (2,2,2) at M = 16;
at 1,000,188 atoms the dense component carry on the streaming kernel
family; and the molecular dense engine on the 98,304-atom flexible-water
box of `tools/water.py` (NVE on its plain config with backend 'cuda', after
the CSVR equilibration `chip_smoke.py` runs).

Run from the repository root on a machine with a CUDA card:

    python3 -m emdee_tpu_torch.tools.profile_paths [water]

(`water`: the water path alone.)

For each path, after 60 steps of warm-up: the unprofiled ms/step of three
600-step windows (host clock around work that ends in a synchronize), then
one `torch.profiler` window of 120 steps, from which it prints per step the
device kernels, their summed device time (the device's busy time: one
stream, so kernels do not overlap), the host's CUDA runtime calls
(launches, copies, stream synchronizations), and the kernels that take the
most device time.  One JSON line per path follows its text lines.
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


def profile_path(name, rollout, state, rebin_every, **kw):
    run = lambda steps: rollout(state, num_steps=steps, rebin_every=rebin_every, **kw)  # noqa: E731
    run(WARMUP)
    windows = [_sync_ms(run, WINDOW) for _ in range(WINDOWS)]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(PROFILED)
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
    busy_ms = sum(kernel_us.values()) / 1e3 / PROFILED
    best = min(windows)
    top = [
        {"kernel": k[:80], "us_per_step": kernel_us[k] / PROFILED, "per_step": kernels[k] / PROFILED}
        for k, _ in kernel_us.most_common(6)
    ]
    result = {
        "path": name,
        "ms_per_step": windows,
        "device_busy_ms_per_step": busy_ms,
        "busy_share_of_best_window": busy_ms / best,
        "device_kernels_per_step": sum(kernels.values()) / PROFILED,
        "runtime_calls_per_step": {k: v / PROFILED for k, v in runtime.most_common()},
        "top_kernels": top,
    }
    print(f"{name}: ms/step {', '.join(f'{w:.4f}' for w in windows)}; device busy {busy_ms:.4f} ms/step "
          f"({100 * busy_ms / best:.1f}% of the best window); {result['device_kernels_per_step']:.1f} device "
          f"kernels/step; runtime calls/step {result['runtime_calls_per_step']}", flush=True)
    for t in top:
        print(f"  {t['us_per_step']:9.2f} us/step  {t['per_step']:6.2f}/step  {t['kernel']}", flush=True)
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
    nve, _ = water.molecular_sim(box, cfg, model, coul, params, "cuda", device)
    print(f"{n} atoms (water), M={cfg.cells_per_dim} C={cfg.capacity}, rebin every {water.REBIN_EVERY} steps",
          flush=True)
    profile_path("water (DSF + tags + bonds in K2c)", nve, init(*gather_dense_atoms(eq, n)), water.REBIN_EVERY)


def main(paths: str = "all") -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    if paths == "water":
        profile_water(device)
        return
    from emdee_tpu_torch import (
        CSVRConfig, LangevinConfig, cell_dense_init, make_cell_dense_sim, make_straggler_sim,
        straggler_init, suggest_rebin_interval,
    )
    from emdee_tpu_torch.tools.melt import (
        DT, FRICTION, N_CELLS_1M, SKIN, T_NVT, TAU_T, equilibrate, melt, spill_config, straggler_config,
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
    from emdee_tpu_torch import reconfigure_dense_state
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid, make_grid_sharded_sim
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh

    st16, cfg16 = reconfigure_dense_state(st0, config, cells_multiple_of=2)
    for shape, cfg, start in (((1, 1, 1), config, st0), ((2, 2, 2), cfg16, st16)):
        mesh = make_grid_mesh(shape, device=device)
        grid, _ = make_grid_sharded_sim(cfg, model, DT, mesh, uniform_params=uni)
        profile_path(f"grid {shape} M={cfg.cells_per_dim}", grid, distribute_grid(start, cfg, mesh), k)
    del st, st0, s0, sp0

    st, config, model, params, uni, n = melt(device, N_CELLS_1M)
    dense, _ = make_cell_dense_sim(config, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    pos_eq, vel_eq, _, k = equilibrate(dense, st, config, n)
    st0 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, config, device=device)
    print(f"{n} atoms, rebin every {k} steps", flush=True)
    profile_path("1M dense component carry", dense, st0, k)
    del st, st0
    profile_water(device)


if __name__ == "__main__":
    import sys

    main(*sys.argv[1:2])
