"""High-level simulation runner: the production loop around the rollouts
(counterpart of emdee_tpu/utils/runner.py).

Ties the device rollouts to the host-side operational pieces the reference
never had (SURVEY.md §5): periodic trajectory dumps, checkpointing, NaN/energy
guards, throughput logging — in chunks, so the device runs thousands of steps
per host round-trip.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from emdee_tpu_torch.utils.observability import ThroughputMeter, check_finite, guard_energy, span


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int
    chunk_steps: int = 1000  # steps per device round-trip
    trajectory_path: Optional[str] = None  # XYZ dumps, one frame per chunk
    checkpoint_path: Optional[str] = None  # npz, overwritten per chunk
    guard: bool = True  # NaN + energy-jump detection per chunk
    log: bool = True


def run_dense_simulation(
    state,
    rollout: Callable,
    energy: Callable,
    config: RunnerConfig,
    num_atoms: int,
    names=None,
    rebin_every: int = 10,
    gather_fn: Optional[Callable] = None,
    rng: Optional[torch.Generator] = None,
):
    """Drive a dense-cell simulation for config.total_steps.

    rollout/energy are the closures from make_cell_dense_sim (or
    make_molecular_dense_sim, dense_sim_from_system); gather_fn(state, n) →
    (positions, velocities) for dumps.  rng: the generator a thermostatted
    rollout draws from, handed to every chunk and saved with each
    checkpoint (`load_state(..., rng=)` restores it for a bitwise resume).
    Returns (final_state, history list of per-chunk observable dicts).

    Under a profiler each chunk's parts run in spans that carry the chunk's
    index: `emdee.runner.rollout`, `.energy` (the energy pass's enqueue),
    `.wait` (the host reads, where the host waits for the device), `.guard`,
    `.dump` and `.checkpoint`.
    """
    from emdee_tpu_torch.neighbors.cell_dense import gather_dense_atoms

    gather_fn = gather_fn or gather_dense_atoms
    writer = None
    if config.trajectory_path:
        from emdee_tpu_torch.io.xyz import XYZTrajectoryWriter

        writer = XYZTrajectoryWriter(
            config.trajectory_path, names if names is not None else ["X"] * num_atoms
        )

    chunk_kw = {} if rng is None else {"rng": rng}
    meter = ThroughputMeter(num_atoms)
    meter.start()
    history = []
    prev_total = None
    done = chunk = 0
    try:
        while done < config.total_steps:
            n_steps = min(config.chunk_steps, config.total_steps - done)
            tag = str(chunk)
            with span("emdee.runner.rollout", tag):
                state = rollout(state, num_steps=n_steps, rebin_every=rebin_every, **chunk_kw)
            done += n_steps

            with span("emdee.runner.energy", tag):
                energies = energy(state)
            with span("emdee.runner.wait", tag):
                pe, vir, ke = (float(x) for x in energies)
                stats = meter.update(n_steps, sync=state.positions) if config.log else {}
                step = int(state.step)
            record = {
                "step": step,
                "potential": pe,
                "kinetic": ke,
                "virial": vir,
                "total": pe + ke,
                **stats,
            }
            history.append(record)

            if config.guard:
                with span("emdee.runner.guard", tag):
                    if bool(state.overflow):
                        raise RuntimeError(
                            "capacity/staleness overflow flag tripped — rerun with "
                            "larger capacity or smaller rebin_every"
                        )
                    check_finite((pe, ke), where="energies")
                    prev_total = guard_energy(prev_total, pe + ke)

            if writer is not None:
                with span("emdee.runner.dump", tag):
                    pos, _ = gather_fn(state, num_atoms)
                    writer.write_frame(pos, comment=f"step {step}")
            if config.checkpoint_path:
                from emdee_tpu_torch.utils.checkpoint import save_state

                with span("emdee.runner.checkpoint", tag):
                    save_state(config.checkpoint_path, state, rng=rng, step=step)
            chunk += 1
    finally:
        if writer is not None:
            writer.close()
    return state, history
