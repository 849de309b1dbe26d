"""Observability: progress logging, throughput counters, NaN guards,
profiler hooks and the program's named spans (counterpart of
emdee_tpu/utils/observability.py) — the operational subsystems the
reference lacks entirely (SURVEY.md §5: no tracing, no metrics, no failure
detection)."""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from typing import Any, Iterator, Optional

import numpy as np
import torch

from emdee_tpu_torch.utils.checkpoint import leaves_with_paths

logger = logging.getLogger("emdee_tpu_torch")


class ThroughputMeter:
    """Steps/sec and atom-steps/sec over rollout chunks."""

    def __init__(self, num_atoms: int):
        self.num_atoms = num_atoms
        self._t0: Optional[float] = None
        self._steps = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def update(self, steps: int, sync: Any = None) -> dict:
        """Count `steps` more; `sync`, a tensor the chunk produced: on a CUDA
        tensor the clock waits for its device to finish the queued work."""
        if isinstance(sync, torch.Tensor) and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        self._steps += steps
        elapsed = time.perf_counter() - self._t0
        stats = {
            "steps": self._steps,
            "elapsed_s": elapsed,
            "steps_per_s": self._steps / elapsed,
            "atom_steps_per_s": self._steps * self.num_atoms / elapsed,
        }
        logger.info(
            "%d steps | %.1f steps/s | %.3g atom-steps/s",
            stats["steps"], stats["steps_per_s"], stats["atom_steps_per_s"],
        )
        return stats


def check_finite(tree: Any, where: str = "state") -> None:
    """Host-side NaN/Inf guard over a nest of NamedTuples, tuples, lists and
    dicts — raise loudly, naming the leaf by its field path, instead of
    letting a blown-up trajectory keep burning chip time."""
    for path, leaf in leaves_with_paths(tree):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            raise FloatingPointError(
                f"non-finite values in {where}{path} "
                f"(NaNs: {np.isnan(arr).sum()}, Infs: {np.isinf(arr).sum()})"
            )


def guard_energy(previous: Optional[float], current: float, rel_jump: float = 0.5):
    """Failure detection for long rollouts: flag sudden energy jumps."""
    if previous is not None and abs(current - previous) > rel_jump * max(
        abs(previous), 1e-12
    ):
        raise FloatingPointError(
            f"energy jumped {previous:.6g} → {current:.6g}: likely unstable "
            "timestep or stale neighbor state"
        )
    return current


_NO_SPAN = contextlib.nullcontext()


def span(name: str, args: Optional[str] = None):
    """A named host span around a block of the program (`emdee.<part>`):
    while a profiler records (`torch.profiler`, `profile_trace`, or
    `torch.autograd.profiler.emit_nvtx` under nsys), a
    `torch.profiler.record_function(name, args)`, which lands in the same
    trace as the device's kernels; otherwise one shared `nullcontext`, since
    a `record_function` costs microseconds even with no profiler running.
    A span reads no device value and waits for nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name, args)
    return _NO_SPAN


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """`torch.profiler` trace (CPU, and CUDA when a card is present) around a
    code block, written as a Chrome trace to `log_dir`/trace.json (default:
    `emdee_trace` in the temporary directory); view it in Perfetto or
    chrome://tracing.  Yields the profiler, whose `key_averages()` sums the
    kernels by name."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "emdee_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)
