"""The benchmark of emdee_tpu_torch: one cell of BENCHMARK.json a run.

    python3 mdbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the CUDA cards the cell asks
for.  Everything a cell is made of is found by name: its configuration
(`configs/`, with the system adapter it names under `systems/`), its traffic
(`traffic/<name>.json`), the limits of its correctness numbers
(`limits/<cell>.json`), the kernel name patterns of each layer (`layers/`),
and one reader a metric (`metrics/<metric>.py`).  A cell, a mix or a metric
is added by adding files and BENCHMARK.json entries.

A run: set-up (the system's inputs from the seed, the program's state and
closures, the equilibration, a warm-up through the runner), then the window:
`run_dense_simulation` in whole chunks until S seconds have passed (with
--trace 1: a fixed number of chunks under `torch.profiler`), then the check
that decides `correct` (`lib/checks.py`), and the result as the last line of
standard output.  No card, or fewer than the cell asks for, or JAX or the JAX
package loaded by the end: no result, and a nonzero exit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
FORBIDDEN = ("jax", "jaxlib", "flax", "emdee_tpu")  # top-level module names, compared whole


def _process_age() -> float:
    """Seconds since this process started (its start time in /proc), or 0
    where that cannot be read."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()


class WindowClosed(Exception):
    """Raised by the window's rollout wrapper, at a chunk's start, once the
    window's seconds have passed: it ends the runner's loop between chunks."""


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _load(path: Path) -> dict:
    return json.loads(path.read_text())


def _reader(folder: Path, name: str):
    spec = importlib.util.spec_from_file_location(f"mdbench_metric_{name}", folder / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Ctx:
    """What a metric reader may read."""

    def __init__(self, setup, window=None, trace=None, work=None, peaks=None):
        self.setup, self.window, self.trace, self.work, self.peaks = setup, window, trace, work, peaks


def _wrap(sim, record, deadline=None):
    """The closures handed to the runner: the program's, inside a host span
    each; the energy wrapper keeps the last outputs and each chunk's, with
    the steps done before them; with a deadline, the
    rollout wrapper ends the window at the first chunk that starts after it."""
    import torch

    def rollout(state, **kw):
        if deadline is not None and time.perf_counter() >= deadline:
            record["state"] = state
            raise WindowClosed
        with torch.profiler.record_function("mdbench.rollout"):
            out = sim.rollout(state, **kw)
        record["chunks"] = record.get("chunks", 0) + 1
        record["steps"] = record.get("steps", 0) + kw["num_steps"]
        return out

    def energy(state):
        with torch.profiler.record_function("mdbench.energy"):
            out = sim.energy(state)
        record["energy"] = out
        record.setdefault("energies", []).append((record.get("steps", 0), out))
        return out

    return rollout, energy


def _runner(sim, state, rollout, energy, steps: int, chunk: int):
    from emdee_tpu_torch.utils.runner import RunnerConfig, run_dense_simulation

    config = RunnerConfig(total_steps=steps, chunk_steps=chunk, guard=True)
    return run_dense_simulation(state, rollout, energy, config, sim.num_atoms, rebin_every=sim.rebin_every,
                                rng=sim.rng)[0]


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CellSpec:
    """A cell of BENCHMARK.json with the files it names."""

    def __init__(self, root: Path, name: str):
        self.data = root / "mdbench"
        self.bench = _load(root / "BENCHMARK.json")
        self.cell = next((w for w in self.bench["workloads"] if w["name"] == name), None)
        if self.cell is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        entry = next(c for c in self.bench["configs"] if c["name"] == self.cell["config"])
        self.cfg = _load(root / entry["file"])
        self.traffic = _load(self.data / "traffic" / f"{self.cell['traffic']}.json")
        self.limits = _load(self.data / "limits" / f"{name}.json")["limits"]


def pick_device(spec: CellSpec, require_chip: bool):
    """The card, or None where the cell's cards are missing; the CPU where
    no chip is required."""
    import torch

    if not require_chip:
        return torch.device("cpu")
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.cell["chips"]:
        return None
    caches = ROOT / "build" / "mdbench"  # fixed paths inside the checkout: only a first run builds
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(caches / sub)
    return torch.device("cuda", 0)


def set_up(spec: CellSpec, seed: int, device):
    """(sim, the state the window starts from, set-up seconds by part): the
    system's build, then one rebin block through the runner as warm-up."""
    from mdbench.lib.sim import Clock

    system = importlib.import_module(f"mdbench.systems.{spec.cfg['system']}")
    clock = Clock(device)
    sim = system.build(spec.cfg, spec.traffic, seed, device, clock)
    state = _runner(sim, sim.state, sim.rollout, sim.energy, sim.rebin_every, sim.rebin_every)
    sim.state = None
    clock.mark("equil")
    return sim, state, dict(clock.parts, total=time.perf_counter() - T_START)


def timed_window(sim, state, chunk: int, seconds: float, device):
    """Whole chunks through the runner until `seconds` have passed:
    (end state, record of the wrappers, wall seconds)."""
    record = {}
    t0 = time.perf_counter()
    rollout, energy = _wrap(sim, record, deadline=t0 + seconds)
    try:
        _runner(sim, state, rollout, energy, 1 << 40, chunk)
    except WindowClosed:
        state = record["state"]
    _sync(device)
    return state, record, time.perf_counter() - t0


def traced_window(sim, state, chunk: int, chunks: int, device):
    """`chunks` chunks through the runner under `torch.profiler`:
    (end state, record, wall seconds, the profiler)."""
    import torch

    record = {}
    rollout, energy = _wrap(sim, record)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state = _runner(sim, state, rollout, energy, chunks * chunk, chunk)
        _sync(device)
        seconds = time.perf_counter() - t0
    return state, record, seconds, prof


def outputs(sim, state, record, steps: int) -> dict:
    """What the window produced, read for the check: its end state in atom
    order, the runner's last energy pass, the cell faults, and the
    velocities after `steps` more steps through the runner from the end
    state, with the thermostat generator's state before them."""
    from mdbench.lib import checks

    out = {"gen_state": sim.rng.get_state() if sim.rng is not None else None}
    out["pe"], out["vir"], _ = (float(x) for x in record["energy"])
    out["pos"], out["vel"] = checks.gather(state, sim.num_atoms)
    out["cell_faults"] = checks.cell_faults(state, sim.geometry, sim.num_atoms)
    stretch = _runner(sim, state, sim.rollout, sim.energy, steps, steps)
    out["stretch_vel"] = checks.gather(stretch, sim.num_atoms)[1]
    return out


def free_program(sim, device) -> None:
    """Drop the program's closures (and with them its tables) before the
    reference runs."""
    import torch

    sim.rollout = sim.energy = None
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None, *, require_chip: bool = True, root=None) -> int:
    """Run one cell; return the exit code.  root: the checkout whose
    BENCHMARK.json and mdbench/ data files (configs, traffic, limits, layers,
    metrics) the run reads, by default this one; require_chip=False lets a
    test run a cell on the CPU, where the program runs its plain versions."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    try:
        spec = CellSpec(Path(root) if root is not None else ROOT, args.workload)
    except KeyError as err:
        print(err, file=sys.stderr)
        return 2
    device = pick_device(spec, require_chip)
    if device is None:
        print(f"{args.workload} needs {spec.cell['chips']} CUDA card(s); none or fewer found", file=sys.stderr)
        return 2

    import torch

    from mdbench.lib import checks, trace as tracing

    sim, state, setup = set_up(spec, args.seed, device)
    chunk, failed, prof, window, work = spec.traffic["chunk_steps"], 0, None, None, None
    try:
        if args.trace:
            state, record, seconds, prof = traced_window(sim, state, chunk, spec.traffic["trace_chunks"], device)
        else:
            state, record, seconds = timed_window(sim, state, chunk, args.seconds, device)
        window = {"atoms": sim.num_atoms, "steps": record.get("steps", 0), "seconds": seconds}
    except (RuntimeError, FloatingPointError) as err:  # the runner's guards
        print(f"window failed: {err}", file=sys.stderr)
        failed, record = 1, {}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    numbers = {}
    if not failed:
        out = outputs(sim, state, record, spec.traffic["check_steps"])
        if args.trace:
            work = importlib.import_module(f"mdbench.work.{sim.work['force']}").work(sim, out["pos"])
        state = None
        free_program(sim, device)
        ref = checks.Reference(sim, out["pos"], out["vel"], spec.traffic["check_steps"], out["gen_state"])
        numbers = checks.program_numbers(ref, out, record)
        correct, rows = checks.verdict(numbers, spec.limits)
    else:
        correct, rows = False, [("window", 1.0, 0.0)]

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    trace = None
    if prof is not None:
        trace = tracing.read(prof, tracing.load_layers(spec.data / "layers"), window["seconds"], window["steps"])
    ctx = Ctx(setup, window, trace, work, _load(spec.data / "work" / "peaks.json").get(kind))
    metrics = {}
    for m in (spec.bench["per_layer"] if args.trace else spec.bench["end_to_end"]):
        if _applies(m, spec.cell["name"]):
            value = _reader(spec.data / "metrics", m["name"])(ctx)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind, "count": spec.cell["chips"],
           "memory_peak_bytes": peak, "cards_present": cards,
           "power_limit_w": _power_limit() if device.type == "cuda" else None}
    result = {"correct": bool(correct), "attempted": record.get("chunks", 0) + failed, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace is not None:
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = trace.breakdown()
    info = {k: v for k, v in numbers.items() if k not in spec.limits}
    info.update(sim.geometry, atoms=sim.num_atoms, rebin_every=sim.rebin_every, steps=record.get("steps", 0),
                setup=setup)
    print(f"not compared: {json.dumps(info)}", file=sys.stderr)
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    print(f"correct: {bool(correct)}", file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr, flush=True)
    found = forbidden_modules()  # last: the metric readers and the trace's reading have run
    if found:
        print(f"modules that the benchmark must not load are loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
