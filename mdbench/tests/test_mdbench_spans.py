"""Device time by the program span that launched it (`lib/spans.py`): on
hand-built traces, and (`gpu`) on `lj1m-nve-sort` at its own size."""

import contextlib
import io
import json

import pytest

from mdbench.lib import spans
from mdbench.lib.trace import Trace

STEPS = 2


def _trace(extra_launch=False, program=True, lost=0):
    """A chunk of two steps whose device runs behind the host: each kernel
    starts after the host has left the span that launched it; `lost`: the
    device records of the first launches missing."""
    host = [
        (0.0, 100.0, "emdee.runner.rollout"),
        (1.0, 20.0, "emdee.rebin"), (2.0, 5.0, "cudaLaunchKernel"), (6.0, 9.0, "cudaMemsetAsync"),
        (21.0, 40.0, "emdee.force"), (22.0, 30.0, "cuLaunchKernel"),
        (41.0, 60.0, "emdee.integrate"), (42.0, 44.0, "cudaLaunchKernel"), (45.0, 47.0, "aten::add"),
        (61.0, 80.0, "emdee.force"), (62.0, 64.0, "cudaLaunchCooperativeKernel"),
        (81.0, 99.0, "emdee.integrate"), (82.0, 84.0, "cudaLaunchKernel"),
        (101.0, 104.0, "emdee.runner.energy"), (102.0, 103.0, "cudaLaunchKernel"),
        (105.0, 300.0, "emdee.runner.wait"), (106.0, 299.0, "cudaMemcpyAsync"),
        (301.0, 302.5, "emdee.runner.guard"),
    ]
    if extra_launch:
        host.append((85.0, 86.0, "cudaLaunchKernel"))
    if not program:
        host = [h for h in host if not h[2].startswith(spans.PROGRAM)]
    ops = [(30.0, 40.0, "sort"), (40.0, 41.0, "Memset (Device)"), (41.0, 141.0, "force"), (141.0, 146.0, "add"),
           (146.0, 246.0, "force_coop"), (246.0, 251.0, "kick"), (251.0, 280.0, "energy"),
           (280.0, 281.0, "Memcpy DtoH (Device -> Pinned)")]
    ops = [(s, e, name, "integrate", False) for s, e, name in ops[lost:]]
    return Trace(window_s=3e-4, steps=STEPS, ops=ops, spans=[], host_ops=sorted(host))


def test_a_kernel_is_put_in_the_span_around_its_launch():
    rows = spans.attribute(_trace())
    assert [inner for _, inner, _ in rows] == [
        "emdee.rebin", "emdee.rebin", "emdee.force", "emdee.integrate", "emdee.force", "emdee.integrate",
        "emdee.runner.energy", "emdee.runner.wait"]
    assert [outer for _, _, outer in rows][:6] == ["emdee.runner.rollout"] * 6
    assert spans.span_us_per_step(_trace(), ("emdee.rebin",)) == 11.0 / STEPS
    assert spans.span_us_per_step(_trace(), ("emdee.force",)) == 200.0 / STEPS
    assert spans.span_us_per_step(_trace(), ("emdee.integrate", "emdee.thermostat")) == 10.0 / STEPS
    assert spans.in_rollouts_us(_trace()) == (221.0, 221.0)


def test_host_time_in_the_runner_spans():
    # The rollout's 100 us less its CUDA calls' 3 + 3 + 8 + 2 + 2 + 2.
    assert spans.host_dispatch_us_per_step(_trace()) == (100.0 - 20.0) / STEPS
    assert spans.runner_host_ms_per_chunk(_trace()) == pytest.approx((3.0 + 1.5) / 1e3)


def test_device_records_lost_at_the_start_are_matched_from_the_end():
    rows = spans.attribute(_trace(lost=1))
    assert [inner for _, inner, _ in rows][:3] == ["emdee.rebin", "emdee.force", "emdee.integrate"]
    assert spans.span_us_per_step(_trace(lost=1), ("emdee.rebin",)) == 1.0 / STEPS


@pytest.mark.parametrize("kind", ["a launch with no operation inside the window", "no program spans"])
def test_nothing_is_read_where_nothing_can_be_attributed(kind):
    tr = _trace(extra_launch=True) if kind.startswith("a launch") else _trace(program=False)
    assert spans.attribute(tr) is None and spans.span_us_per_step(tr, ("emdee.force",)) is None
    if kind == "no program spans":
        assert spans.host_dispatch_us_per_step(tr) is None and spans.runner_host_ms_per_chunk(tr) is None


@pytest.mark.gpu
def test_the_cell_reports_device_time_by_span(card):
    """`lj1m-nve-sort` at `--trace 1`: the five span metrics are in the
    line, and one traced chunk's device operations launched inside the
    runner's rollout spans lie in the rollout's leaf spans for at least 99%
    of their time."""
    from mdbench import run
    from mdbench.lib import trace as tracing

    seed = 2800000101
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", "lj1m-nve-sort", "--seed", str(seed), "--seconds", "10", "--trace", "1"])
    assert rc == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    names = ("rebin_span_us_per_step", "integrate_span_us_per_step", "force_span_us_per_step",
             "host_dispatch_us_per_step", "runner_host_ms_per_chunk")
    assert set(names) <= set(result["metrics"]), result["metrics"]
    print(json.dumps(result))

    spec = run.CellSpec(run.ROOT, "lj1m-nve-sort")
    device = run.pick_device(spec, True)
    sim, state, _ = run.set_up(spec, seed + 1, device)
    state, record, seconds, prof = run.traced_window(sim, state, spec.traffic["chunk_steps"], 1, device)
    tr = tracing.read(prof, tracing.load_layers(spec.data / "layers"), seconds, record["steps"])
    total, leaves = spans.in_rollouts_us(tr)
    print(json.dumps({"rollout_us": total, "leaf_us": leaves, "busy_us": tr.busy_s * 1e6}))
    assert leaves >= 0.99 * total > 0
