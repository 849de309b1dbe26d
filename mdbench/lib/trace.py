"""Reading one `torch.profiler` window: the device's operations by name and
layer, the host spans the harness put around its calls into the program, and
the device's idle gaps labelled by what the host was doing."""

from __future__ import annotations

import bisect
import json
import re
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

import torch

SPAN_PREFIX = "mdbench."
UNMATCHED = "integrate"  # kernels no layer file claims: the rollout's eager ops
GAP_MIN_US = 2.0  # idle stretches shorter than this are launch jitter, not gaps
LABEL_SCAN = 64  # host ops looked back through to label a gap


def load_layers(folder: Path) -> list:
    """[(layer, compiled kernel pattern, compiled pass pattern or None)] from
    every `<layer>.<part>.json` in `folder`, in file-name order: a kernel
    whose name the pattern finds belongs to the layer, and a kernel that the
    pass pattern finds starts one pass of the layer's work."""
    rules = []
    for path in sorted(folder.glob("*.json")):
        spec = json.loads(path.read_text())
        kern = re.compile("|".join(spec["kernels"]))
        passes = re.compile("|".join(spec["pass"])) if spec.get("pass") else None
        rules.append((spec["layer"], kern, passes))
    return rules


@dataclass
class Trace:
    window_s: float
    steps: int
    ops: list  # (start us, end us, name, layer, starts a pass)
    spans: list  # (start us, end us, name) of the harness's spans
    host_ops: list = field(default_factory=list)  # (start us, end us, name) of the program's host ops

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union)."""
        busy, edge = 0.0, float("-inf")
        for s, e, *_ in self.ops:
            if e > edge:
                busy += e - max(s, edge)
                edge = e
        return busy / 1e6

    def layer_us(self, layer: str) -> float:
        return sum(e - s for s, e, _, lay, _ in self.ops if lay == layer)

    def layer_passes(self, layer: str) -> int:
        return sum(1 for *_, lay, p in self.ops if lay == layer and p)

    def boundary_gaps_us(self, span: str = SPAN_PREFIX + "rollout") -> list:
        """Device idle time at each chunk boundary: from the end of the last
        operation that started before the host entered a chunk's rollout to
        the start of the first that started after it (the first chunk's
        entry, which opens the window, is no boundary)."""
        starts = [s for s, _, _, _, _ in self.ops]
        gaps = []
        for t in sorted(s for s, _, n in self.spans if n == span)[1:]:
            i = bisect.bisect_left(starts, t)
            if 0 < i < len(self.ops):
                before = max(e for _, e, *_ in self.ops[max(0, i - LABEL_SCAN):i])
                gaps.append(max(0.0, self.ops[i][0] - before))
        return gaps

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing, ten of each, in seconds."""
        by_op = Counter()
        for s, e, name, _, _ in self.ops:
            by_op[name[:120]] += e - s
        idle = Counter()
        edge = self.ops[0][1] if self.ops else 0.0
        span_starts = [s for s, _, _ in self.spans]
        op_starts = [s for s, _, _ in self.host_ops]
        for s, e, *_ in self.ops[1:]:
            if s - edge >= GAP_MIN_US:
                idle[self._label(0.5 * (edge + s), span_starts, op_starts)] += s - edge
            edge = max(edge, e)
        return {"device_ops": [[k, v / 1e6] for k, v in by_op.most_common(10)],
                "idle_gaps": [[k, v / 1e6] for k, v in idle.most_common(10)]}

    def _label(self, t: float, span_starts: list, op_starts: list) -> str:
        def inner(events, starts):
            i = bisect.bisect_right(starts, t)
            for j in range(i - 1, max(-1, i - 1 - LABEL_SCAN), -1):
                if events[j][1] >= t:
                    return events[j][2]
            return None

        span = inner(self.spans, span_starts) or "runner"
        op = inner(self.host_ops, op_starts) or "python"
        return f"{span.removeprefix(SPAN_PREFIX)}: {op}"


def read(prof, layers: list, window_s: float, steps: int) -> Trace:
    """The Trace of a finished `torch.profiler.profile`, from its raw events
    (times in us from the trace's start); the device side of the harness's
    own spans is left out."""
    results = prof.profiler.kineto_results
    base = results.trace_start_ns()
    ops, spans, host, claimed = [], [], [], {}
    for e in results.events():
        name = e.name()
        start, end = (e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(SPAN_PREFIX):
                continue
            if name not in claimed:
                claimed[name] = next(((lay, bool(passes and passes.search(name)))
                                      for lay, kern, passes in layers if kern.search(name)), (UNMATCHED, False))
            ops.append((start, end, name, *claimed[name]))
        elif name.startswith(SPAN_PREFIX):
            spans.append((start, end, name))
        else:
            host.append((start, end, name))
    ops.sort()
    spans.sort()
    host.sort()
    return Trace(window_s=window_s, steps=steps, ops=ops, spans=spans, host_ops=host)
