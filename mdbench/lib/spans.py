"""The program's own spans in one traced window: `emdee.*` host spans
(`emdee_tpu_torch.utils.observability.span`), which `lib/trace.py` keeps
among the host ops.  Each device operation is put in the innermost program
span around the host call that enqueued it.  The `Trace` keeps no Kineto
correlation ids, so the two are matched by launch order: on the one stream
the program uses, the k-th operation the device ran is the one the k-th
enqueuing CUDA API call put in the queue.  A profiler run that is not its
process's first can miss the device records of its first few launches, so
the two lists are matched from their ends, and only where every pair agrees
in kind (kernel, fill or copy); a window where they do not is not
attributed.  On a trace with no program spans, as the program had
before them, every reading is None."""

from __future__ import annotations

import re
from collections import Counter

PROGRAM = "emdee."
RUNNER = PROGRAM + "runner."
ROLLOUT = RUNNER + "rollout"
WAIT = RUNNER + "wait"
# Host calls that put one operation in a stream's queue: kernel launches
# (`cudaLaunch*`, `cuLaunch*`, cooperative), copies and fills.
ENQUEUE = re.compile(r"^(cudaLaunch|cuLaunch|cudaMemcpy|cuMemcpy|cudaMemset|cuMemset)")
CUDA_CALL = re.compile(r"^cu(da)?[A-Z]")  # any CUDA API call: `cuda*` or `cu*`


def program_spans(trace) -> list:
    """(start us, end us, name) of the program's host spans, by start."""
    return sorted((h for h in trace.host_ops if h[2].startswith(PROGRAM)), key=lambda h: (h[0], -h[1]))


def enclosing(spans: list, times: list) -> list:
    """For each time of `times` (ascending), (innermost, outermost) name of
    the program spans open at it, or (None, None); spans nest, as the
    program opens them on one thread."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append((stack[-1][2], stack[0][2]) if stack else (None, None))
    return out


def _kind(name: str, launch: bool) -> str:
    """'fill', 'copy' or 'kernel': of an enqueuing call, or of the device
    operation it put in the queue ('Memset (Device)', 'Memcpy DtoH ...')."""
    low = name.lower()
    for kind, word in (("fill", "memset"), ("copy", "memcpy")):
        if (word in low) if launch else low.startswith(word):
            return kind
    return "kernel"


def attribute(trace):
    """[(device us, innermost span, outermost span)] of every device
    operation of the window, or None where the trace holds no program span
    or the enqueuing calls do not match the operations."""
    spans = program_spans(trace)
    if not spans or not trace.ops:
        return None
    launches = [h for h in trace.host_ops if ENQUEUE.match(h[2])]
    launches = launches[len(launches) - len(trace.ops):] if len(launches) >= len(trace.ops) else []
    if not launches or any(_kind(op[2], False) != _kind(h[2], True) for op, h in zip(trace.ops, launches)):
        return None
    where = enclosing(spans, [s for s, _, _ in launches])
    return [(e - s, inner, outer) for (s, e, *_), (inner, outer) in zip(trace.ops, where)]


def device_us(trace) -> Counter:
    """Device time by the innermost program span that launched it (None:
    launched outside every program span)."""
    rows = attribute(trace)
    total = Counter()
    for us, inner, _ in rows or ():
        total[inner] += us
    return total


def in_rollouts_us(trace):
    """(device us launched inside the runner's rollout spans, of which
    inside a leaf span of the rollout), or None where unattributed."""
    rows = attribute(trace)
    if rows is None:
        return None
    inside = [(us, inner) for us, inner, outer in rows if outer == ROLLOUT]
    return sum(us for us, _ in inside), sum(us for us, inner in inside if inner not in (None, ROLLOUT))


def span_us_per_step(trace, names: tuple):
    """Device time a step of the operations launched inside the spans
    `names`, or None where nothing was attributed there."""
    if trace is None or trace.steps <= 0:
        return None
    us = sum(device_us(trace)[name] for name in names)
    return us / trace.steps if us > 0 else None


def host_dispatch_us_per_step(trace):
    """Host wall time a step inside the runner's rollout spans, less the
    time inside CUDA API calls (where a full launch queue
    blocks the host); None where the device ran nothing."""
    if trace is None or trace.steps <= 0 or not trace.ops:
        return None
    rollouts = [s for s in program_spans(trace) if s[2] == ROLLOUT]
    if not rollouts:
        return None
    calls = [(s, e) for s, e, name in trace.host_ops if CUDA_CALL.match(name)]
    total = 0.0
    for s0, e0, _ in rollouts:
        total += (e0 - s0) - sum(min(e, e0) - max(s, s0) for s, e in calls if s < e0 and e > s0)
    return total / trace.steps


def runner_host_ms_per_chunk(trace):
    """Host wall time a chunk in the runner's spans other than the rollout
    and the wait for the device: the energy pass's enqueue, the guards,
    dumps and checkpoints; None where the device ran nothing."""
    if trace is None or not trace.ops:
        return None
    spans = [s for s in program_spans(trace) if s[2].startswith(RUNNER)]
    chunks = sum(1 for s in spans if s[2] == ROLLOUT)
    if not chunks:
        return None
    return sum(e - s for s, e, name in spans if name not in (ROLLOUT, WAIT)) / chunks / 1e3
