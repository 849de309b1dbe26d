"""Scatter-add in a fixed order, without float atomics (port-only).

`index_add_` and `index_put_(accumulate=True)` use float atomics on CUDA,
so the order in which rows meet in a target, and with it the last bits of
the sum, changes from run to run.  The engine's contract is bitwise
reproducible reruns (tests/test_fidelity.py:34), so every scatter-add on a
rollout path goes through this module instead.

`add_plan(target, num_targets)` is built once per binding (the targets
change only at a rebin): a stable argsort of the (R,) target index, each
sorted row's rank inside its target, and the row that closes each target's
segment.  `fixed_add(base, plan, values)` gathers the rows in that order,
sums every segment by a segmented inclusive scan of ⌈log₂ R⌉ doubling steps
(row k adds the partial sum 2^s rows back while its rank allows), and
writes each segment's total, plus the base row, into its target with one
`index_put_`: the targets of the closing rows are unique, and every other
row writes into a dump row that is cut off.  Shapes are static and nothing
waits for the device; the sum of a target is a fixed pairwise tree over its
rows in their original order, the same on every run and device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class AddPlan(NamedTuple):
    order: torch.Tensor  # (R,) int64: rows stably sorted by target
    dest: torch.Tensor  # (R,) int64: a segment's closing row → its target, others → num_targets
    masks: Tuple[torch.Tensor, ...]  # doubling step s = 2^i: (R − s,) bool, rank ≥ s


def add_plan(target: torch.Tensor, num_targets: int) -> AddPlan:
    """The plan of a fixed-order scatter-add of R rows into `num_targets`
    rows; target: (R,) integer tensor with values in [0, num_targets)."""
    t = target.reshape(-1).to(torch.int64)
    r = t.numel()
    if r == 0:
        return AddPlan(order=t, dest=t, masks=())
    order = torch.argsort(t, stable=True)
    ts = t[order]
    idx = torch.arange(r, device=t.device)
    change = ts[1:] != ts[:-1]
    yes = torch.ones(1, dtype=torch.bool, device=t.device)
    start = torch.cat([yes, change])
    closes = torch.cat([change, yes])
    rank = idx - torch.cummax(torch.where(start, idx, 0), dim=0).values
    masks = []
    s = 1
    while s < r:
        masks.append(rank[s:] >= s)
        s *= 2
    return AddPlan(order=order, dest=torch.where(closes, ts, num_targets), masks=tuple(masks))


def fixed_add(base: torch.Tensor, plan: AddPlan, values: torch.Tensor) -> torch.Tensor:
    """base + the rows of `values` (R, …) summed into their targets, in the
    plan's fixed order; base: (num_targets, …).  Returns a new tensor."""
    v = values[plan.order]
    s = 1
    for mask in plan.masks:
        m = mask.reshape(mask.shape + (1,) * (v.dim() - 1))
        v = torch.cat([v[:s], v[s:] + torch.where(m, v[:-s], 0.0)])
        s *= 2
    out = torch.cat([base, base.new_zeros((1,) + tuple(base.shape[1:]))])
    out = out.index_put((plan.dest,), out[plan.dest] + v)
    return out[:-1]
