"""One-time set-up of the vector math behind the port's transcendental
functions on the CPU.

PyTorch's CPU kernels for erfc, exp and the other transcendental functions
hand each intra-op thread's chunk of a tensor to MKL's vector math library
(VML).  When the first VML call of a process comes from several threads at
once, a thread's chunk can be computed at another accuracy (about 1e-4
relative in exp, ulps in erfc), so two runs of the same rollout differ in
a few bits: the DSF pass (`potentials/coulomb.py` `coulomb_interaction`)
of the dry run's part 4 did, now and then, on a `LocalMesh` (ROADMAP F2).
Once one thread alone has made a VML call, of any function, every later
call computes the same bits.  `ready` makes that call, once a process; the
plain versions that use these functions call it before their first one."""

from __future__ import annotations

import torch

_READY = False


def ready(like: torch.Tensor) -> None:
    """One VML call from this thread, on a tensor too small for PyTorch to
    split between threads, if `like` lies on the CPU and this process has
    not made it yet."""
    global _READY
    if _READY or like.device.type != "cpu":
        return
    torch.exp(torch.zeros(8))
    _READY = True
