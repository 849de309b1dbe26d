"""A run with the timed path broken underneath has to come out not
correct: once for each fault a cell of one card can have.  Once set-up is
done, the program's plain force pass (what it runs on the CPU) or its
rollout closure is wrapped so that a step returns its state unchanged, the force pass leaves
out half the atoms and doubles the rest, or one atom's force is altered
where it is produced (the largest, its sign flipped).  (A cell of one card has no exchange between chips to
leave out.)  The chip check is skipped; the rest of a run is the
benchmark's own."""

import mdbench_tiny
import pytest
import torch

from emdee_tpu_torch.neighbors import cell_kernel
from mdbench import run


def _unchanged(monkeypatch, sim):
    sim.rollout = lambda state, *a, **k: state


def _force_fault(monkeypatch, alter):
    real = cell_kernel.cell_forces

    def forces(state, *args, **kw):
        f, e, w = real(state, *args, **kw)
        return alter(f, state), e, w

    monkeypatch.setattr(cell_kernel, "cell_forces", forces)


def _half(monkeypatch, sim):
    def alter(f, state):
        keep = (torch.arange(f.shape[0], device=f.device) % 2 == 0)[:, None, None]
        return torch.where(keep, 2.0 * f, torch.zeros_like(f))

    _force_fault(monkeypatch, alter)


def _altered(monkeypatch, sim):
    def alter(f, state):
        f = f.clone().reshape(-1, 3)
        worst = f.norm(dim=-1).argmax()
        f[worst] = -f[worst]
        return f.reshape(state.positions.shape)

    _force_fault(monkeypatch, alter)


@pytest.mark.parametrize("cell", sorted(mdbench_tiny.TINY))
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    real = run.set_up

    def set_up(*args, **kw):  # the fault comes in after set-up, under the timed path
        sim, state, setup = real(*args, **kw)
        fault(monkeypatch, sim)
        return sim, state, setup

    monkeypatch.setattr(run, "set_up", set_up)
    rc, result, err = mdbench_tiny.run(tiny_root, cell)
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]
    assert "correct: False" in err.strip().splitlines()[-6:]
