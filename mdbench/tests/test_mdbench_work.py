"""The frozen work counts, checked by hand on a small state."""

import math

import pytest
import torch

from mdbench.reference.cells import count_pairs
from mdbench.work import counts


def _atoms(points, box):
    return torch.tensor(points, dtype=torch.float64), box


def test_pairs_counted_by_hand():
    # A box of 10 (four cells of 2.5 a side): a pair at 1.0, a pair across the
    # periodic face at 0.5, a pair at exactly the cutoff (out), a lone atom.
    pos, box = _atoms([[1, 1, 1], [2, 1, 1], [9.8, 5, 5], [0.3, 5, 5], [5, 8, 2], [7.5, 8, 2], [5, 5, 8]], 10.0)
    assert count_pairs(pos, box, 2.5) == 2
    assert count_pairs(pos, box, 2.6) == 3


def test_lj_force_pass_by_hand():
    ops, nbytes = counts.lj_force_pass(pairs=2, atoms=7)
    assert ops == 2 * 51  # 51 operations a pair inside the cutoff
    assert nbytes == 7 * (12 + 1 + 12)  # positions and a valid flag in, forces out


def test_molecular_force_pass_by_hand():
    # 3 pairs, 1 bonded, 2 exclusion tags and 2 bond tags an atom, 3 atoms
    ops, nbytes = counts.molecular_force_pass(pairs=3, bonded_pairs=1, e_tags=2, e_bonds=2, atoms=3)
    assert ops == 3 * (51 + 3 + 47 + 3 * 2) + 4
    assert nbytes == 3 * (12 + 8 + 1 + 4 + 4 + 12 * 2 + 8 * 2 + 12)


def test_rebin_bytes_by_hand():
    assert counts.rebin(fields=7, atoms=1000) == 7 * 4 * 2 * 1000


def test_roofline_share_by_hand(tmp_path):
    """A share is the least time over the measured time, never above 100%:
    10 passes of 51e9 operations at 67e12 a second take at least 7.61 ms."""
    from mdbench.lib.trace import Trace
    from mdbench.metrics import force_roofline_pct  # noqa: F401  (the module is found by file in runs)

    ops = [(i * 1e4, i * 1e4 + 8e3, "streaming_lj_kernel", "force", True) for i in range(10)]
    tr = Trace(window_s=0.1, steps=10, ops=ops, spans=[])

    class Ctx:
        trace, work, peaks = tr, {"force": (51e9, 1e6)}, {"fp32_ops_per_s": 67e12, "bytes_per_s": 3.35e12}

    share = force_roofline_pct.read(Ctx())
    assert share == pytest.approx(100 * 10 * 51e9 / 67e12 / 0.08)
    assert 0 < share <= 100
    assert math.isclose(tr.busy_s, 0.08)
