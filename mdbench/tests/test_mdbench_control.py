"""The control: the reference itself put in the program's place with its
force arithmetic in bfloat16 (the next precision below the float32 the
configurations state) has to fail the comparison that sound runs of the
program pass.  On the CPU at the tiny cells' sizes; on the card (`gpu`) at
each BENCHMARK.json cell's own size, three seeds, its readings printed."""

import json
import math

import mdbench_tiny
import pytest

from mdbench.lib import checks, control


def _judge(r):
    limits = r["limits"]
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    failed = [k for k, v in limits.items() if k in r["control"] and r["control"][k] > v]
    assert failed, r
    return failed


@pytest.mark.parametrize("cell", sorted(mdbench_tiny.TINY))
def test_control_fails_where_the_program_passes_tiny(tiny_root, cell):
    r = control.readings(cell, 21, 1.0, root=tiny_root, require_chip=False)
    assert set(_judge(r)) == set(r["limits"]) - {"cell_faults"}


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1000000001, 1000000002, 1000000003])
def test_control_fails_at_the_cells_own_size(card, seed):
    from mdbench import run

    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        r = control.readings(cell["name"], seed, 5.0)
        print(json.dumps({"cell": cell["name"], "seed": seed, **r}))
        assert set(_judge(r)) == set(r["limits"]) - {"cell_faults"}


def test_drift_slope_reads_the_slope_of_energy_per_atom_over_time():
    wobble = [1e-3, -1e-3]  # a swing of 1e-6 an atom
    points = [(step, 1000.0 * (-5.0 + 3e-4 * step * 0.005) + wobble[step // 6 % 2]) for step in range(0, 60, 6)]
    assert checks.drift_slope(points, 1000, 0.005) == pytest.approx(3e-4, rel=2e-2)
    assert math.isnan(checks.drift_slope(points[:2], 1000, 0.005))
