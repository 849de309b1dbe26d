"""A cell end to end on the CPU, and the contract's last line."""

import json

import mdbench_tiny
import pytest

from mdbench import run


@pytest.mark.parametrize("cell", sorted(mdbench_tiny.TINY))
def test_cell_prints_the_contract_line(tiny_root, cell, capsys):
    rc, result, err = mdbench_tiny.run(tiny_root, cell)
    assert rc == 0, err
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"atom_steps_per_s", "setup_s"}
    assert result["metrics"]["atom_steps_per_s"]["unit"] == "atom-steps/s"
    assert result["device"]["platform"] == "cpu"
    limits = json.loads((tiny_root / "mdbench" / "limits" / f"{cell}.json").read_text())["limits"]
    assert set(result["checks"]) == set(limits) >= {"cell_faults", "stretch_dv", "pe_err", "vir_err"}
    assert all(set(v) == {"value", "limit"} for v in result["checks"].values())
    tail = err.strip().splitlines()
    k = len(limits)
    assert tail[-k - 1] == "correct: True" and all(line.startswith("check ") for line in tail[-k:])
    print(json.dumps(result))


def test_traced_run_reports_per_layer_metrics_only(tiny_root):
    rc, result, err = mdbench_tiny.run(tiny_root, "lj-tiny-nve", trace=1)
    assert rc == 0, err
    assert result["correct"] is True
    assert set(result["metrics"]) == {"setup_state_s", "setup_equil_s"}  # no device operations on the CPU
    assert result["device"]["window_s"] > 0 and "busy_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "checks"


def test_no_card_means_no_result(capsys):
    rc = run.main(["--workload", "lj1m-nve-sort", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_unknown_workload_is_refused(capsys):
    assert run.main(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1"], require_chip=False) == 2
    assert capsys.readouterr().out == ""
