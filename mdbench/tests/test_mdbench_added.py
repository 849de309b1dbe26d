"""A cell, a traffic mix and a per-layer metric added as files and
BENCHMARK.json entries alone, with no file of the benchmark edited."""

import hashlib
import json
from pathlib import Path

import mdbench_tiny


def _digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_cell_mix_and_metric_added_from_files(tmp_path):
    root = mdbench_tiny.make_root(tmp_path)
    before = _digest(root / "mdbench")
    data = root / "mdbench"
    traffic = json.loads((data / "traffic" / "nve-sort-chunk9.json").read_text())
    traffic.update(chunk_steps=6, rebin_every=3, why="a mix added by a data file")
    (data / "traffic" / "nve-sort-chunk6-rebin3.json").write_text(json.dumps(traffic))
    (data / "limits" / "lj-tiny-added.json").write_text((data / "limits" / "lj-tiny-nve.json").read_text())
    (data / "metrics" / "steps_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.steps) if ctx.trace else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "lj-tiny-added", "config": "lj-melt-tiny",
                               "traffic": "nve-sort-chunk6-rebin3", "chips": 1, "why": "added by data files"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "runner", "moves": "atom_steps_per_s",
                               "workloads": ["lj-tiny-added"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(data)
    assert all(after[k] == v for k, v in before.items())  # nothing that was there changed

    rc, result, err = mdbench_tiny.run(root, "lj-tiny-added", trace=1)
    assert rc == 0, err
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["steps_in_window"] == {"value": 18.0, "unit": "steps"}  # trace_chunks 3 x 6 steps
    assert "rebin_every\": 3" in err
