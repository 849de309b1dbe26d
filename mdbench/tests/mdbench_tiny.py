"""The benchmark at sizes the CPU holds: a copy of the benchmark's data files
in a scratch checkout, with the tiny cells of `tests/data/` added by data
files and BENCHMARK.json entries alone, run in-process with the chip check
skipped (the program then runs its plain versions)."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
from pathlib import Path

MDBENCH = Path(__file__).resolve().parents[1]
ROOT = MDBENCH.parent
DATA = Path(__file__).resolve().parent / "data"
TINY = {
    "lj-tiny-nve": ("lj-melt-tiny", "nve-sort-chunk9"),
    "water-tiny-nvt": ("water-tiny", "csvr300-chunk6"),
}


def make_root(tmp: Path) -> Path:
    """A checkout holding BENCHMARK.json with the tiny cells and mdbench/'s
    data files; the tiny cells' configs, traffic and limits are added as
    files, nothing edited."""
    shutil.copytree(MDBENCH, tmp / "mdbench", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for kind in ("configs", "traffic", "limits"):
        for f in (DATA / kind).glob("*.json"):
            shutil.copy(f, tmp / "mdbench" / kind / f.name)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, (config, traffic) in TINY.items():
        bench["configs"].append({"name": config, "source": "tests", "file": f"mdbench/configs/{config}.json",
                                 "reduced": [], "why": "a size the CPU holds"})
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1,
                                   "why": "a size the CPU holds"})
        for metric in bench["per_layer"]:
            metric["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


def run(root: Path, cell: str, seed: int = 7, seconds: float = 1.0, trace: int = 0):
    """(exit code, the result line as a dict or None, standard error)."""
    from mdbench import run as bench_run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench_run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                             "--trace", str(trace)], require_chip=False, root=root)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), err.getvalue()
