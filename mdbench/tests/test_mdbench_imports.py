"""Nothing a cell's run loads, and nothing the reference loads, is JAX or the
JAX package, by whole top-level name (emdee_tpu_torch is not emdee_tpu); and
the reference loads nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "emdee_tpu"}


def _run(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_top_level_names_are_compared_whole():
    from mdbench.run import FORBIDDEN as run_forbidden, forbidden_modules

    assert set(run_forbidden) >= FORBIDDEN
    import emdee_tpu_torch  # noqa: F401

    assert "emdee_tpu_torch" not in forbidden_modules()


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_run_loads_no_jax(tmp_path, trace):
    code = (
        "import sys, json, contextlib, io, pathlib; sys.path[:0] = ['mdbench/tests', '.']\n"
        "import mdbench_tiny\n"
        f"root = mdbench_tiny.make_root(pathlib.Path({str(tmp_path)!r}))\n"
        f"rc, res, err = mdbench_tiny.run(root, 'lj-tiny-nve', trace={trace})\n"
        "assert rc == 0 and res['correct'], err\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    tops = _run(code)
    assert "emdee_tpu_torch" in tops and not tops & FORBIDDEN


def test_a_reader_that_loads_jax_stops_the_result(tmp_path):
    """A per-layer reader runs after the window; what it loads is still
    caught, and the run prints no result."""
    code = (
        "import sys, json, pathlib; sys.path[:0] = ['mdbench/tests', '.']\n"
        "import mdbench_tiny\n"
        f"root = mdbench_tiny.make_root(pathlib.Path({str(tmp_path)!r}))\n"
        "(root / 'mdbench/metrics/loads_jax.py').write_text("
        "'import sys, types\\nsys.modules.setdefault(\"jax\", types.ModuleType(\"jax\"))\\n'"
        "'def read(ctx):\\n    return 1.0\\n')\n"
        "bench = json.loads((root / 'BENCHMARK.json').read_text())\n"
        "bench['per_layer'].append({'name': 'loads_jax', 'unit': '%', 'better': 'higher', 'source': 'host_clock',"
        " 'layer': 'runner', 'moves': 'atom_steps_per_s', 'workloads': ['lj-tiny-nve']})\n"
        "(root / 'BENCHMARK.json').write_text(json.dumps(bench))\n"
        "rc, res, err = mdbench_tiny.run(root, 'lj-tiny-nve', trace=1)\n"
        "print(json.dumps([rc, res, err.strip().splitlines()[-1]]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    rc, res, last = json.loads(out.stdout.strip().splitlines()[-1])
    assert rc != 0 and res is None and "jax" in last


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys, json; sys.path.insert(0, '.')\n"
        "import mdbench.reference.cells, mdbench.reference.forces, mdbench.reference.integrate\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    tops = _run(code)
    assert not tops & (FORBIDDEN | {"emdee_tpu_torch"})


def test_the_reference_sources_import_only_torch_numpy_and_itself():
    for path in (ROOT / "mdbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top in {"torch", "numpy", "math", "dataclasses", "typing", "__future__", "mdbench"}, (path, name)
                if top == "mdbench":
                    assert name.startswith("mdbench.reference"), (path, name)
