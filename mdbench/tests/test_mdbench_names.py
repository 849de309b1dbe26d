"""BENCHMARK.json against the contract's shapes: names and units of the
allowed characters, the keys each entry may have, and a file for every name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def _names():
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[part]:
            yield part, entry


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "mdbench/run.py"] and BENCH["paths"] == ["mdbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("part,entry", list(_names()), ids=lambda v: v if isinstance(v, str) else v["name"])
def test_names_units_and_keys(part, entry):
    assert NAME.match(entry["name"])
    keys = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
    }[part]
    assert set(entry) - {"workloads"} == keys
    if part in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry and part != "end_to_end":
            assert TEXT.match(entry[key])
    if part == "configs":
        assert all(NAME.match(k) for k in entry["reduced"]) and len(entry["reduced"]) <= 16
    if part == "workloads":
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"]) and entry["chips"] in (1, 4)


def test_every_name_has_its_file():
    data = ROOT / "mdbench"
    cells = {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("mdbench/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert (data / "traffic" / f"{w['traffic']}.json").is_file()
        assert "limits" in json.loads((data / "limits" / f"{w['name']}.json").read_text())
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (data / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_files_named_from_allowed_characters():
    for p in (ROOT / "mdbench").rglob("*"):
        if "__pycache__" not in p.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(ROOT)))
