"""Readings that set a cell's limits (`limits/<cell>.json`): for each seed,
the numbers of a sound run of the program and those of the control, the
reference itself put in the program's place with its force arithmetic in
bfloat16, at the same window end state.  The benchmark's own runs never run
this; `tests/test_mdbench_control.py` does, and prints what it reads.

    python3 -m mdbench.lib.control CELL SECONDS SEED [SEED ...]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def readings(cell: str, seed: int, seconds: float, root=None, require_chip: bool = True) -> dict:
    """{"program": numbers, "control": numbers} of one seed: set-up, a timed
    window of `seconds`, then both held against the reference."""
    from mdbench import run
    from mdbench.lib import checks

    spec = run.CellSpec(Path(root) if root is not None else run.ROOT, cell)
    device = run.pick_device(spec, require_chip)
    if device is None:
        raise RuntimeError(f"{cell} needs {spec.cell['chips']} CUDA card(s)")
    sim, state, _ = run.set_up(spec, seed, device)
    state, record, _ = run.timed_window(sim, state, spec.traffic["chunk_steps"], seconds, device)
    steps = spec.traffic["check_steps"]
    out = run.outputs(sim, state, record, steps)
    del state
    run.free_program(sim, device)
    ref = checks.Reference(sim, out["pos"], out["vel"], steps, out["gen_state"])
    program = checks.program_numbers(ref, out, record)
    return {"program": program, "control": ref.control(), "limits": spec.limits}


if __name__ == "__main__":
    cell, seconds = sys.argv[1], float(sys.argv[2])
    for s in sys.argv[3:]:
        print(json.dumps({"cell": cell, "seed": int(s), **readings(cell, int(s), seconds)}), flush=True)
