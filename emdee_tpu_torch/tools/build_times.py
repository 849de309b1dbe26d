"""Where the kernels' build time goes: compiles every object of
`csrc/build.py` at once, as `build.load()` does, each with `-Xptxas -v`,
and prints the wall time of the whole and, slowest first, of each object
(source and `EMDEE_PART`), with its kernels' count and the time ptxas
reports for them; with FILE, ptxas's full report (registers and spills of
every kernel) goes there.  The objects are written under
`build/emdee_tpu_torch/` and removed; the package's library is not touched.
Run from the repository root on a machine with the CUDA toolkit:

    python3 -m emdee_tpu_torch.tools.build_times [FILE]
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import subprocess
import sys
import time
from pathlib import Path

from emdee_tpu_torch.csrc import build


def _compile(unit):
    src, part = unit
    obj = build.BUILD_DIR / f"build_times.{os.getpid()}.{src.stem}.{part}.o"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, *([] if part is None else [f"-DEMDEE_PART={part}"]), "-Xptxas", "-v",
           "-c", "-o", str(obj), str(src)]
    start = time.monotonic()
    done = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.monotonic() - start
    obj.unlink(missing_ok=True)
    out = done.stdout + done.stderr
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed ({done.returncode}): {' '.join(cmd)}\n{out}")
    ptxas_ms = sum(float(t) for t in re.findall(r"Compile time = ([\d.]+) ms", out))
    return src.name, part, seconds, out.count("Compiling entry"), ptxas_ms, out


def main(argv) -> None:
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    units = build._units()
    start = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        results = list(pool.map(_compile, units))
    print(f"{len(units)} objects compiled at once on {os.cpu_count()} CPU cores in "
          f"{time.monotonic() - start:.2f} s (wall)")
    for name, part, seconds, kernels, ptxas_ms, _ in sorted(results, key=lambda r: -r[2]):
        label = name if part is None else f"{name} part {part}"
        print(f"  {label}: {seconds:.2f} s, {kernels} kernels, ptxas {ptxas_ms / 1e3:.2f} s")
    if argv:
        Path(argv[0]).write_text("".join(f"=== {name} part {part}\n{out}\n" for name, part, _, _, _, out in results))


if __name__ == "__main__":
    main(sys.argv[1:])
