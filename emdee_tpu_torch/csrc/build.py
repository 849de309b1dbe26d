"""Build the port's CUDA kernels and bind them with ctypes.

At first use, `load()` compiles every `*.cu` file of this directory with
`nvcc` for `sm_90a` into one shared library with a plain C interface,
under `build/emdee_tpu_torch/` beside the package (git-ignored), named by a
hash of the sources and flags so that an edited source rebuilds.  Nothing
beyond the CUDA toolkit is needed; a failed build raises with nvcc's
output.  The kernels launch on the caller's stream and allocate nothing;
each C entry returns `cudaGetLastError()`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parent.parent / "build" / "emdee_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the entry points (see the .cu files).
_SIGNATURES = {
    # px, py, pz, pstride, hs, tse, valid, fx, fy, fz, fstride, e, w,
    # m, c, box, rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, sig2_u, eps4_u,
    # uniform, energy, stream
    "emdee_cell_forces": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                          _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                          _I, _I, _P],
    # in, out, flag, nf, m, c, axis, cf, num_slots, box, stream
    "emdee_rebin_pass": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libemdee_kernels_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib_path = library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
