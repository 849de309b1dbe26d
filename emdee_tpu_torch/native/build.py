"""On-demand compilation of the native C++ library with g++ (counterpart of
emdee_tpu/native/build.py).

The shared library bundles the canonical-labeling and chem-I/O codepaths of
this directory's `canon.cpp` and `chemio.cpp`.  It is compiled once, the
first time a native entry point is requested, into the git-ignored
`build/emdee_tpu_torch/` beside the package (the kernels' build directory,
`csrc/build.py`), named by a hash of the sources and flags, so that an
edited source rebuilds and the reference's own library is never touched.
Failures (no compiler, read-only tree) degrade gracefully to the
pure-Python implementations.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

from emdee_tpu_torch.csrc.build import BUILD_DIR

_HERE = Path(__file__).resolve().parent
_SRC = [_HERE / "canon.cpp", _HERE / "chemio.cpp"]
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_failed = False


def _library() -> Path:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SRC:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libemdee_native_{digest.hexdigest()[:16]}.so"


def library_path() -> Path | None:
    """Return the path to the compiled library, building it if necessary."""
    global _failed
    with _lock:
        if _failed:
            return None
        if not all(s.exists() for s in _SRC):
            _failed = True
            return None
        lib = _library()
        if lib.exists():
            return lib
        # Compile to a private name and rename, so that processes building
        # at once never load a half-written library.
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *_FLAGS, "-o", str(tmp)] + [str(s) for s in _SRC]
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib)
        except (OSError, subprocess.SubprocessError):
            _failed = True
            return None
        return lib
