"""XYZ file reading/writing (counterpart of emdee_tpu/io/xyz.py; numpy
only, no torch).

The reference reads XYZ via the Chemfiles C++ library (runtests.jl:20-22) and
pulls velocities from the resulting frame (modelling.jl:240).  This module
provides the equivalent subset natively: the classic XYZ layout (count line,
comment line, then ``name x y z`` records), optional velocity columns
(``name x y z vx vy vz`` — recognized when every record carries them), and
multi-frame trajectory writing for rollout dumps (a capability the reference
parses for but never ships — SURVEY.md §5 checkpoint/resume).

A C++ fast path (emdee_tpu_torch.native.chemio) accelerates parsing of large files;
this pure-Python implementation is the always-available fallback and the
behavioral spec.
"""

from __future__ import annotations

import io
from typing import List, NamedTuple, Optional, Tuple

import numpy as np


class XYZFrame(NamedTuple):
    names: List[str]
    positions: np.ndarray  # (N, 3) float64
    velocities: Optional[np.ndarray]  # (N, 3) float64 or None
    comment: str


def read_xyz(path_or_buf) -> Tuple[List[str], np.ndarray, str]:
    """Read one XYZ frame.  Returns (names, positions (N,3) float64, comment).

    Velocity-aware callers should use `read_xyz_frame`.
    """
    frame = read_xyz_frame(path_or_buf)
    return frame.names, frame.positions, frame.comment


def read_xyz_frame(path_or_buf) -> XYZFrame:
    """Read one XYZ frame including velocity columns when present."""
    # Try the native C++ parser for real files.
    if isinstance(path_or_buf, (str, bytes)):
        from emdee_tpu_torch.native import chemio

        if chemio.available():
            names, pos, vel, comment = chemio.read_xyz(str(path_or_buf))
            return XYZFrame(names, pos, vel, comment)
        with open(path_or_buf, "r") as fh:
            return _read_xyz_stream(fh)
    return _read_xyz_stream(path_or_buf)


def _read_xyz_stream(fh) -> XYZFrame:
    count_line = fh.readline()
    if not count_line.strip():
        raise ValueError("empty XYZ file")
    n = int(count_line.split()[0])
    comment = fh.readline().rstrip("\n")
    names: List[str] = []
    pos = np.empty((n, 3), np.float64)
    vel = np.empty((n, 3), np.float64)
    has_vel = True
    for i in range(n):
        parts = fh.readline().split()
        if len(parts) < 4:
            raise ValueError(f"bad XYZ record at atom {i}: {parts}")
        names.append(parts[0])
        pos[i, 0] = float(parts[1])
        pos[i, 1] = float(parts[2])
        pos[i, 2] = float(parts[3])
        if has_vel and len(parts) >= 7:
            vel[i, 0] = float(parts[4])
            vel[i, 1] = float(parts[5])
            vel[i, 2] = float(parts[6])
        else:
            has_vel = False
    return XYZFrame(names, pos, vel if has_vel else None, comment)


def write_xyz(path_or_buf, names, positions, comment: str = "", velocities=None) -> None:
    positions = np.asarray(positions)
    n = positions.shape[0]
    if isinstance(names, str):
        names = [names] * n
    own = isinstance(path_or_buf, (str, bytes))
    fh = open(path_or_buf, "w") if own else path_or_buf
    try:
        fh.write(f"{n}\n{comment}\n")
        if velocities is None:
            for name, (x, y, z) in zip(names, positions):
                fh.write(f"{name} {x:.10g} {y:.10g} {z:.10g}\n")
        else:
            velocities = np.asarray(velocities)
            for name, (x, y, z), (vx, vy, vz) in zip(names, positions, velocities):
                fh.write(
                    f"{name} {x:.10g} {y:.10g} {z:.10g} {vx:.10g} {vy:.10g} {vz:.10g}\n"
                )
    finally:
        if own:
            fh.close()


class XYZTrajectoryWriter:
    """Append frames to a multi-frame XYZ trajectory file."""

    def __init__(self, path: str, names):
        self._fh = open(path, "w")
        self._names = list(names)

    def write_frame(self, positions, comment: str = "", velocities=None) -> None:
        write_xyz(self._fh, self._names, positions, comment, velocities=velocities)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
