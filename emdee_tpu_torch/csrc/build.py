"""Build the port's CUDA kernels and bind them with ctypes.

At first use, `load()` compiles every `*.cu` file of this directory with
`nvcc` for `sm_90a` — one `nvcc` per source, all started together; a source
that declares `// emdee-build-parts: N` is compiled as N objects at once,
with -DEMDEE_PART=0 … N−1, each holding some of its entry points and
kernel variants — and links the objects into one shared library with a
plain C interface, under
`build/emdee_tpu_torch/` beside the package (git-ignored), named by a hash
of the sources, headers and flags so that an edited source rebuilds.  Nothing
beyond the CUDA toolkit is needed; a failed build raises with nvcc's
output.  The kernels launch on the caller's stream and allocate nothing;
each C entry returns `cudaGetLastError()`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parent.parent / "build" / "emdee_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_long

# C signatures of the entry points (see the .cu files).
_SIGNATURES = {
    # px, py, pz, pstride, hs, tse, valid, fx, fy, fz, fstride, e, w,
    # m, c, box, rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, sig2_u, eps4_u,
    # uniform, energy, stream (box: a 0-d float32 device tensor's pointer)
    "emdee_cell_forces": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                          _I, _I, _P, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                          _F, _I, _I, _P],
    # uniform, energy, strag, ghost, out (int[4])
    "emdee_cell_forces_attrs": [_I, _I, _I, _I, _P],
    # pos, hs, tse, valid, q, aid, ids, mlj, mcs, kb, kr0, kr02, ne, neb,
    # alpha, rc, rc2_c, e_shift, f_shift, kc (0-d device tensors), f, e, w,
    # m, c, box (device), rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, coulomb,
    # excl, bond, energy, stream
    "emdee_cell_forces_mol": [_P] * 12 + [_I, _I] + [_P] * 6 + [_P, _P, _P, _I, _I, _P] + [_F] * 8
                             + [_I, _I, _I, _I, _P],
    # c, ne, neb, coulomb, excl, bond, energy, out (int[4])
    "emdee_cell_forces_mol_attrs": [_I] * 7 + [_P],
    # px, py, pz, valid, fx, fy, fz, ax, ay, az, table, kn, m, c, box (device),
    # rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, sig2_u, eps4_u, stream
    "emdee_cell_forces_strag": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _P, _F, _F, _F, _F, _F, _F, _F,
                                _F, _F, _F, _P],
    # px, py, pz, valid, ax, ay, az, acell, afx, afy, afz, m, c, a_cap, box,
    # rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, sig2_u, eps4_u, stream
    "emdee_straggler_aux": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F,
                            _F, _F, _F, _P],
    # the same arguments: the former one-warp-a-slot kernel, kept as a witness
    "emdee_straggler_aux_warp": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F,
                                 _F, _F, _F, _P],
    # px, py, pz, pstride, hs, tse, valid, slices, m, c, box (device), rc2,
    # rs2, invd2, a_m, pa1, pa2, pb1, pb2, sig2_u, eps4_u, uniform, energy,
    # stream
    "emdee_streaming_forces": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P] + [_F] * 10 + [_I, _I, _P],
    # c, uniform, energy, out (int[4])
    "emdee_streaming_attrs": [_I, _I, _I, _P],
    # pos, hs, tse, valid, q, aid, ids, mlj, mcs, kb, kr0, kr02, ne, neb,
    # alpha, rc, rc2_c, e_shift, f_shift, kc (0-d device tensors), slices,
    # m, c, box (device), rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2, coulomb,
    # excl, bond, energy, stream
    "emdee_streaming_forces_mol": [_P] * 12 + [_I, _I] + [_P] * 6 + [_P, _I, _I, _P] + [_F] * 8
                                  + [_I, _I, _I, _I, _P],
    # c, ne, neb, coulomb, excl, bond, energy, out (int[4])
    "emdee_streaming_mol_attrs": [_I] * 7 + [_P],
    # f, e, w, slices, n_slices, num_slots, energy, stream
    "emdee_streaming_fold_mol": [_P, _P, _P, _P, _I, _L, _I, _P],
    # fx, fy, fz, fstride, e, w, slices, num_slots, energy, stream
    "emdee_streaming_fold": [_P, _P, _P, _I, _P, _P, _P, _L, _I, _P],
    # px, py, pz, hs, tse, slices, mz, my, mx, shards, sy_n, sx_n, bz, by,
    # bx, m, c, box (device), rc2, rs2, invd2, a_m, pa1, pa2, pb1, pb2,
    # sig2_u, eps4_u, uniform, energy, stream
    "emdee_streaming_ghost": [_P] * 6 + [_I] * 11 + [_P] + [_F] * 10 + [_I, _I, _P],
    # c, uniform, energy, out (int[4])
    "emdee_streaming_ghost_attrs": [_I, _I, _I, _P],
    # out, slices, react, mz, my, mx, shards, c, energy, stream
    "emdee_streaming_ghost_assemble": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # px, py, pz, hs, tse, q, aid, ids, mlj, mcs, ne, alpha, rc, rc2_c,
    # e_shift, f_shift, kc (0-d device tensors), slices, mz, my, mx, shards,
    # sy_n, sx_n, bz, by, bx, m, c, box (device), rc2, rs2, invd2, a_m, pa1,
    # pa2, pb1, pb2, coulomb, excl, energy, stream
    "emdee_streaming_ghost_mol": [_P] * 10 + [_I] + [_P] * 6 + [_P] + [_I] * 11 + [_P] + [_F] * 8
                                 + [_I] * 3 + [_P],
    # c, ne, coulomb, excl, energy, out (int[4])
    "emdee_streaming_ghost_mol_attrs": [_I] * 5 + [_P],
    # out, slices, react, mz, my, mx, shards, c, energy, stream
    "emdee_streaming_ghost_assemble_mol": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # ptrs (host void*[nf]), strides (host long[nf]), nf, valid (or null),
    # wrap, out, mid, flag, m, c, num_slots, box (device), stream
    "emdee_rebin_routing": [_P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P],
    # out (int[4])
    "emdee_rebin_routing_attrs": [_P],
    # in, out, flag, nf, m, c, axis, cf, num_slots, box (device), stream: one
    # pass of the former three-launch design, kept as a witness
    "emdee_rebin_pass": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # s, keep, win, out, rows, nf, c, win_f, win_r, out_f, out_r, last_fill,
    # stream: the former K7, kept as a witness
    "emdee_compact_window": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _I, _P],
    # ptrs (host void*[nf]), strides (host long[nf]), nf, valid, wrap, out,
    # mid, counts, scratch, flag, m, c, num_slots, target, threshold, box
    # (device), stream
    "emdee_spill_routing": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P],
    # out (int[4])
    "emdee_spill_routing_attrs": [_P],
    # px, py, pz, hs, tse, fx, fy, fz, e, w, mz, my, mx, shards, sy_n, sx_n,
    # bz, by, bx, m, c, box (device), rc2, rs2, invd2, a_m, pa1, pa2, pb1,
    # pb2, sig2_u, eps4_u, uniform, energy, stream
    "emdee_cell_forces_ghost": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _F, _F,
                                _F, _F, _F, _F, _F, _F, _F, _F, _I, _I, _P],
    # px, py, pz, hs, tse, q, aid, ids, mlj, mcs, ne, alpha, rc, rc2_c,
    # e_shift, f_shift, kc (0-d device tensors), fx, fy, fz, e, w, mz, my,
    # mx, shards, sy_n, sx_n, bz, by, bx, m, c, box (device), rc2, rs2,
    # invd2, a_m, pa1, pa2, pb1, pb2, coulomb, excl, energy, stream
    "emdee_cell_forces_ghost_mol": [_P] * 10 + [_I] + [_P] * 6 + [_P] * 5 + [_I] * 11 + [_P] + [_F] * 8
                                   + [_I, _I, _I, _P],
    # c, ne, coulomb, excl, energy, out (int[4])
    "emdee_cell_forces_ghost_mol_attrs": [_I] * 5 + [_P],
    # ptrs (host void*[nf]), strides (host long[nf]), nf, lo, lo strides
    # (host long[8]), hi, hi strides, b, out, flag, shape (host int[6]), c,
    # axis, cf, m, num_slots, raw, box (device), stream
    "emdee_rebin_halo": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # K7-G: emdee_rebin_halo's arguments with two-layer halo planes, and
    # target, threshold before the box
    "emdee_spill_halo": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P],
    # K7-G's one-launch form: ptrs (host void*[nf]), strides (host long[nf]),
    # nf, out, mid, scratch, flag, shape (host int[6]), c, m, num_slots,
    # target, threshold, box (device), stream
    "emdee_spill_grid_routing": [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P],
    # out (int[4])
    "emdee_spill_grid_attrs": [_P],
    # ptrs, slot strides, word strides (host void*[8], long[8], long[8]:
    # positions, velocities, inv_masses, half_sigma, twice_sqrt_eps, atom_id,
    # forces or null, charges or null), valid, valid's slot stride, outs (host
    # void*[8]), valid_out, scratch, flag_in, flag_out, m, c, box (device),
    # stream
    "emdee_sort_rebin": [_P, _P, _P, _P, _L, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    # out (int[4])
    "emdee_sort_rebin_attrs": [_P],
    # x, wl, wr, b, out, flag, nf, rows, c, cf, m, num_slots, box (device),
    # stream: the former K6 over whole windows, kept as a witness
    "emdee_rebin_window": [_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _P, _P],
    # ghost, centers, out, m, c, tiles, k_ops, a, b, stream
    "emdee_probe_fma": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    # cen, expand, out, progs, nc, kd, ncol, transposed, stream
    "emdee_probe_cen": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _units():
    """(source, part or None) for every object to compile."""
    units = []
    for src in _sources():
        found = re.search(r"^// emdee-build-parts: (\d+)$", src.read_text(), re.M)
        units += [(src, k) for k in range(int(found.group(1)))] if found else [(src, None)]
    return units


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libemdee_kernels_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib_path = library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{lib_path.stem}.{os.getpid()}"
        units = _units()
        objects = [BUILD_DIR / f"{tag}.{src.stem}{'' if k is None else f'.{k}'}.o" for src, k in units]
        _run([
            [nvcc, *NVCC_FLAGS, *([] if k is None else [f"-DEMDEE_PART={k}"]), "-c", "-o", str(obj), str(src)]
            for (src, k), obj in zip(units, objects)
        ])
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]])
        for obj in objects:
            obj.unlink()
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _run(cmds) -> None:
    """Start every command at once, wait for all of them, and raise with the
    output of the first that failed."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")


def check(err: int, what: str) -> None:
    """Raise if a kernel entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
