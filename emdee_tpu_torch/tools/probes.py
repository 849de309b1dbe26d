"""The two TPU probes of the repository's tools/ on the card — P1
(tools/perf_probe3.py: the force kernel's dispatch shape with its pair math
replaced by a chain of K multiply-adds) and P2
(tools/perf_probe_cen_layout.py: the centre-expansion product in its two
layouts) — as the CUDA kernels of `csrc/probes.cu`, each with its plain
version.  On no simulation path: they measure the card.  `chip_smoke.py`'s
probe phase holds each against its plain version and prints P1's ms, ns per
tile and effective rate for K in `K_SWEEP` at the 97,556-atom melt's
M = 17, C = 32, and P2's ms in both layouts beside `torch.matmul` (TF32
off).  The wrappers launch the kernels for CUDA tensors and run the plain
versions for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from emdee_tpu_torch.csrc import build
from emdee_tpu_torch.neighbors.cell_dense import resolve_backend

# Kernel launches (either probe) since import (or a reset to 0).
LAUNCHES = 0

# P1: the reference's constants x·0.9999999 + 0.0000001, as float32 values.
FMA_A = float(np.float32(0.9999999))
FMA_B = float(np.float32(0.0000001))
TILES = 14
K_SWEEP = (5, 15, 25, 45)
# P2: the reference's shape — M² programs of (NC, M) @ (M, M·C).
M, C, NC = 17, 32, 96
CEN_SMEM_BYTES = 232_448  # a block's shared memory on Hopper: P2 stages both tiles there


def probe_fma_inputs(m: int, c: int, device, seed: int = 0):
    """P1's inputs: the (G², G·C) ghost block of ones (G = m + 2) and
    uniform centre tiles (m², C, m·C) from numpy's generator `seed`."""
    g = m + 2
    ghost = torch.ones((g * g, g * c), dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    centers = torch.from_numpy(rng.random((m * m, c, m * c), dtype=np.float32)).to(device)
    return ghost, centers


def probe_fma_plain(ghost, centers, m: int, c: int, k_ops: int):
    """P1 in torch ops, operation for operation as the kernel rounds them."""
    g, mc = m + 2, m * c
    prog = torch.arange(m * m, device=centers.device)
    cz, cy = prog // m, prog % m
    acc = torch.zeros_like(centers)
    for t in range(TILES):
        rows = (cz + t % 3) * g + (cy + (t // 3) % 3)
        nb = ghost[rows, (t % 3) * c : (t % 3) * c + mc]
        x = centers - nb[:, None, :]
        for _ in range(k_ops):
            x = x * FMA_A + FMA_B
        acc = acc + x
    return acc


def probe_fma(ghost, centers, m: int, c: int, k_ops: int, backend: str = "auto"):
    """P1: out (m², C, m·C) — per program, the sum over its tiles of the
    centre tile less a ghost row, run through K multiply-adds."""
    if resolve_backend(backend, centers) == "torch":
        return probe_fma_plain(ghost, centers, m, c, k_ops)
    global LAUNCHES
    g = m + 2
    if tuple(ghost.shape) != (g * g, g * c) or tuple(centers.shape) != (m * m, c, m * c):
        raise ValueError(f"probe_fma: ghost {tuple(ghost.shape)}, centers {tuple(centers.shape)} for m={m} c={c}")
    for t in (ghost, centers):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != centers.device:
            raise ValueError("probe_fma: inputs must be contiguous float32 on one device")
    out = torch.empty_like(centers)
    err = build.load().emdee_probe_fma(ghost.data_ptr(), centers.data_ptr(), out.data_ptr(), m, c, TILES, k_ops,
                                       FMA_A, FMA_B, torch.cuda.current_stream(centers.device).cuda_stream)
    build.check(err, "probe_fma kernel")
    LAUNCHES += 1
    return out


def probe_cen_inputs(transposed: bool, device, progs: int = M * M, seed: int = 0):
    """P2's inputs: centres (progs, NC, M), or (progs, M, NC) transposed,
    and the expansion (M, M·C), uniform from numpy's generator `seed`."""
    rng = np.random.default_rng(seed)
    shape = (progs, M, NC) if transposed else (progs, NC, M)
    cen = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(device)
    expand = torch.from_numpy(rng.random((M, M * C), dtype=np.float32)).to(device)
    return cen, expand


def probe_cen_plain(cen, expand, transposed: bool):
    """P2 in torch ops: Σ_k a[:, :, k] ⊗ expand[k] in k order (a product
    and a sum each, where the kernel fuses them)."""
    a = cen.transpose(1, 2) if transposed else cen
    out = torch.zeros((a.shape[0], a.shape[1], expand.shape[1]), dtype=torch.float32, device=cen.device)
    for k in range(a.shape[2]):
        out = out + a[:, :, k, None] * expand[k]
    return out


def probe_cen(cen, expand, transposed: bool, backend: str = "auto"):
    """P2: out (progs, NC, NCOL) = centres @ expand per program, the
    centres stored (NC, K) or, transposed, (K, NC); float32 FMA, no TF32.
    The kernel (one block a program, both tiles in shared memory, register
    tiles of 8 rows × 4 columns) takes NC and NCOL multiples of 4."""
    if resolve_backend(backend, cen) == "torch":
        return probe_cen_plain(cen, expand, transposed)
    global LAUNCHES
    progs = cen.shape[0]
    kd, ncol = expand.shape
    nc = cen.shape[2] if transposed else cen.shape[1]
    want = (progs, kd, nc) if transposed else (progs, nc, kd)
    if cen.dim() != 3 or tuple(cen.shape) != want:
        raise ValueError(f"probe_cen: centres {tuple(cen.shape)} against expand {tuple(expand.shape)}")
    for t in (cen, expand):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != cen.device:
            raise ValueError("probe_cen: inputs must be contiguous float32 on one device")
    if nc % 4 or ncol % 4 or 4 * (kd * (ncol + nc) + 8) > CEN_SMEM_BYTES or expand.data_ptr() % 16:
        raise ValueError(f"probe_cen: the kernel takes NC and NCOL multiples of 4, a 16-byte aligned expansion and "
                         f"(K, NCOL + NC) float32 within {CEN_SMEM_BYTES} B; got K={kd}, NCOL={ncol}, NC={nc}")
    out = torch.empty((progs, nc, ncol), dtype=torch.float32, device=cen.device)
    err = build.load().emdee_probe_cen(cen.data_ptr(), expand.data_ptr(), out.data_ptr(), progs, nc, kd, ncol,
                                       int(transposed), torch.cuda.current_stream(cen.device).cuda_stream)
    build.check(err, "probe_cen kernel")
    LAUNCHES += 1
    return out


def fma_counts(m: int, c: int, k_ops: int):
    """(pair lanes, float32 operations, bytes read and written) of one P1
    call — the reference's count of 2K + 2 operations a lane."""
    lanes = m * m * TILES * c * m * c
    g = m + 2
    return lanes, lanes * (2 * k_ops + 2), 4 * (g * g * g * c + 2 * m * m * c * m * c)


def cen_counts(progs: int = M * M):
    """(float32 operations, bytes read and written) of one P2 call."""
    ncol = M * C
    return 2 * progs * NC * M * ncol, 4 * (progs * NC * M + M * ncol + progs * NC * ncol)
