"""All-pairs (O(N²)) nonbonded evaluation (counterpart of
emdee_tpu/neighbors/allpairs.py).

Each row block of atoms meets every atom at once: a (B, N) sweep of
minimum-image displacements, the pair functions and a sum over the
partners.  Every pair is evaluated twice (once per owner), so nothing is
scattered and the per-atom sums are ordinary reductions: no atomics, and a
row's sum does not depend on the block it falls in.  Per-atom conventions
as the reference: energy_i = ½ Σ_j E_ij, virial_i = ½ Σ_j (−r·E′)_ij,
force_i = Σ_j f_ij.

The pass is plain torch ops on the positions' device, as the reference's
is plain XLA: the small-N path, and the oracle the O(N) paths are held to.
"""

from __future__ import annotations

from typing import Optional

import torch

from emdee_tpu_torch.core.pbc import displacement
from emdee_tpu_torch.core.types import ALL_OUTPUTS, ENERGIES, FORCES, VIRIALS, LJParams, NonbondedOutput
from emdee_tpu_torch.neighbors.cell_dense import _box
from emdee_tpu_torch.potentials.coulomb import coulomb_interaction
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel, pair_interaction


def _outputs(block_outs, outputs: int) -> NonbondedOutput:
    """Concatenate per-block (forces, energies, virials) lists into one
    `NonbondedOutput` holding only the outputs asked for."""
    cat = lambda i: torch.cat([b[i] for b in block_outs])  # noqa: E731
    return NonbondedOutput(
        forces=cat(0) if outputs & FORCES else None,
        energies=cat(1) if outputs & ENERGIES else None,
        virials=cat(2) if outputs & VIRIALS else None,
    )


def pair_sums(dv, r2_safe, ok, energy, minus_rE, outputs: int):
    """(forces, energies, virials) of row blocks from their (B, K) pair
    terms: pairs where `ok` is False contribute exactly nothing."""
    energy = torch.where(ok, energy, 0.0)
    minus_rE = torch.where(ok, minus_rE, 0.0)
    f = torch.sum((minus_rE / r2_safe)[..., None] * dv, dim=1) if outputs & FORCES else None
    e = 0.5 * torch.sum(energy, dim=1) if outputs & ENERGIES else None
    w = 0.5 * torch.sum(minus_rE, dim=1) if outputs & VIRIALS else None
    return f, e, w


def compute_nonbonded_allpairs(
    positions: torch.Tensor,
    box,
    model: LennardJonesModel,
    params: LJParams,
    mask: Optional[torch.Tensor] = None,
    charges: Optional[torch.Tensor] = None,
    coulomb=None,
    *,
    outputs: int = ALL_OUTPUTS,
    parity_mode: bool = False,
    row_chunk: int = 512,
) -> NonbondedOutput:
    """All-pairs forces, energies and virials.

    positions (N, 3) float32; box: the cubic edge, a 0-d tensor on the
    positions' device or a number; params: per-atom (σ/2, 2√ε); mask:
    optional (N,) bool, False rows are inert padding; charges: optional
    (N,) charges, which add the DSF Coulomb terms of `coulomb`; outputs:
    the FORCES|ENERGIES|VIRIALS bitmask; parity_mode: the reference's
    beyond-cutoff quirk (potentials/lennard_jones.py); row_chunk: rows a
    block."""
    n = positions.shape[0]
    dev = positions.device
    box = _box(box, positions)
    hs, tse = params.half_sigma, params.twice_sqrt_eps
    valid = torch.ones(n, dtype=torch.bool, device=dev) if mask is None else mask
    ids = torch.arange(n, device=dev)
    blocks = []
    for start in range(0, n, row_chunk):
        rows = slice(start, min(start + row_chunk, n))
        dv = displacement(positions[rows, None, :], positions[None, :, :], box)  # (B, N, 3)
        r2 = torch.sum(dv * dv, dim=-1)
        ok = (ids[rows, None] != ids[None, :]) & valid[rows, None] & valid[None, :]
        r2_safe = torch.where(ok, r2, 1.0)
        energy, minus_rE = pair_interaction(
            r2_safe, model, hs[rows, None], tse[rows, None], hs[None, :], tse[None, :], parity_mode=parity_mode,
        )
        if charges is not None:
            e_c, mre_c = coulomb_interaction(r2_safe, coulomb, charges[rows, None], charges[None, :])
            energy = energy + e_c
            minus_rE = minus_rE + mre_c
        blocks.append(pair_sums(dv, r2_safe, ok, energy, minus_rE, outputs))
    return _outputs(blocks, outputs)
