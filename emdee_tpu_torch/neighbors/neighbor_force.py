"""Nonbonded forces, energies and virials over a padded neighbor list
(counterpart of emdee_tpu/neighbors/neighbor_force.py).

The O(N) pass is a per-atom gather of the neighbors' positions and
parameters, the pair functions, and a sum over the neighbor axis; the pad
id N gathers an inert sentinel row, and its terms are masked to zero.

Exclusions (bonded 1-2/1-3 pairs, scaled 1-4 pairs) are handled by
correction: the pair pass counts every pair inside the cutoff, and
`apply_exclusion_corrections` subtracts (1 − scale) of each excluded pair's
contribution.  Its scatter-add runs through core/scatter.py's fixed-order
add, so reruns are bitwise equal on every device.
"""

from __future__ import annotations

from typing import Optional

import torch

from emdee_tpu_torch.core.pbc import displacement
from emdee_tpu_torch.core.scatter import AddPlan, add_plan, fixed_add
from emdee_tpu_torch.core.types import ALL_OUTPUTS, ENERGIES, FORCES, VIRIALS, LJParams, NonbondedOutput
from emdee_tpu_torch.neighbors.allpairs import _outputs, pair_sums
from emdee_tpu_torch.neighbors.cell_dense import _box
from emdee_tpu_torch.neighbors.neighbor_list import NeighborList
from emdee_tpu_torch.potentials.coulomb import coulomb_interaction
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel, pair_interaction


def _ext(a: torch.Tensor) -> torch.Tensor:
    """`a` with a zero row N appended: the sentinel the pad id gathers."""
    return torch.cat([a, a.new_zeros((1,) + tuple(a.shape[1:]))])


def compute_nonbonded_neighborlist(
    positions: torch.Tensor,
    box,
    model: LennardJonesModel,
    params: LJParams,
    nbrs: NeighborList,
    charges: Optional[torch.Tensor] = None,
    coulomb=None,
    *,
    outputs: int = ALL_OUTPUTS,
    atom_chunk: int = 32768,
) -> NonbondedOutput:
    """Forces, energies and virials from an (N, K) neighbor table, in atom
    blocks of `atom_chunk`.  The full-shell list holds each pair twice, so
    energy_i = ½ Σ_j E_ij and virial_i = ½ Σ_j (−r·E′)_ij split each pair's
    terms in halves, as the reference does.  A row's sums do not depend on
    its block; blocks of the reference's 8,192 atoms leave the pass
    launch-bound on the H100 (`tools/profile_paths.py portable` times both)."""
    n = positions.shape[0]
    box = _box(box, positions)
    hs, tse = params.half_sigma, params.twice_sqrt_eps
    pos_ext, hs_ext, tse_ext = _ext(positions), _ext(hs), _ext(tse)
    q_ext = None if charges is None else _ext(charges)
    blocks = []
    for start in range(0, n, atom_chunk):
        rows = slice(start, min(start + atom_chunk, n))
        jdx = nbrs.idx[rows].long()  # (B, K)
        valid = jdx < n
        dv = displacement(positions[rows, None, :], pos_ext[jdx], box)
        r2_safe = torch.where(valid, torch.sum(dv * dv, dim=-1), 1.0)
        energy, minus_rE = pair_interaction(r2_safe, model, hs[rows, None], tse[rows, None], hs_ext[jdx], tse_ext[jdx])
        if charges is not None:
            e_c, mre_c = coulomb_interaction(r2_safe, coulomb, charges[rows, None], q_ext[jdx])
            energy = energy + e_c
            minus_rE = minus_rE + mre_c
        blocks.append(pair_sums(dv, r2_safe, valid, energy, minus_rE, outputs))
    return _outputs(blocks, outputs)


def exclusion_plan(exclusion_pairs: torch.Tensor, num_atoms: int) -> AddPlan:
    """The fixed-order add plan of `apply_exclusion_corrections`' rows
    (every pair's i row, then every pair's j row), built once from the
    static pair list.  Pad pairs (N, N) target atom N − 1 with rows of
    exact zeros, as in the reference."""
    p = torch.clamp(exclusion_pairs.long(), max=num_atoms - 1)
    return add_plan(torch.cat([p[:, 0], p[:, 1]]), num_atoms)


def apply_exclusion_corrections(
    out: NonbondedOutput,
    positions: torch.Tensor,
    box,
    model: LennardJonesModel,
    params: LJParams,
    exclusion_pairs: torch.Tensor,  # (P, 2) integer, i ≠ j; may hold (N, N) padding
    exclusion_scales: torch.Tensor,  # (P,) float32 — 0 excludes fully, lj14scale for 1-4
    charges: Optional[torch.Tensor] = None,
    coulomb=None,
    exclusion_scales_coulomb: Optional[torch.Tensor] = None,  # (P,) — coulomb14scale for 1-4
    *,
    outputs: int = ALL_OUTPUTS,
    plan: Optional[AddPlan] = None,
) -> NonbondedOutput:
    """Subtract (1 − scale) of each excluded pair's contribution from `out`.

    Pairs beyond the cutoff contribute zero in the pair pass and receive
    zero correction.  LJ and Coulomb carry their own 1-4 scales (the
    Coulomb scales default to the LJ ones).  `plan` is `exclusion_plan` of
    the pairs; callers that correct every step build it once."""
    n = positions.shape[0]
    pairs = exclusion_pairs.long()
    pi = torch.clamp(pairs[:, 0], max=n - 1)
    pj = torch.clamp(pairs[:, 1], max=n - 1)
    real = (pairs[:, 0] < n) & (pairs[:, 1] < n)
    if plan is None:
        plan = exclusion_plan(exclusion_pairs, n)

    dv = displacement(positions[pi], positions[pj], _box(box, positions))
    r2_safe = torch.where(real, torch.sum(dv * dv, dim=-1), 1.0)
    energy, minus_rE = pair_interaction(
        r2_safe, model, params.half_sigma[pi], params.twice_sqrt_eps[pi],
        params.half_sigma[pj], params.twice_sqrt_eps[pj],
    )
    energy = torch.where(real, (1.0 - exclusion_scales) * energy, 0.0)
    minus_rE = torch.where(real, (1.0 - exclusion_scales) * minus_rE, 0.0)
    if charges is not None:
        scales_c = exclusion_scales if exclusion_scales_coulomb is None else exclusion_scales_coulomb
        e_c, mre_c = coulomb_interaction(r2_safe, coulomb, charges[pi], charges[pj])
        energy = energy + torch.where(real, (1.0 - scales_c) * e_c, 0.0)
        minus_rE = minus_rE + torch.where(real, (1.0 - scales_c) * mre_c, 0.0)

    forces, energies, virials = out.forces, out.energies, out.virials
    if outputs & FORCES and forces is not None:
        f_ij = (minus_rE / r2_safe)[:, None] * dv
        forces = fixed_add(forces, plan, torch.cat([-f_ij, f_ij]))
    if outputs & ENERGIES and energies is not None:
        energies = fixed_add(energies, plan, torch.cat([-0.5 * energy] * 2))
    if outputs & VIRIALS and virials is not None:
        virials = fixed_add(virials, plan, torch.cat([-0.5 * minus_rE] * 2))
    return NonbondedOutput(forces=forces, energies=energies, virials=virials)
