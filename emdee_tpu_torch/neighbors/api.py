"""User-facing nonbonded force-function factory (counterpart of
emdee_tpu/neighbors/api.py).

`make_force_fn` picks and wires a nonbonded method:

- ``allpairs``      — masked O(N²); exact, for small N; the reference-parity
                      path (parity_mode);
- ``neighbor_list`` — a Verlet list with a skin, built through the cell
                      list and rebuilt when some atom has moved skin/2; O(N);
- ``auto``          — the neighbor list when the box holds ≥ 5 half-cutoff
                      cells a side and N ≥ 256, else all-pairs.

The port's hand-written CUDA path is the dense-cell engine
(`emdee_tpu_torch.neighbors.cell_dense.make_cell_dense_sim`), which owns its
own state layout.

The returned `Nonbonded` bundle:
  init(positions)                  → aux   (capacities doubled on overflow)
  compute(positions, aux, outputs) → NonbondedOutput
  update(positions, aux)           → aux   (the rebuild when the skin is spent)
  force_fn(positions, box, aux)    → (forces, aux)  — the integrator hook

The reference decides the rebuild on the device (`lax.cond`).  Eager
PyTorch cannot branch on a device value, so `update` reads the one flag
`needs_rebuild` on the host: one host wait a force evaluation on the
neighbor list, counted in `HOST_READS` (the rebuilds in `REBUILDS`).  The
overflow flag stays on the device and is sticky across rebuilds: read it
once after a rollout.

As in the reference, the box is bound when the bundle is made: `compute`,
`update`, the rebuild and the exclusion correction use that box, while
`force_fn`'s pair pass uses the box it is given (ROADMAP fault R10).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from emdee_tpu_torch.core.types import ALL_OUTPUTS, FORCES, LJParams, resolve_device
from emdee_tpu_torch.neighbors.allpairs import compute_nonbonded_allpairs
from emdee_tpu_torch.neighbors.cell_list import cells_per_dimension, suggest_capacity
from emdee_tpu_torch.neighbors.neighbor_force import (
    apply_exclusion_corrections,
    compute_nonbonded_neighborlist,
    exclusion_plan,
)
from emdee_tpu_torch.neighbors.neighbor_list import (
    NeighborList,
    build_neighbor_list,
    estimate_max_neighbors,
    needs_rebuild,
)
from emdee_tpu_torch.potentials.coulomb import DSFCoulomb
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel

# Host reads of the rebuild flag and rebuilds done by `update`, over every
# bundle in the process (set to 0 before a run to count its own).
HOST_READS = 0
REBUILDS = 0


@dataclasses.dataclass(frozen=True)
class NonbondedConfig:
    """Static nonbonded configuration."""

    cutoff: float
    switch: float  # switching-function onset radius (rs < rc)
    method: str = "auto"  # allpairs | neighbor_list | auto
    skin: float = 0.0  # Verlet buffer; 0 → 0.1·cutoff for the list method
    ndiv: int = 2  # cells per cutoff (cells.jl:36 geometry)
    cell_capacity_multiplier: float = 1.6
    neighbor_multiplier: float = 1.4
    max_neighbors: Optional[int] = None  # None → density estimate
    parity_mode: bool = False  # reproduce the reference's beyond-rc quirk
    coulomb_alpha: float = 0.2  # DSF damping (used when charges are given)
    coulomb_constant: float = 1.0  # e²/4πε0 in simulation units

    def __post_init__(self):
        if self.switch >= self.cutoff:
            raise ValueError("switch must be < cutoff")
        if self.method == "pallas":
            raise ValueError(
                "the port's kernel path is the dense-cell engine — use "
                "emdee_tpu_torch.neighbors.cell_dense.make_cell_dense_sim(backend='auto') or, with "
                "charges and exclusions, cell_dense_molecular.make_molecular_dense_sim"
            )
        if self.method not in ("auto", "allpairs", "neighbor_list"):
            raise ValueError(f"unknown nonbonded method {self.method!r}")
        if self.parity_mode and self.method not in ("allpairs", "auto"):
            raise ValueError("parity_mode requires the all-pairs method")

    @property
    def effective_skin(self) -> float:
        return self.skin if self.skin > 0 else 0.1 * self.cutoff

    def list_geometry(self, box: float) -> tuple:
        """(list_cutoff, cells_per_dim) of the cell grid behind the list."""
        list_cutoff = self.cutoff + self.effective_skin
        return list_cutoff, cells_per_dimension(box, list_cutoff, self.ndiv)


class Nonbonded(NamedTuple):
    config: NonbondedConfig
    model: LennardJonesModel
    init: Callable  # positions → aux
    compute: Callable  # (positions, aux, outputs=) → NonbondedOutput
    update: Callable  # (positions, aux) → aux
    force_fn: Callable  # (positions, box, aux) → (forces, aux)


def resolve_method(config: NonbondedConfig, box: float, num_atoms: int) -> str:
    method = config.method
    if method == "auto":
        _, m = config.list_geometry(box)
        method = "neighbor_list" if (m >= 2 * config.ndiv + 1 and num_atoms >= 256) else "allpairs"
    return method


def make_force_fn(
    config: NonbondedConfig,
    params: LJParams,
    box: float,
    num_atoms: int,
    exclusion_pairs=None,
    exclusion_scales=None,
    charges=None,
    exclusion_scales_coulomb=None,
    device=None,
) -> Nonbonded:
    """Build the nonbonded bundle for a fixed (box, N) problem on `device`
    (by default the CUDA card; `device="cpu"` for the CPU).

    With `charges`, DSF Coulomb (potentials/coulomb.py) joins every pair
    evaluation, with its own 1-4 scales in `exclusion_scales_coulomb`."""
    device = resolve_device(device)
    model = LennardJonesModel.create(config.cutoff, config.switch, device=device)
    method = resolve_method(config, box, num_atoms)
    f32 = lambda a: None if a is None else torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    params = LJParams(*(f32(p) for p in params))
    box_t = torch.full((), box, dtype=torch.float32, device=device)
    has_exclusions = exclusion_pairs is not None and len(exclusion_pairs) > 0
    if has_exclusions:
        exclusion_pairs = torch.as_tensor(exclusion_pairs, dtype=torch.int64, device=device)
        if exclusion_scales is None:
            exclusion_scales = torch.zeros(len(exclusion_pairs), dtype=torch.float32, device=device)
        exclusion_scales, exclusion_scales_coulomb = f32(exclusion_scales), f32(exclusion_scales_coulomb)
        plan = exclusion_plan(exclusion_pairs, num_atoms)
    coulomb = None
    if charges is not None:
        if config.parity_mode:
            raise ValueError("parity_mode is LJ-only (the reference has no electrostatics)")
        charges = f32(charges)
        coulomb = DSFCoulomb.create(config.cutoff, config.coulomb_alpha, config.coulomb_constant, device=device)

    def _correct(out, positions, outputs):
        if not has_exclusions:
            return out
        return apply_exclusion_corrections(
            out, positions, box_t, model, params, exclusion_pairs, exclusion_scales,
            charges, coulomb, exclusion_scales_coulomb, outputs=outputs, plan=plan,
        )

    if method == "allpairs":

        def init(positions):
            return ()

        def compute(positions, aux=(), *, outputs=ALL_OUTPUTS):
            out = compute_nonbonded_allpairs(positions, box_t, model, params, None, charges, coulomb,
                                             outputs=outputs, parity_mode=config.parity_mode)
            return _correct(out, positions, outputs)

        def update(positions, aux=()):
            return aux

        def force_fn(positions, box_, aux=()):
            out = compute_nonbonded_allpairs(positions, box_, model, params, None, charges, coulomb,
                                             outputs=FORCES, parity_mode=config.parity_mode)
            return _correct(out, positions, FORCES).forces, aux

        return Nonbonded(config, model, init, compute, update, force_fn)

    skin = config.effective_skin
    list_cutoff, m = config.list_geometry(box)
    if m < 2 * config.ndiv + 1:
        raise ValueError(
            f"box {box} too small for cell lists at cutoff {list_cutoff} (M={m}); use method='allpairs'"
        )
    cell_cap = suggest_capacity(num_atoms, m**3, config.cell_capacity_multiplier)
    max_nbrs = config.max_neighbors or estimate_max_neighbors(num_atoms, box, list_cutoff, config.neighbor_multiplier)

    def _build(positions, cap_cell, cap_nbrs):
        return build_neighbor_list(positions, box_t, list_cutoff, cells_per_dim=m, cell_capacity=cap_cell,
                                   max_neighbors=cap_nbrs, ndiv=config.ndiv)

    def init(positions) -> NeighborList:
        cap_cell, cap_nbrs = cell_cap, max_nbrs
        for _ in range(8):  # host-side capacity doubling on overflow
            nbrs = _build(positions, cap_cell, cap_nbrs)
            if not bool(nbrs.overflow):
                return nbrs
            cap_cell *= 2
            cap_nbrs *= 2
        raise RuntimeError("neighbor-list capacity overflow persisted after doubling")

    def update(positions, nbrs: NeighborList) -> NeighborList:
        """Rebuild when some atom has moved more than skin/2: the one host
        read of the step."""
        global HOST_READS, REBUILDS
        HOST_READS += 1
        if not bool(needs_rebuild(nbrs, positions, box_t, skin)):
            return nbrs
        REBUILDS += 1
        new = _build(positions, nbrs.cell_capacity, nbrs.max_neighbors)
        # Sticky overflow: one overflowed rebuild anywhere in a rollout
        # must survive to the check after it.
        return new._replace(overflow=new.overflow | nbrs.overflow)

    def compute(positions, nbrs: NeighborList, *, outputs=ALL_OUTPUTS):
        out = compute_nonbonded_neighborlist(positions, box_t, model, params, nbrs, charges, coulomb,
                                             outputs=outputs)
        return _correct(out, positions, outputs)

    def force_fn(positions, box_, nbrs: NeighborList):
        nbrs = update(positions, nbrs)
        out = compute_nonbonded_neighborlist(positions, box_, model, params, nbrs, charges, coulomb, outputs=FORCES)
        return _correct(out, positions, FORCES).forces, nbrs

    return Nonbonded(config, model, init, compute, update, force_fn)
