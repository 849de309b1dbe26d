"""emdee_tpu_torch — the PyTorch / CUDA port of emdee_tpu for NVIDIA Hopper.

The JAX package `emdee_tpu` stays the reference; this package mirrors its
module layout, so each file here has one counterpart there.  It imports
`torch` and numpy, never JAX.

This slice covers the dense-cell Lennard-Jones NVE main path: slot binning,
the leapfrog rollout with Kahan-compensated drift and kick, the ±1-cell
shift rebin and the energy closure.  Its two kernels are hand-written CUDA
for `sm_90a` (`csrc/cell_forces.cu`, `csrc/rebin_routing.cu`), each with a
plain PyTorch version beside it (`neighbors/cell_kernel.py`,
`neighbors/rebin_kernel.py`).  A wrapper runs the plain version for CPU
tensors and launches its kernel for CUDA tensors.
"""

from emdee_tpu_torch.core.types import ALL_OUTPUTS, ENERGIES, FORCES, VIRIALS, LJParams
from emdee_tpu_torch.neighbors.cell_dense import (
    CellDenseConfig,
    CellDenseState,
    cell_dense_init,
    detect_uniform_params,
    gather_dense_atoms,
    gather_dense_fields,
    make_cell_dense_sim,
    suggest_cell_dense_config,
    suggest_rebin_interval,
)
from emdee_tpu_torch.potentials.lennard_jones import (
    LennardJonesModel,
    lennard_jones_atom,
    pair_interaction,
)

__version__ = "0.1.0"

__all__ = [
    "ALL_OUTPUTS",
    "ENERGIES",
    "FORCES",
    "VIRIALS",
    "LJParams",
    "CellDenseConfig",
    "CellDenseState",
    "cell_dense_init",
    "detect_uniform_params",
    "gather_dense_atoms",
    "gather_dense_fields",
    "make_cell_dense_sim",
    "suggest_cell_dense_config",
    "suggest_rebin_interval",
    "LennardJonesModel",
    "lennard_jones_atom",
    "pair_interaction",
]
