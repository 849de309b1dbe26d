"""emdee_tpu_torch — the PyTorch / CUDA port of emdee_tpu for NVIDIA Hopper.

The JAX package `emdee_tpu` stays the reference; this package mirrors its
module layout, so each file here has one counterpart there.  It imports
`torch` and numpy, never JAX.

It covers the dense-cell Lennard-Jones engine (slot binning, the leapfrog
NVE rollout with Kahan-compensated drift and kick, the synced
kick-drift-kick rollout with per-block records, CSVR and Langevin NVT,
Berendsen NPT on a dynamic box, the ±1-cell shift rebin and the sort
rebin, the boundary-spill capacity mode with squeeze and
`shrink_capacity`, `reconfigure_dense_state`, the energy closure) with the
TPU engine's two force-kernel families — resident and streaming, picked by
`resolve_dense_backend` as the TPU engine picks them — and the C-tight
straggler engine on top of it, the 3-D grid-sharded engine
(`distributed/`: NVE and CSVR NVT over an (nz, ny, nx) mesh of shards, every
shard on one card or one a `torch.distributed` rank), and molecular systems
on the dense engine (`neighbors/cell_dense_molecular.py`: charges with DSF
Coulomb, exclusion tags, tag-borne bonds and the bonded terms of
`potentials/bonded.py`).  Its kernels are
hand-written CUDA for `sm_90a` (`csrc/cell_forces.cu`,
`csrc/cell_forces_streaming.cu`, `csrc/rebin_routing.cu`,
`csrc/rebin_window.cu`, `csrc/compact_window.cu`,
`csrc/straggler_forces.cu`, and the TPU probes' `csrc/probes.cu`), each
with a plain PyTorch version beside it (`neighbors/cell_kernel.py`,
`neighbors/streaming_kernel.py`, `neighbors/rebin_kernel.py`,
`neighbors/rebin_window_kernel.py`, `neighbors/compact_kernel.py`,
`neighbors/straggler_kernel.py`, `tools/probes.py`).  A wrapper
runs the plain version for CPU tensors and launches its kernel for CUDA
tensors.  Entry points build their tensors on the CUDA card unless the
caller names a device (`device="cpu"` for the CPU).
"""

from emdee_tpu_torch.core.types import ALL_OUTPUTS, ENERGIES, FORCES, VIRIALS, LJParams
from emdee_tpu_torch.neighbors.cell_dense import (
    BerendsenBarostatConfig,
    CellDenseConfig,
    CellDenseState,
    CSVRConfig,
    LangevinConfig,
    cell_dense_init,
    detect_uniform_params,
    estimate_kernel_vmem_bytes,
    gather_dense_atoms,
    gather_dense_fields,
    lj_params_from_numpy,
    make_cell_dense_sim,
    reconfigure_dense_state,
    resolve_dense_backend,
    shrink_capacity,
    state_from_numpy,
    state_to_numpy,
    suggest_cell_dense_config,
    suggest_rebin_interval,
)
from emdee_tpu_torch.neighbors.cell_dense_molecular import (
    build_exclusion_tables,
    make_exclusion_aux_fn,
    make_molecular_dense_sim,
)
from emdee_tpu_torch.neighbors.cell_dense_straggler import (
    StragglerConfig,
    StragglerState,
    gather_straggler_atoms,
    make_straggler_sim,
    straggler_init,
    suggest_straggler_config,
)
from emdee_tpu_torch.neighbors.streaming_kernel import (
    cell_forces_streaming,
    cell_forces_streaming_split,
)
from emdee_tpu_torch.potentials.bonded import (
    AngleTable,
    BondedSystem,
    BondTable,
    TorsionTable,
    bonded_from_numpy,
)
from emdee_tpu_torch.potentials.coulomb import (
    KJMOL_ANGSTROM,
    KJMOL_NM,
    DSFCoulomb,
    coulomb_from_numpy,
    coulomb_interaction,
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
    "BerendsenBarostatConfig",
    "CellDenseConfig",
    "CellDenseState",
    "CSVRConfig",
    "LangevinConfig",
    "cell_dense_init",
    "detect_uniform_params",
    "estimate_kernel_vmem_bytes",
    "gather_dense_atoms",
    "gather_dense_fields",
    "lj_params_from_numpy",
    "make_cell_dense_sim",
    "reconfigure_dense_state",
    "resolve_dense_backend",
    "shrink_capacity",
    "state_from_numpy",
    "state_to_numpy",
    "suggest_cell_dense_config",
    "suggest_rebin_interval",
    "build_exclusion_tables",
    "make_exclusion_aux_fn",
    "make_molecular_dense_sim",
    "StragglerConfig",
    "StragglerState",
    "gather_straggler_atoms",
    "make_straggler_sim",
    "straggler_init",
    "suggest_straggler_config",
    "cell_forces_streaming",
    "cell_forces_streaming_split",
    "AngleTable",
    "BondedSystem",
    "BondTable",
    "TorsionTable",
    "bonded_from_numpy",
    "KJMOL_ANGSTROM",
    "KJMOL_NM",
    "DSFCoulomb",
    "coulomb_from_numpy",
    "coulomb_interaction",
    "LennardJonesModel",
    "lennard_jones_atom",
    "pair_interaction",
]
