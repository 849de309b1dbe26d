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
(`distributed/`: NVE, CSVR and Langevin NVT and Berendsen NPT over an
(nz, ny, nx) mesh of shards on either kernel family, every shard on one card
or one a `torch.distributed` rank) and the two 1-D slab engines beside it
(`distributed/domain.py`, the atom-table decomposition, and
`distributed/cell_dense_sharded.py`, slabs of cells; plain torch ops on a
(D, 1, 1) mesh), and molecular systems
on the dense engine (`neighbors/cell_dense_molecular.py`: charges with DSF
Coulomb, exclusion tags, tag-borne bonds and the bonded terms of
`potentials/bonded.py`), the molecular front door (`ForceField` and
`System` of `modelling/`, the PDB/XYZ readers of `io/` with the g++-built
parsers and graph canonicalisation of `native/`, `dense_sim_from_system`,
and the runner, checkpoints and guards of `utils/`), and the portable
engine on plain torch ops —
`State`, all-pairs, cell and neighbor lists, `make_force_fn`, and the
velocity-Verlet, CSVR, Langevin, Berendsen NPT and FIRE rollouts of
`dynamics/`.  Its kernels are
hand-written CUDA for `sm_90a` (`csrc/cell_forces.cu`,
`csrc/cell_forces_streaming.cu`, `csrc/rebin_routing.cu`,
`csrc/rebin_window.cu`, `csrc/spill_routing.cu`,
`csrc/straggler_forces.cu`, and the TPU probes' `csrc/probes.cu`), each
with a plain PyTorch version beside it (`neighbors/cell_kernel.py`,
`neighbors/streaming_kernel.py`, `neighbors/rebin_kernel.py`,
`neighbors/rebin_window_kernel.py`, `neighbors/compact_kernel.py`,
`neighbors/straggler_kernel.py`, `tools/probes.py`).  A wrapper
runs the plain version for CPU tensors and launches its kernel for CUDA
tensors.  Entry points build their tensors on the CUDA card unless the
caller names a device (`device="cpu"` for the CPU).
"""

from emdee_tpu_torch.core.types import (
    ALL_OUTPUTS,
    ENERGIES,
    FORCES,
    VIRIALS,
    LJParams,
    NonbondedOutput,
    State,
    make_state,
)
from emdee_tpu_torch.dynamics.bussi import csvr_rollout
from emdee_tpu_torch.dynamics.langevin import nvt_rollout
from emdee_tpu_torch.dynamics.minimize import FireConfig, fire_minimize
from emdee_tpu_torch.dynamics.npt import npt_rollout
from emdee_tpu_torch.dynamics.verlet import nve_rollout, velocity_verlet_step
from emdee_tpu_torch.neighbors.allpairs import compute_nonbonded_allpairs
from emdee_tpu_torch.neighbors.api import NonbondedConfig, make_force_fn
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
from emdee_tpu_torch.neighbors.cell_list import CellList, build_cell_list
from emdee_tpu_torch.neighbors.neighbor_list import NeighborList, build_neighbor_list
from emdee_tpu_torch.neighbors.cell_dense_molecular import (
    build_exclusion_tables,
    dense_sim_from_system,
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
    angle_forces_into,
    bond_forces_into,
    bonded_from_numpy,
    torsion_forces_into,
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
    pair_energy,
    pair_interaction,
)

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy imports keep `import emdee_tpu_torch` light: the modelling layer
    # pulls in XML/graph machinery only when actually used.
    if name == "ForceField":
        from emdee_tpu_torch.modelling.forcefield import ForceField

        return ForceField
    if name == "System":
        from emdee_tpu_torch.modelling.system import System

        return System
    raise AttributeError(f"module 'emdee_tpu_torch' has no attribute {name!r}")


__all__ = [
    "ALL_OUTPUTS",
    "ENERGIES",
    "FORCES",
    "VIRIALS",
    "LJParams",
    "NonbondedOutput",
    "State",
    "make_state",
    "compute_nonbonded_allpairs",
    "CellList",
    "build_cell_list",
    "NeighborList",
    "build_neighbor_list",
    "NonbondedConfig",
    "make_force_fn",
    "velocity_verlet_step",
    "nve_rollout",
    "nvt_rollout",
    "csvr_rollout",
    "npt_rollout",
    "fire_minimize",
    "FireConfig",
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
    "dense_sim_from_system",
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
    "angle_forces_into",
    "bond_forces_into",
    "bonded_from_numpy",
    "torsion_forces_into",
    "KJMOL_ANGSTROM",
    "KJMOL_NM",
    "DSFCoulomb",
    "coulomb_from_numpy",
    "coulomb_interaction",
    "LennardJonesModel",
    "lennard_jones_atom",
    "pair_energy",
    "pair_interaction",
]
