"""Structure and trajectory files (counterpart of emdee_tpu/io/): numpy
only."""

from emdee_tpu_torch.io.pdb import PDBFrame, read_pdb, write_pdb
from emdee_tpu_torch.io.xyz import XYZTrajectoryWriter, read_xyz, write_xyz

__all__ = [
    "read_xyz",
    "write_xyz",
    "XYZTrajectoryWriter",
    "read_pdb",
    "write_pdb",
    "PDBFrame",
]
