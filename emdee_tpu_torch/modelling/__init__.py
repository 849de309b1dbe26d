"""The modelling layer (counterpart of emdee_tpu/modelling/): force-field
XML, structure files → typed systems, bonded tables."""

from emdee_tpu_torch.modelling.forcefield import ForceField
from emdee_tpu_torch.modelling.system import System

__all__ = ["ForceField", "System"]
