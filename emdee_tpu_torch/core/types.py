"""Core types (counterpart of emdee_tpu/core/types.py): the output bits,
`LJParams`, and the portable engine's `State` and `NonbondedOutput`.

`FORCES`/`ENERGIES`/`VIRIALS` keep the reference's output-selection bit
values (nonbonded.jl:12-14).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# Output-selection bitmask (reference: nonbonded.jl:12-14).
FORCES = 1 << 0
ENERGIES = 1 << 1
VIRIALS = 1 << 2
ALL_OUTPUTS = FORCES | ENERGIES | VIRIALS


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds its tensors on: the caller's, else
    the CUDA card.  With no card and no device named it raises, rather than
    quietly building CPU tensors; CPU callers pass ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card unless "
            "the caller names another device (pass device='cpu' for the CPU)"
        )
    return torch.device("cuda")


class LJParams(NamedTuple):
    """Per-atom Lennard-Jones parameters, pre-transformed for mixing:
    ``σᵢⱼ = half_sigma_i + half_sigma_j`` and
    ``4εᵢⱼ = twice_sqrt_eps_i * twice_sqrt_eps_j``."""

    half_sigma: torch.Tensor  # (N,) float32
    twice_sqrt_eps: torch.Tensor  # (N,) float32


_TORCH_DTYPES = {np.float32: torch.float32, np.int32: torch.int32, np.bool_: torch.bool}


def _tensor(a, dtype, device) -> torch.Tensor:
    """Copy an array-like (numpy, list, tensor) into a tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=_TORCH_DTYPES[dtype])
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(device)


def _f32(x) -> float:
    """A Python float holding exactly the float32 value of `x`."""
    return float(np.float32(x))


class NonbondedOutput(NamedTuple):
    """Per-atom nonbonded results, each None unless its output bit was
    asked for.  Each atom of a pair receives half of the pair energy E and
    half of the pair virial −r·dE/dr: total potential energy =
    sum(energies), total scalar virial W = sum(virials)."""

    forces: Optional[torch.Tensor] = None  # (N, 3) float32
    energies: Optional[torch.Tensor] = None  # (N,) float32
    virials: Optional[torch.Tensor] = None  # (N,) float32


class State(NamedTuple):
    """Dynamical state of the portable engine: tensors on one device.

    `box` is a 0-d float32 tensor (the cubic edge L), `step` a 0-d int32
    tensor.  `rng` is the generator the stochastic steps draw from, on the
    state's device, or None; it is advanced in place by every draw."""

    positions: torch.Tensor  # (N, 3) float32
    velocities: torch.Tensor  # (N, 3) float32
    box: torch.Tensor  # () float32
    masses: torch.Tensor  # (N,) float32
    step: torch.Tensor  # () int32
    rng: Optional[torch.Generator] = None

    @property
    def num_atoms(self) -> int:
        return self.positions.shape[0]


def make_state(positions, velocities=None, box=1.0, masses=None, step=0, rng=None, device=None) -> State:
    """Build a `State` on `device` (by default the CUDA card,
    `resolve_device`), filling velocity and mass defaults (zeros, ones).
    rng: a `torch.Generator` on that device, or None."""
    device = resolve_device(device)
    positions = _tensor(positions, np.float32, device)
    if positions.dim() != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions must be (N, 3), got {tuple(positions.shape)}")
    n = positions.shape[0]
    velocities = torch.zeros_like(positions) if velocities is None else _tensor(velocities, np.float32, device)
    masses = positions.new_ones(n) if masses is None else _tensor(masses, np.float32, device)
    if rng is not None and torch.device(rng.device).type != device.type:
        raise ValueError(f"rng is a generator on {rng.device}, the state lives on {device}")
    return State(
        positions=positions,
        velocities=velocities,
        box=_tensor(box, np.float32, device).reshape(()),
        masses=masses,
        step=torch.full((), int(step), dtype=torch.int32, device=device),
        rng=rng,
    )


_STATE_FIELDS = {"positions": np.float32, "velocities": np.float32, "box": np.float32,
                 "masses": np.float32, "step": np.int32}


def state_from_numpy(fields: dict, device, rng=None) -> State:
    """Port `State` from the fields of a JAX `State` taken to the host
    (`jax.device_get(state)._asdict()`), bit for bit.  The JAX rng key does
    not cross: the port's generator is `rng`."""
    return State(**{name: _tensor(fields[name], dt, device) for name, dt in _STATE_FIELDS.items()}, rng=rng)


def state_to_numpy(state: State) -> dict:
    """Inverse of `state_from_numpy`: the array fields as numpy arrays,
    keyed by the JAX `State`'s field names (no rng)."""
    return {name: getattr(state, name).detach().cpu().numpy() for name in _STATE_FIELDS}
