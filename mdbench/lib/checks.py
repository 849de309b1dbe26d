"""What decides `correct`: the program's outputs at the end of the window held
against the plain reference (`mdbench/reference/`), which is handed the same
inputs and reads the program's outputs only to judge them.

The numbers, each with a limit of the cell's own (`limits/<cell>.json`):
- `cell_faults`: atoms the window's end state holds other than once, held
  in a cell farther than skin/2 from their stored coordinates, or an
  overflow flag set (exact: limit 0).  The coordinates are taken as stored,
  with no periodic image: the program's kernels take a pair's periodic
  shift from the two cells' indices, so an atom stored a box away from its
  cell is an atom misplaced;
- `pe_err`, `vir_err`: the potential energy and virial that the runner's
  energy pass gave at the window's last chunk, against the reference's at
  the same positions: the gap over |E| and over the sum of |r.F| of the
  terms;
- `stretch_dv`: from the window's end state the program runs a short
  stretch of steps through the same runner and closures; the reference
  integrates the same steps from the same positions and velocities (with
  the thermostat's draws from a copy of the same generator); the largest gap
  between an atom's two velocities over the largest change of an atom's
  velocity in the reference;
- `energy_drift`, in NVE only: the size of the least-squares slope of the
  total energy per atom over simulated time, through the runner's energy
  passes at the window's chunk ends.  The control reads it over
  CONTROL_DRIFT_STEPS steps from the end state, as the window is far longer
  than the reference can follow.
A number that its limits file does not name is printed but not compared.
"""

from __future__ import annotations

import math

import torch

from mdbench.reference.forces import evaluate
from mdbench.reference.integrate import velocity_verlet


def gather(state, num_atoms: int):
    """(positions, velocities) in atom order from the program's slot state."""
    valid = state.valid.reshape(-1)
    ids = state.atom_id.reshape(-1)[valid].long()
    out = []
    for field in (state.positions, state.velocities):
        a = torch.zeros((num_atoms, 3), dtype=field.dtype, device=field.device)
        a[ids] = field.reshape(-1, 3)[valid]
        out.append(a)
    return out


CONTROL_DRIFT_STEPS = 60


def drift_slope(points, num_atoms: int, dt: float) -> float:
    """Least-squares slope of total energy / num_atoms against simulated
    time over [(step, total energy)], or nan with fewer than 3 points."""
    if len(points) < 3:
        return math.nan
    t = torch.tensor([step * dt for step, _ in points], dtype=torch.float64)
    e = torch.tensor([total / num_atoms for _, total in points], dtype=torch.float64)
    t = t - t.mean()
    return float((t * (e - e.mean())).sum() / (t * t).sum())


def cell_faults(state, geometry: dict, num_atoms: int) -> int:
    """Atoms held other than once, or in a cell more than skin/2 from their
    stored coordinates (the distance to the cell's extent, no periodic
    image), plus 1 for a set overflow flag."""
    valid = state.valid.reshape(state.valid.shape[0], -1)
    ids = state.atom_id.reshape(valid.shape)[valid].long()
    faults = int((ids >= num_atoms).sum()) + int((ids < 0).sum())
    ids = ids[(ids >= 0) & (ids < num_atoms)]
    faults += int((torch.bincount(ids, minlength=num_atoms) != 1).sum())
    m, box = geometry["cells_per_dim"], geometry["box"]
    h = box / m
    c = torch.arange(m**3, device=valid.device)
    lo = torch.stack([c % m, (c // m) % m, c // (m * m)], -1).double() * h  # (M^3, 3)
    u = state.positions.double() - (lo[:, None, :] + 0.5 * h)
    excess = torch.clamp(u.abs() - 0.5 * h, min=0.0)
    far = (excess * excess).sum(-1).sqrt() > 0.5 * geometry["skin"] + 4e-7 * box  # float32 rounding of the box
    return faults + int((far & valid).sum()) + int(bool(state.overflow))


class Reference:
    """The reference's readings at the window's end state, computed once and
    held against the program's outputs or the control's."""

    def __init__(self, sim, end_pos, end_vel, steps: int, gen_state):
        self.sim, self.steps, self.gen_state = sim, steps, gen_state
        self.pos, self.vel = end_pos.double(), end_vel.double()
        self.start = evaluate(self.pos, sim.forcefield)
        _, self.v_end = velocity_verlet(self.pos, self.vel, sim.forcefield, sim.dt, steps, csvr=sim.csvr,
                                        rng=self._rng(), f0=self.start.forces)

    def _rng(self):
        if self.gen_state is None:
            return None
        rng = torch.Generator(device=self.pos.device)
        rng.set_state(self.gen_state)
        return rng

    def numbers(self, pe: float, vir: float, stretch_vel: torch.Tensor) -> dict:
        change = float((self.v_end - self.vel).norm(dim=-1).max())
        gap = float((stretch_vel.double() - self.v_end).norm(dim=-1).max())
        return {
            "pe_err": abs(pe - self.start.energy) / abs(self.start.energy),
            "vir_err": abs(vir - self.start.virial) / self.start.virial_scale,
            "stretch_dv": gap / change if change > 0 else math.inf,
        }

    def control(self, dtype=torch.bfloat16) -> dict:
        """The numbers of the reference itself put in the program's place,
        its force arithmetic in `dtype`: what a comparison has to fail."""
        sim = self.sim
        low = evaluate(self.pos.float(), sim.forcefield, dtype)
        _, v = velocity_verlet(self.pos, self.vel, sim.forcefield, sim.dt, self.steps, dtype=dtype, csvr=sim.csvr,
                               rng=self._rng())
        numbers = self.numbers(low.energy, low.virial, v)
        if sim.csvr is None:
            totals = []
            velocity_verlet(self.pos, self.vel, sim.forcefield, sim.dt, CONTROL_DRIFT_STEPS, dtype=dtype,
                            totals=totals)
            numbers["energy_drift"] = abs(drift_slope(totals, sim.num_atoms, sim.dt))
        return numbers


def program_numbers(ref: Reference, out: dict, record: dict) -> dict:
    """The numbers of the program's run, held against the reference `ref`:
    `out` as `run.outputs` reads it, `record` as the window's wrappers keep
    it."""
    sim = ref.sim
    numbers = dict(ref.numbers(out["pe"], out["vir"], out["stretch_vel"]), cell_faults=out["cell_faults"])
    if sim.csvr is None:
        points = [(steps, float(pe) + float(ke)) for steps, (pe, _, ke) in record["energies"]]
        numbers["energy_drift"] = abs(drift_slope(points, sim.num_atoms, sim.dt))
    return numbers


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)] of the numbers the limits name)."""
    rows = [(k, numbers.get(k, math.nan), float(v)) for k, v in limits.items()]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
