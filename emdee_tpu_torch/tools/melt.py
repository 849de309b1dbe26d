"""The Lennard-Jones melts that `chip_smoke.py` and
`emdee_tpu_torch.tools.profile_paths` drive: FCC at ρ* = 0.8442, T* = 1.44,
rc = 2.5σ, switch 2.0σ, skin 0.35, dt = 0.005, uniform unit parameters and
masses — 29³ cells (97,556 atoms) on bench.py's wide dense config, its
straggler configs and its boundary-spill config, and 63³ cells (1,000,188
atoms, bench_all.py's 1M melt; on the grid also at M = 36, `even_config`) —
and the thermostat and barostat constants of tests/test_dense_thermostats.py.
One copy of the measured configurations for both scripts."""

from __future__ import annotations

import numpy as np

SEED = 0
N_CELLS = 29  # FCC 29³ → 97,556 atoms
N_CELLS_1M = 63  # FCC 63³ → 1,000,188 atoms
DENSITY, T0, CUTOFF, SWITCH, SKIN, DT = 0.8442, 1.44, 2.5, 2.0, 0.35, 0.005
# NVT and NPT targets (tests/test_dense_thermostats.py): T* = 1.0 with CSVR
# τ = 0.2 or Langevin friction 2.0; P* = 0.5 with Berendsen τ_P = 0.4, κ = 1.
T_NVT, TAU_T, FRICTION = 1.0, 0.2, 2.0
P_NPT, TAU_P, KAPPA = 0.5, 0.4, 1.0


def melt(device, cells: int = N_CELLS):
    """(dense state, wide config, model, params, uniform params, atoms) of
    the melt at T0 on the FCC lattice of `cells`³ unit cells; the capacity
    grows by 8 if the suggested one overflows."""
    from emdee_tpu_torch import (
        LennardJonesModel, cell_dense_init, detect_uniform_params,
        lennard_jones_atom, suggest_cell_dense_config,
    )
    from emdee_tpu_torch.utils.lattice import fcc_lattice, maxwell_boltzmann

    pos, box = fcc_lattice(cells, density=DENSITY)
    n = pos.shape[0]
    vel = maxwell_boltzmann(n, T0, seed=SEED)
    params = lennard_jones_atom(np.ones(n), np.ones(n), device=device)
    config = suggest_cell_dense_config(n, box, cutoff=CUTOFF, switch=SWITCH, skin=SKIN)
    state = cell_dense_init(pos, vel, np.ones(n), params, config, device=device)
    if bool(state.overflow):
        config = config._replace(capacity=config.capacity + 8)
        state = cell_dense_init(pos, vel, np.ones(n), params, config, device=device)
    model = LennardJonesModel.create(CUTOFF, SWITCH, device=device)
    return state, config, model, params, detect_uniform_params(params), n


def equilibrate(rollout, state, config, n: int, steps: int = 200):
    """Run `steps` NVE steps (rebin every 2) on the dense engine's
    `rollout`; return (positions, velocities) in atom order, the measured
    temperature and the rebin interval suggested at it."""
    from emdee_tpu_torch import gather_dense_atoms, suggest_rebin_interval

    state = rollout(state, num_steps=steps, rebin_every=2)
    if bool(state.overflow):
        raise AssertionError("equilibration overflow at wide capacity")
    pos, vel = gather_dense_atoms(state, n)
    t_eq = float((vel.astype(np.float64) ** 2).sum() / (3.0 * n - 3.0))
    return pos, vel, t_eq, suggest_rebin_interval(config.skin, DT, temperature=t_eq)


def even_config(state, config):
    """The config of `state` at an even cell count, for the grid meshes
    that split an axis in two: `reconfigure_dense_state(cells_multiple_of=2)`'s
    M (36 for the 1M melt), with the capacity the suggestion rule gives at
    that M (40 at 1M).  `reconfigure_dense_state` keeps the capacity
    suggested at the unrounded M (32 at M = 37), as the reference does, and
    a cell of the 1M melt passes it within 200 steps (ROADMAP fault R9)."""
    from emdee_tpu_torch import reconfigure_dense_state

    cfg = reconfigure_dense_state(state, config, cells_multiple_of=2)[1]
    mean = config.num_atoms / cfg.cells_per_dim**3
    return cfg._replace(capacity=-(-int(np.ceil(mean + 2.5 * np.sqrt(mean) + 1.0)) // 8) * 8)


def straggler_config(wide, ct_below: int, aux_capacity: int, kn: int):
    """bench.py's straggler layout around the wide config: C_t = wide −
    `ct_below`, C_w = wide + 4, A = `aux_capacity`, Kn = `kn`."""
    from emdee_tpu_torch import StragglerConfig

    return StragglerConfig(
        grid=wide._replace(capacity=wide.capacity - ct_below),
        wide_capacity=wide.capacity + 4,
        aux_capacity=aux_capacity,
        kn=kn,
    )


# Squeeze target of the spill paths: the smoke's own choice, from no
# published config.  The config users run is the suggested one alone
# (spill_target 0, bench_all.py's molecular run); on this melt a routing
# pass of it meets a cell with more arrivals than its 32 slots within the
# first hundred steps, and the sticky flag trips (`chip_smoke.py` measures
# when; tests/torch_spill_flag_witness.py runs the reference's passes on
# that rebin).  Packing toward 28 keeps four slots of headroom.
SPILL_TARGET = 28


def spill_config(wide):
    """The boundary-spill config of the melt's box,
    `suggest_cell_dense_config(spill=True)` — at 97,556 atoms M = 16, C = 32,
    ε = h − rc − skin = 0.194σ, mean occupancy 23.8 — squeezed toward
    `SPILL_TARGET` atoms a cell."""
    from emdee_tpu_torch import suggest_cell_dense_config

    config = suggest_cell_dense_config(wide.num_atoms, wide.box, CUTOFF, SWITCH, SKIN, spill=True)
    return config._replace(spill_target=SPILL_TARGET)
