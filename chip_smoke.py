#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`emdee_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py [--save-spill-flag FILE]

It builds the CUDA kernels from `emdee_tpu_torch/csrc/`, holds each kernel
against its plain PyTorch version on the card, then drives these paths of
the LJ melt (FCC at ρ* = 0.8442, T* = 1.44, rc = 2.5σ, switch 2.0σ, skin
0.35, dt = 0.005):

- the dense-cell engine on the 97,556-atom melt (FCC 29³) at bench.py's
  wide config, through `cell_dense_init` and `make_cell_dense_sim`
  (equilibrates the melt 200 steps first), where `backend="auto"` resolves
  to the resident kernel family;
- the portable engine (`make_force_fn`, the dynamics of
  `emdee_tpu_torch/dynamics`; plain torch ops, no kernel) from the
  equilibrated melt at the README example's config (cutoff 2.5, switch 2.0,
  skin 0.3; 'auto' asserted to resolve to the neighbor list): its forces,
  energies and virials against K2b's by atom id (rtol 1e-4, atol 5e-4);
  NVE 1,000 steps (drift ≤ 1e-4, overflow false, exactly one host read a
  step — the rebuild flag — counted by `update` and by the card's sync
  warnings, no kernel launched, bitwise reruns); CSVR and Langevin, ten
  blocks of 100 (mean T* of the last five within 2%), Berendsen NPT on the
  CSVR step on a list that follows the box (200 steps: the pressure gap
  shrinks, the box moves the way the pressure says, the list's virial at
  the end box matches all-pairs'; `make_force_fn`'s own list at that box,
  on the first box's geometry, measured: ROADMAP fault R10); on a
  jittered FCC 14³ (10,976 atoms) all-pairs
  against the list, LJ and DSF (rtol 1e-4, atol 2e-4), and FIRE (1,000
  steps, max |F| below 2% of its start); the exclusion corrections on the
  864-atom charged fixture (bitwise reruns);
- the boundary-spill capacity mode on the same melt (M = 16, C = 32,
  squeezed toward 28 atoms a cell, this script's own choice; the script
  also measures how long the suggested capacity alone, the config users
  run, lasts before its flag trips), re-initialised from the equilibrated
  melt: NVE on the component carry and a short stacked per-atom run, every
  rebin through the spill route and the window-compaction kernel (K7);
  before it, the force kernels on a 1,500-atom spill init that stores
  atoms across the periodic seam;
- NVT with CSVR (T* = 1.0, τ = 0.2) on the wide config and with Langevin
  (friction 2.0) on the spill config, 1,000 steps each with per-block
  records, and NPT (CSVR + Berendsen P* = 0.5, τ_P = 0.4) on the wide
  config from the CSVR state, then `reconfigure_dense_state` on its end;
- F1, the streaming family above three centre slots a lane: the
  equilibrated melt at M = 12, C = 104, where 'auto' must resolve to the
  streaming family (the TPU engine's estimate passes 13 MB): K5's chunked
  variant, both entries, against plain, and 200 gated NVE steps; after the
  water phases, the water box at C = 104 on 'auto': K5c against plain;
- the C-tight straggler engine at bench.py's production config (C_t =
  wide−4, C_w = wide+4, A = 64, Kn = 16), through `straggler_init` and
  `make_straggler_sim`, from the equilibrated melt, and its gather pass
  (strag_pass="xla"), whose reactions go through the fixed-order add;
- the molecular dense engine: the force kernel's molecular branches (K2c:
  DSF Coulomb, exclusion tags, tag-borne bonds) against their plain
  version on the 864-atom charged fixture of tests/test_pallas_kernel.py
  and on the water box; the triatomic fixture of
  tests/test_grid_sharded_pallas.py (leftover pairs, shared and exclusive
  terms) on 'cuda'; and the 98,304-atom flexible-TIP3P water box of
  `emdee_tpu_torch/tools/water.py` (bench_all.py's molecular run config:
  cutoff 7 Å, switch 6, skin 1, dt 5e-4, DSF α = 0.2, spill geometry M = 12,
  C = 64, asserted to resolve to the resident family under 'auto') through
  `cell_dense_init(charges=...)` and `make_molecular_dense_sim`:
  equilibrated 2,000 steps with CSVR at 300 K on the plain config that
  holds its lattice start (M = 12, C = 80, 'cuda' named), then
  re-initialised on the spill config; the gated 600-step window runs there
  if its flag holds, else on the plain config, with the flag's cause
  logged; then 'cuda' (bonds in K2c) against 'torch' (bonds on the gather
  path) after 20 steps;
- the molecular front door on the same box (`phase_modelling`): written as
  a PDB, typed by `ForceField` (`emdee_tpu_torch/data/tip3p_flexible.xml`)
  and `System` with the native library asserted loaded, its tables equal to
  the hand-built box's; `dense_sim_from_system` on 'auto' with CSVR at 300
  K (asserted to resolve to the streaming family, K5c): K5c vs plain, the
  total forces vs the hand-built box's at the same positions and masses;
  2,000 equilibration steps, then `run_dense_simulation` (4 chunks of 500
  steps, XYZ dumps and checkpoints, exact K5c and K4 launches) and a bitwise
  resume from the checkpoint with its generator; the System at the run's
  end on 'cuda' (K2c): K2c vs plain and a gated 500-step NVE chunk;
- the streaming kernel's molecular pass (K5c) against its plain version
  (K2c's) and against K2c on the 864-atom fixture and on the water box,
  and the water box on `backend="auto"`, asserted to resolve to the
  streaming family at the plain config: a gated 600-step NVE window, 20
  steps against 'cuda' and 'torch'; K5c's times beside its times before
  the redesign (from PERF.md), and its registers, shared bytes and resident
  blocks an SM as the card reports them;
- the water box on the grid-sharded engine (K2c-G: the GHOST mode with
  DSF and the tags; bonds and angles as term rows) on (1,1,1) and (2,2,2):
  pair forces bit for bit the one-card K2c-q's, total forces of the two
  decompositions bitwise equal, the energy against the one-card closure,
  a gated 600-step window on (2,2,2); the triatomic fixture on (2,2,2)
  against the one-card 'torch' engine, and on a one-rank NCCL `DistMesh`;
- the 3-D grid-sharded engine (`emdee_tpu_torch.distributed`, every shard
  on this card, `LocalMesh`) on the equilibrated melt: (1,1,1) at the main
  path's config (M = 17, C = 32), then at the config
  `reconfigure_dense_state(cells_multiple_of=2)` gives (M = 16) on (1,1,1),
  (2,2,2) and (2,4,1), each gated like the main path and bitwise equal to
  the others, with forces bit for bit the one-card kernel's, and K2-G's
  time beside its time before the redesign, its bound and resources; the (1,1,1)
  run also through a one-rank NCCL `DistMesh`, and a short CSVR run; before
  it, the window rebin kernel (K6) vs its plain version and vs K4;
- the dense-cell engine on bench_all.py's 1,000,188-atom melt (FCC 63³,
  M = 37, C = 32), where `backend="auto"` resolves to the streaming kernel
  family (equilibrated 200 steps at rebin every 2; bench_all.py settles
  100), and a short stacked per-atom rollout at the same size;
- the 985,527-atom water box (69³ waters, M = 26, C = 88) on
  `backend="auto"` (K5c): one K5c and one K2c launch timed and held to
  each other, and a gated 200-step NVE window from the lattice start;
- the grid engine's streaming family (K5s: the streaming kernel's GHOST
  mode and the reverse fold) at full width: the 1M melt on (1,1,1), M = 37,
  C = 32, through `backend="auto"` (asserted to resolve to K5s; 1,000 gated
  steps), and at M = 36 on (2,1,1) (`'auto'`, K5s) and (2,2,2)
  (`backend="cuda_streaming"` named), each against K5s's plain version,
  the one-card K5 and the other decompositions, then (2,2,2) at M = 36 on
  'auto', which picks the resident family there: K2-G (the LJ pass's GHOST
  mode) bit for bit the one-card K2a/K2b, against plain, its time beside
  its time before the redesign, 200 gated steps; K7-G's one-launch form at
  the 1M melt's spill config (M = 35, C = 32; more rows than resident
  warps) on (1,1,1) and (5,7,1), drifted and crowded, vs its plain version
  and the per-pass form, and its time; the 985,527-atom water box
  on (2,2,2) `'auto'` (K5s-mol; 200 gated steps from the lattice start);
- the grid's Langevin and Berendsen NPT (on K2-G's and on K5s's energy
  pass) on the 97,556-atom melt at (2,2,2), M = 16, and
  `reconfigure_grid_state` on the NPT end state;
- spill configs on the grid engine (`phase_grid_spill`): the melt's spill
  config (M = 16, C = 32, squeezed toward 28) from its spill init, its
  rebin through K7-G: the one-launch form (all three passes in one
  cooperative launch, neighbour shards' rows read in place; the engine's
  route on this card) vs its plain version and vs the per-pass form (a
  pass a launch over two-layer halo planes, the route across ranks), and
  the per-pass form vs its plain version, on (1,1,1), (2,2,2) and (2,4,1),
  drifted and with the y pass overflowing, and on (1,1,1) both vs K7;
  1,000 gated NVE steps on (1,1,1) and (2,2,2) on 'auto' (K2-G, one K7-G
  launch a rebin), the end states bitwise equal, the one-launch form vs
  its plain version and the per-pass form on the C = 40 engine's fields
  at its start and end; 200 on (2,2,2) 'cuda_streaming' (K5s);
  Langevin on (2,2,2); the (1,1,1) run on a one-rank NCCL `DistMesh`;
- the two 1-D slab engines (`distributed/cell_dense_sharded.py` and
  `distributed/domain.py`; plain torch ops but for the slab dense engine's
  sort rebin, one launch of the sort rebin kernel), every slab on this
  card: the slab dense engine on the melt at the grid's config (M = 16,
  C = 40) on (2,1,1) and (4,1,1), its start's PE and virial against the
  dense energy closure, its full-shell forces against K2a's, 1,000 gated
  NVE steps; the atom-table engine on a jittered FCC 14³ (10,976 atoms) on
  (2,1,1) and (3,1,1), its energy and virial against all-pairs, 40 steps
  against the portable all-pairs Verlet, 500 gated NVE steps; then
  tests/test_fidelity.py's 1e-6 drift on the K2a path at 10,976 atoms,
  with float64 energies on the card (measured, not gated);
- parts 1 to 6 of the multi-device dry run (`distributed/dryrun.py`: the
  atom-table slab engine, the slab dense engine, the LJ grid, DSF charges
  and tags, bonded terms with leftover exclusions, the same on the
  kernels) on one NCCL rank, each bitwise equal to the `LocalMesh` run;
- the sort rebin kernel (`phase_sort_rebin`, `csrc/sort_rebin.cu`) at the
  1M melt's config (M = 37, C = 32), drifted across the seam, with and
  without forces: bit for bit the plain sort rebin (`cell_dense._rebin`
  with backend 'torch') in every slot and the flag, its time on both
  clocks beside the plain rebin's and its byte bound;
- the straggler engine on the streaming family at 1M
  (`phase_straggler_1m`: M = 37, C_t = 30, C_w = 36, A = 96, Kn = 16 on
  'cuda_streaming', K5's split entry and the gather pass): K5 vs plain,
  600 gated steps, beside the dense 1M carry on 'auto' (K5) and 'cuda'
  (K2a).

Last, the two TPU probes of tools/ (P1, an fma chain shaped like the force
kernel; P2, the centre-expansion product in two layouts) against their plain
versions, with their times.

Each path is gated: no overflow (capacity, staleness, Kn, A), NVE drift ≤
3e-5 over 1,000 steps (the atom-table slab engine: ≤ 1e-4 over 500; the
water paths: ≤ 1e-4 over 600 steps, 200 at 985,527 atoms; K2c, K5c and K2c-G within 2e-4 of the force scale and 1e-3
in energies and virials of their plain versions) (NVT: the mean T* of the last 500 steps within 2% of
the target; NPT: the box grows by more than 1% and half the pressure gap
closes), launch counts that show every force evaluation, straggler pass,
rebin pass and compaction went through the kernels (counts set to 0 just
before the path and read just after), and bitwise equal reruns (NVT: from
one generator seed; another seed differs).  Every new rollout also runs
once under `torch.cuda.set_sync_debug_mode("error")`: none waits for the
device.
Every phase prints its own line; any failure raises and the exit code is
non-zero.  The last two lines are one JSON object describing the kernels
(times, launches, bounds) and one describing the device.  Without a CUDA
device it exits non-zero and prints no result.  With --save-spill-flag it
also saves the spill state whose next rebin raises the flag at the
suggested capacity (for tests/torch_spill_flag_witness.py).

Bounds: the least time the card could take for a kernel's work, the larger
of its bytes (each input read once, each output written once) at 3.35 TB/s
and its float32 operations at 67 TFLOP/s (H100 SXM data sheet; an FMA
counts as two), with the pairs inside the cutoff counted from this run's
data.  The probe P1 issues no FMA, so each of its operations counts as two.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

import numpy as np
import torch

from emdee_tpu_torch.tools.melt import (
    CUTOFF, DENSITY, DT, FRICTION, KAPPA, N_CELLS_1M, P_NPT, SKIN, SWITCH, T_NVT, TAU_P, TAU_T,
    equilibrate, even_config, melt, spill_config, straggler_config,
)

DRIFT_GATE = 3e-5
T_GATE = 0.02  # NVT: mean T* of the last 500 steps, relative to the target
FORCE_REL_GATE = 5e-4
WIDE_GATE = 1e-4  # straggler forces vs the wide state's, of the force scale
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations of one pair inside the cutoff, each pair once with
# Newton's third law: difference 3, r² 5, 1/r² 1, σ⁶/r⁶ and ε terms 5, switch
# argument 4, two Horner polynomials 20, the force factor 4, force and
# reaction 9.  A min-imaged raw difference adds 4 per component.
OPS_PER_PAIR = 51
OPS_PER_MIN_IMAGED_PAIR = OPS_PER_PAIR + 12
# With per-atom parameters and energies: mixing 3, the switched energy and
# the half-split energy and virial sums 15.
OPS_PER_PAIR_ENERGY = OPS_PER_PAIR + 18
# K2a/K2b and K3's grid side before their redesign (the full-shell kernel,
# one block a cell): their last chip_smoke.py times (PERF.md §6; NVIDIA
# H100 80GB HBM3, 700.00 W), printed on the log lines beside this run's.
K2_BEFORE = {"split_ms": 0.1898, "energy_ms": 0.2266, "n1m_split_ms": 1.4660, "n1m_energy_ms": 1.7765}
K3_BEFORE = {"strag_ms": 0.1875}
# K5 before its redesign (the pencil kernel, one block a (z, y) pencil): its
# chip_smoke.py times, split and with energies (PERF.md §6; NVIDIA H100
# 80GB HBM3, 700.00 W; at 97,556 atoms only the split time was kept).
K5_BEFORE = {"split_ms": 0.2236, "n1m_split_ms": 1.3159, "n1m_energy_ms": 1.7722}
# K2-G (the grid's per-shard LJ pass, uniform parameters) before its
# redesign: a launch's device time in `profile_paths.py`'s profiles of the
# old kernel (PERF.md §5; NVIDIA H100 80GB HBM3, 700.00 W), keyed by (M,
# mesh shape), printed beside this run's times.
K2G_BEFORE = {(17, (1, 1, 1)): 0.1954, (16, (2, 2, 2)): 0.3215, (36, (2, 2, 2)): 3.0568}
# K5s (LJ, uniform parameters, forces) before its redesign (the pencil
# kernel, one block a (z, y) pencil of a shard): its last chip_smoke.py
# times at the 1M melt, a launch pair (PERF.md §6; NVIDIA H100 80GB HBM3,
# 700.00 W), keyed by (M, mesh shape), printed beside this run's times.
K5S_BEFORE = {(37, (1, 1, 1)): 1.3782, (36, (2, 2, 2)): 1.6075}
# F1's capacity: above three centre slots a lane, the streaming family's
# chunked variants; at M = 12 the 97,556-atom melt's estimate passes 13 MB.
C_F1 = 104


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn()` in ms over `reps` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device time of `fn()` in ms over `reps` calls queued behind a
    device-side spin (`torch.cuda._sleep`), so that the host has queued
    every call before the first one starts: for kernels shorter than their
    launch's host cost, which `cuda_ms` would measure instead."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # tens of ms of spinning
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def close(name, got, want, atol, rtol=0.0) -> float:
    """Assert |got − want| ≤ atol + rtol·|want| elementwise; return max |Δ|."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements out of tolerance, max |Δ| {float(diff.max()):.3e}")
    return float(diff.max())


def bound(nbytes: float, ops: float):
    """(bound in ms, what bounds it) for `nbytes` moved and `ops` float32
    operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def grid_pairs(px, py, pz, valid, config) -> int:
    """Unique pairs of grid atoms inside the cutoff: the own cell's upper
    triangle and the 13 half-shell neighbor cells, min-imaged."""
    from emdee_tpu_torch.neighbors.cell_dense import _OFFSETS, _roll_cells

    m, c = config.cells_per_dim, config.capacity
    box = torch.full((), config.box, dtype=torch.float32, device=px.device)
    pos = torch.stack([px, py, pz], dim=-1)

    def count(nbr_pos, nbr_valid, mask):
        d = pos[:, :, None, :] - nbr_pos[:, None, :, :]
        d = d - torch.round(d / box) * box
        ok = valid[:, :, None] & nbr_valid[:, None, :] & ((d * d).sum(-1) < config.cutoff**2) & mask
        return int(ok.sum())

    upper = torch.ones((c, c), dtype=torch.bool, device=px.device).triu(1)
    total = count(pos, valid, upper)
    for o in _OFFSETS:
        total += count(_roll_cells(pos, o, m), _roll_cells(valid, o, m), True)
    return total


def aux_pairs(px, py, pz, valid, ax, ay, az, acell, config):
    """(aux↔grid pairs inside the cutoff, unique aux↔aux pairs inside it,
    distinct grid cells the aux side reads) of a straggler state."""
    from emdee_tpu_torch.neighbors.cell_dense_straggler import _gather_rows, _nbr27_table

    cfg = config.grid
    nc, m = cfg.num_cells, cfg.cells_per_dim
    box = torch.full((), cfg.box, dtype=torch.float32, device=px.device)
    rc2 = cfg.cutoff**2
    mi = lambda d: d - torch.round(d / box) * box  # noqa: E731
    avalid = acell < nc
    idx, mask = _gather_rows(acell, valid, avalid, m)
    shape = mask.shape
    r2 = sum(mi(a[:, None] - p[idx].reshape(shape)) ** 2 for a, p in ((ax, px), (ay, py), (az, pz)))
    ag = int(((mask > 0) & (r2 < rc2)).sum())
    r2 = sum(mi(a[:, None] - a[None, :]) ** 2 for a in (ax, ay, az))
    aa = int((avalid[:, None] & avalid[None, :] & (r2 < rc2)).triu(1).sum())
    cells = int(torch.unique(_nbr27_table(acell, avalid, m, nc)[avalid]).numel())
    return ag, aa, cells


def tensors(state):
    """(name, tensor) for every field of a state, nested states flattened."""
    for name, value in state._asdict().items():
        if value is None:
            continue
        if isinstance(value, tuple):
            yield from ((f"{name}.{k}", t) for k, t in tensors(value))
        else:
            yield name, value


def drifted(state, skin):
    """Move every atom 0.45·skin along its velocity, without wrapping, so a
    real fraction crosses its cell faces and the periodic seam."""
    v = state.velocities
    vmax = float(v.abs().max())
    pos = torch.where(state.valid[..., None], state.positions + (0.45 * skin / vmax) * v, 0.0)
    return state._replace(positions=pos)


def check_cell_forces(st, config, model, label):
    """The per-atom force kernel with energies (K2b) vs its plain version on
    one state: forces within 2e-5 of the force scale, energies and virials,
    exact zeros on empty slots.  Returns (max |dF|, force scale)."""
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces

    fk, ek, wk = cell_forces(st, model, config, compute_energy=True, backend="cuda")
    fp, ep, wp = cell_forces(st, model, config, compute_energy=True, backend="torch")
    torch.cuda.synchronize()
    v = st.valid
    scale = max(float(fp[v].abs().max()), 1.0)
    err = close(f"{label} forces", fk[v], fp[v], atol=2e-5 * scale)
    close(f"{label} energies", ek[v], ep[v], atol=1e-4, rtol=1e-4)
    close(f"{label} virials", wk[v], wp[v], atol=2e-3, rtol=1e-4)
    if err / scale > FORCE_REL_GATE:
        raise AssertionError(f"{label}: force rel diff {err / scale:.3e} > {FORCE_REL_GATE}")
    for name, t in (("forces", fk[~v]), ("energies", ek[~v]), ("virials", wk[~v])):
        if bool((t != 0).any()):
            raise AssertionError(f"{label}: nonzero {name} on empty slots")
    return err, scale


def same_fields(label, a, b):
    """Require two field lists to be bit-identical (floats by their bits)."""
    for i, (x, y) in enumerate(zip(a, b, strict=True)):
        if x is None and y is None:  # a state's static box
            continue
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: field {i} differs")


def phase_forces(device, tag):
    """Force kernel vs plain: 2,048 atoms with per-atom params and energies,
    then the 97,556-atom melt (drifted across the seam) through both entries."""
    from emdee_tpu_torch import (
        LennardJonesModel, cell_dense_init, lennard_jones_atom, suggest_cell_dense_config,
    )
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces, cell_forces_split
    from emdee_tpu_torch.utils.lattice import cubic_lattice, maxwell_boltzmann

    n = 2048
    pos, box = cubic_lattice(n, 0.6, jitter=0.15, seed=11)
    rng = np.random.default_rng(11)
    params = lennard_jones_atom(rng.uniform(0.8, 1.2, n), rng.uniform(0.9, 1.1, n), device=device)
    config = suggest_cell_dense_config(n, box, cutoff=CUTOFF, switch=SWITCH, skin=0.3)
    model = LennardJonesModel.create(CUTOFF, SWITCH, device=device)
    st = cell_dense_init(pos, maxwell_boltzmann(n, 1.0, seed=12), np.ones(n), params, config, device=device)

    err, scale = check_cell_forces(st, config, model, "2048 per-atom")
    log(f"{tag} force kernel vs plain, 2,048 atoms, per-atom params + energies: "
        f"max |dF| {err:.3e} (rel {err / scale:.3e}), empty slots exactly 0")

    st, config, model, _, uni, n = melt(device)
    st = drifted(st, SKIN)
    err_s, scale_s = check_cell_forces(st, config, model, f"{n} per-atom")
    px, py, pz = (st.positions[..., i].contiguous() for i in range(3))
    fk = cell_forces_split(px, py, pz, st.valid, config, uniform_params=uni, backend="cuda")
    fp = cell_forces_split(px, py, pz, st.valid, config, uniform_params=uni, backend="torch")
    torch.cuda.synchronize()
    v = st.valid
    scale = max(max(float(f[v].abs().max()) for f in fp), 1.0)
    err = max(close(f"split f{a}", k[v], p[v], atol=2e-5 * scale) for a, k, p in zip("xyz", fk, fp))
    if err / scale > FORCE_REL_GATE:
        raise AssertionError(f"split: force rel diff {err / scale:.3e} > {FORCE_REL_GATE}")
    log(f"{tag} force kernel vs plain, {n} atoms drifted across the seam: per-atom+energies "
        f"max |dF| {err_s:.3e}; split uniform max |dF| {err:.3e} (rel {err / scale:.3e})")

    ms = cuda_ms(lambda: cell_forces_split(px, py, pz, v, config, uniform_params=uni, backend="cuda"), 50)
    plain_ms = cuda_ms(lambda: cell_forces_split(px, py, pz, v, config, uniform_params=uni, backend="torch"), 5)
    ms_e = cuda_ms(lambda: cell_forces(st, model, config, compute_energy=True, backend="cuda"), 20)
    plain_ms_e = cuda_ms(lambda: cell_forces(st, model, config, compute_energy=True, backend="torch"), 3)
    pairs = grid_pairs(px, py, pz, v, config)
    bound_ms, bound_by = bound(25 * config.num_slots, OPS_PER_PAIR * pairs)
    # in: positions 12 B, σ/2 and 2√ε 8 B, valid 1 B; out: forces, energy, virial 20 B
    bound_e = bound(41 * config.num_slots, OPS_PER_PAIR_ENERGY * pairs)
    log(f"{tag} force kernel time at {n} atoms: split (K2a) {ms:.4f} ms/launch (before the redesign "
        f"{K2_BEFORE['split_ms']}), plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}); per-atom+energies "
        f"(K2b) {ms_e:.4f} ms/launch (before {K2_BEFORE['energy_ms']}), plain {plain_ms_e:.3f} ms, bound "
        f"{bound_e[0]:.5f} ms ({bound_e[1]}); {pairs:,} pairs inside the cutoff")
    res = lj_resources_all()
    log(f"{tag} LJ pass (cell_lj_kernel) resources: {resources_line(res)}")
    return {"max_abs_err": max(err, err_s), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "energy_ms": ms_e,
            "energy_plain_ms": plain_ms_e, "energy_bound_ms": bound_e[0], "resources": res}


def lj_resources_all():
    """The LJ pass's variants (K2a, K2b with and without energies, K3's
    grid side) as the card reports them (`cell_kernel.lj_resources`)."""
    from emdee_tpu_torch.neighbors.cell_kernel import lj_resources

    return {name: lj_resources(*flags) for name, flags in (
        ("K2a", (True, False, False)), ("K2b energies", (False, True, False)), ("K2b forces", (False, False, False)),
        ("K3 grid side", (True, False, True)))}


def phase_rebin(device, tag, cells=None):
    """K4 on the melt of `cells`³ FCC cells (default the 97,556-atom one),
    drifted across the seam: at 97,556 atoms `_rebin_shift` (per-atom
    fields, strided views) kernel vs plain, bit-exact in every field; then
    the rebin as the component carry calls it (raw positions and velocities
    as strided views, atom id, the valid mask, the wrap) — at 97,556 atoms
    also with one atom moved two cells and with the cells at y = 0 moved one
    cell up, so that the y pass overflows between the other two — vs the
    plain version and vs the former three launches (`emdee_rebin_pass`,
    kept in the source as the witness) on the parked fields: bit for bit in
    every field and the flag.  Times on both clocks (CUDA events around
    back-to-back calls, and behind a device spin), the three launches'
    beside them (`before_*`, without and with the torch ops that parked the
    fields for them), and the cooperative grid."""
    import ctypes

    from emdee_tpu_torch.csrc import build
    from emdee_tpu_torch.neighbors.cell_dense import _box, _rebin_shift
    from emdee_tpu_torch.neighbors.rebin_kernel import _parked, rebin_routing
    from emdee_tpu_torch.tools.ab_rebin import three_pass

    st, config, _, _, _, n = melt(device) if cells is None else melt(device, cells)
    st = drifted(st, SKIN)
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    if cells is None:
        a = _rebin_shift(st, config, backend="cuda")
        b = _rebin_shift(st, config, backend="torch")
        torch.cuda.synchronize()
        same_fields("rebin kernel vs plain", a, b)
        moved = int(((a.atom_id != st.atom_id) & a.valid).sum())
        if bool(a.overflow) or moved < 1000:
            raise AssertionError(f"rebin fixture: overflow {bool(a.overflow)}, {moved} slots moved")

    lib = build.load()
    box = _box(config.box, st.positions)
    valid = st.valid

    def fields_of(pos):
        return [pos[..., i] for i in range(3)] + [st.velocities[..., i] for i in range(3)] + [st.atom_id]

    def held(label, fields, flag):
        """The kernel vs plain and vs the three launches, bit for bit."""
        got = rebin_routing(fields, box, m, c, ns, backend="cuda", valid=valid, wrap=True)
        plain = rebin_routing(fields, box, m, c, ns, backend="torch", valid=valid, wrap=True)
        before = three_pass(lib, _parked(fields, valid, box, True), box, m, c, ns)
        torch.cuda.synchronize()
        same_fields(f"K4 {label} vs plain", list(got[0]) + [got[1]], list(plain[0]) + [plain[1]])
        same_fields(f"K4 {label} vs the three launches", list(got[0]) + [got[1]], list(before[0]) + [before[1]])
        if bool(got[1]) != flag:
            raise AssertionError(f"K4 {label}: flag {bool(got[1])}, expected {flag}")
        return int(((got[0][-1] != st.atom_id) & (got[0][-1] < ns)).sum())

    fields = fields_of(st.positions)
    moved = held("drifted", fields, False)
    if moved < 1000:
        raise AssertionError(f"K4 fixture: {moved} slots moved")
    cases = "drifted"
    if cells is None:
        h = float(config.cell_side)
        crowd = ((torch.arange(m**3, device=device) // m) % m == 0)[:, None] & valid
        crowded = st.positions.clone()
        crowded[..., 1] += torch.where(crowd, h, 0.0)
        held("y pass overflowing", fields_of(crowded), True)
        jump = st.positions.clone()
        first = int(torch.nonzero(valid.reshape(-1))[0])
        jump[first // c, first % c, 0] += 2.0 * h
        held("two-cell jump", fields_of(jump), True)
        cases = "drifted, a y pass overflowing between the other two, a two-cell jump"

    # Few enough calls that the host queues them all within device_ms's spin:
    # the torch ops that parked the fields cost the host ~0.3 ms a call.
    reps = 20 if cells else 50
    call = lambda: rebin_routing(fields, box, m, c, ns, backend="cuda", valid=valid, wrap=True)  # noqa: E731
    parked = _parked(fields, valid, box, True)
    three = lambda: three_pass(lib, parked, box, m, c, ns)  # noqa: E731
    park_three = lambda: three_pass(lib, _parked(fields, valid, box, True), box, m, c, ns)  # noqa: E731
    t = dict(before_device_ms=device_ms(three, reps), device_ms=device_ms(call, reps),
             before_ms=cuda_ms(three, reps), ms=cuda_ms(call, reps),
             before_park_device_ms=device_ms(park_three, reps), before_park_ms=cuda_ms(park_three, reps))
    plain_ms = cuda_ms(lambda: rebin_routing(fields, box, m, c, ns, backend="torch", valid=valid, wrap=True),
                       3 if cells else 10)
    grid = (ctypes.c_int * 4)()
    build.check(lib.emdee_rebin_routing_attrs(grid), "rebin_routing attrs")
    resident = grid[0] * grid[1] * grid[3]
    # The seven fields read and written once each, and the valid mask.
    bound_ms, bound_by = bound(2 * 4 * len(fields) * ns + ns, 0)
    log(f"{tag} K4 at {n} atoms, M={m} C={c}, nf={len(fields)} (strided positions and velocities, the valid "
        f"mask, the wrap): bit for bit the plain version and the former three launches in every field and the "
        f"flag ({cases}; {moved} slots moved); one cooperative launch, {grid[0]} blocks an SM on {grid[1]} SMs, "
        f"{grid[2]} threads a block, a warp a row: {resident} rows at a time of {m**3}; "
        f"{t['device_ms']:.5f} ms a rebin "
        f"on the device ({t['ms']:.5f} with the host's launch cost); the three launches {t['before_device_ms']:.5f} "
        f"({t['before_ms']:.5f}), with the torch ops that parked for them {t['before_park_device_ms']:.5f} "
        f"({t['before_park_ms']:.5f}); plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return {"max_abs_err": 0.0, **t, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "grid": {"blocks_per_sm": grid[0], "sms": grid[1], "threads": grid[2],
                                         "rows_a_block": grid[3], "rows": m**3}}


def phase_streaming(device, tag, cells=None):
    """The streaming kernel (K5) on the melt of `cells`³ FCC cells, drifted
    across the seam: both entries vs the plain version (forces within 2e-5
    of the force scale, energies and virials, exact zeros on empty slots),
    vs the resident kernel (K2) on the same state, and the times of K5, K2
    and the plain version, each entry, beside K5's before its redesign and
    its scratch traffic; K5's variants' resources as the card reports them.
    Returns (K5 row, K2 times)."""
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces, cell_forces_split
    from emdee_tpu_torch.neighbors.streaming_kernel import (
        cell_forces_streaming, cell_forces_streaming_split, k5_resources, scratch_bytes,
    )

    st, config, model, _, uni, n = melt(device) if cells is None else melt(device, cells)
    st = drifted(st, SKIN)
    v = st.valid
    fk, ek, wk = cell_forces_streaming(st, model, config, compute_energy=True, backend="cuda")
    fp, ep, wp = cell_forces_streaming(st, model, config, compute_energy=True, backend="torch")
    fr, er, wr = cell_forces(st, model, config, compute_energy=True, backend="cuda")
    torch.cuda.synchronize()
    scale = max(float(fp[v].abs().max()), 1.0)
    err_e = close(f"K5 {n} per-atom forces", fk[v], fp[v], atol=2e-5 * scale)
    close(f"K5 {n} energies", ek[v], ep[v], atol=1e-4, rtol=1e-4)
    close(f"K5 {n} virials", wk[v], wp[v], atol=2e-3, rtol=1e-4)
    for name, t in (("forces", fk[~v]), ("energies", ek[~v]), ("virials", wk[~v])):
        if bool((t != 0).any()):
            raise AssertionError(f"K5 {n}: nonzero {name} on empty slots")
    vs_k2 = close(f"K5 vs K2 {n} forces", fk[v], fr[v], atol=2e-5 * scale)
    close(f"K5 vs K2 {n} energies", ek[v], er[v], atol=1e-4, rtol=1e-4)
    close(f"K5 vs K2 {n} virials", wk[v], wr[v], atol=2e-3, rtol=1e-4)

    px, py, pz = (st.positions[..., i].contiguous() for i in range(3))
    args = (px, py, pz, v, config)
    sk = cell_forces_streaming_split(*args, uniform_params=uni, backend="cuda")
    sp = cell_forces_streaming_split(*args, uniform_params=uni, backend="torch")
    sr = cell_forces_split(*args, uniform_params=uni, backend="cuda")
    torch.cuda.synchronize()
    err_s = max(close(f"K5 split {n} f{a}", k[v], p[v], atol=2e-5 * scale) for a, k, p in zip("xyz", sk, sp))
    vs_k2 = max(vs_k2, *(close(f"K5 vs K2 split {n} f{a}", k[v], r[v], atol=2e-5 * scale)
                         for a, k, r in zip("xyz", sk, sr)))
    if bool(any((k[~v] != 0).any() for k in sk)):
        raise AssertionError(f"K5 split {n}: nonzero forces on empty slots")
    err = max(err_e, err_s)
    if err / scale > FORCE_REL_GATE:
        raise AssertionError(f"K5 {n}: force rel diff {err / scale:.3e} > {FORCE_REL_GATE}")

    big = n > 500_000
    ms = cuda_ms(lambda: cell_forces_streaming_split(*args, uniform_params=uni, backend="cuda"), 20 if big else 50)
    k2_ms = cuda_ms(lambda: cell_forces_split(*args, uniform_params=uni, backend="cuda"), 20 if big else 50)
    ms_e = cuda_ms(lambda: cell_forces_streaming(st, model, config, compute_energy=True, backend="cuda"), 10 if big else 20)
    k2_ms_e = cuda_ms(lambda: cell_forces(st, model, config, compute_energy=True, backend="cuda"), 10 if big else 20)
    plain_ms = cuda_ms(lambda: cell_forces_streaming_split(*args, uniform_params=uni, backend="torch"), 2 if big else 5)
    plain_ms_e = cuda_ms(lambda: cell_forces_streaming(st, model, config, compute_energy=True, backend="torch"), 2 if big else 3)
    pairs = grid_pairs(px, py, pz, v, config)
    ns = config.num_slots
    bound_ms, bound_by = bound(25 * ns, OPS_PER_PAIR * pairs)
    bound_e = bound(41 * ns, OPS_PER_PAIR_ENERGY * pairs)
    # The design's own traffic: the scratch slices, written once and read back by the fold.
    scratch_ms = [1e3 * 2 * scratch_bytes(config, e) / HBM_BYTES_PER_S for e in (False, True)]
    log(f"{tag} K5 at {n} atoms (M={config.cells_per_dim} C={config.capacity}), drifted across the seam: "
        f"vs plain max |dF| per-atom+energies {err_e:.3e}, split {err_s:.3e} (rel {err / scale:.3e}); "
        f"vs K2 max |dF| {vs_k2:.3e} (rel {vs_k2 / scale:.3e}); energies, virials in tolerance, "
        "empty slots exactly 0")
    before = (K2_BEFORE["n1m_split_ms"], K2_BEFORE["n1m_energy_ms"]) if big else (
        K2_BEFORE["split_ms"], K2_BEFORE["energy_ms"])
    k5_before = (K5_BEFORE["n1m_split_ms"], K5_BEFORE["n1m_energy_ms"]) if big else (
        K5_BEFORE["split_ms"], "not kept")
    log(f"{tag} K5 vs K2 times at {n} atoms: split K5 {ms:.4f} ms (2 launches; K5 before its redesign "
        f"{k5_before[0]}) vs K2 {k2_ms:.4f} ms (K2 before its redesign {before[0]}), plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by}; K5's scratch, {scratch_bytes(config, False):,} B written and read "
        f"back, alone {scratch_ms[0]:.5f} ms); per-atom+energies K5 {ms_e:.4f} ms (before {k5_before[1]}) vs K2 "
        f"{k2_ms_e:.4f} ms (before {before[1]}), plain {plain_ms_e:.3f} ms, bound {bound_e[0]:.5f} ms "
        f"({bound_e[1]}; scratch {scratch_bytes(config, True):,} B, {scratch_ms[1]:.5f} ms); {pairs:,} pairs "
        "inside the cutoff")
    res = {name: k5_resources(config, *flags) for name, flags in (
        ("uniform", (True, False)), ("per-atom", (False, False)), ("per-atom energies", (False, True)))}
    log(f"{tag} K5 (streaming_lj_kernel) resources at C={config.capacity}: {resources_line(res)}")
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None, "energy_ms": ms_e, "energy_plain_ms": plain_ms_e,
           "energy_bound_ms": bound_e[0], "vs_k2_max_abs_err": vs_k2, "resources": res}
    return row, {"k2_split_ms": k2_ms, "k2_energy_ms": k2_ms_e}


def phase_streaming_c104(device, tag, config, model, params, uni, pos_eq, vel_eq, k):
    """F1 on the equilibrated 97,556-atom melt at M = 12, C = 104, a config
    the reference's streaming kernel takes: the TPU engine's VMEM estimate
    (13,310,336 B) passes 13 MB, so 'auto' must resolve to the streaming
    family, whose chunked variants run above 96.  K5 on the state drifted
    0.45·skin, both entries, vs the plain version (forces within 2e-5 of the
    force scale, energies and virials, empty slots exactly 0) and their
    times; then 200 NVE steps on 'auto' (no flag, drift ≤ 3e-5, exact
    launches: two K5 a force evaluation, three K4 a rebin), bitwise reruns,
    no host waits.  Returns (K5 row fields, {path: counts}, ms/step)."""
    from emdee_tpu_torch import cell_dense_init, estimate_kernel_vmem_bytes, make_cell_dense_sim, resolve_dense_backend
    from emdee_tpu_torch.neighbors.streaming_kernel import (
        cell_forces_streaming, cell_forces_streaming_split, k5_resources,
    )

    cfg = config._replace(cells_per_dim=12, capacity=C_F1)
    n = cfg.num_atoms
    est = estimate_kernel_vmem_bytes(cfg)
    family = resolve_dense_backend(cfg, "auto", device=device)
    if family != "cuda_streaming":
        raise AssertionError(f"melt M=12 C={C_F1}: 'auto' resolves to {family!r} (estimate {est:,} B)")
    st0 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, cfg, device=device)
    if bool(st0.overflow):
        raise AssertionError(f"melt M=12 C={C_F1}: init overflow")
    st = drifted(st0, SKIN)
    v = st.valid
    fk, ek, wk = cell_forces_streaming(st, model, cfg, compute_energy=True, backend="cuda")
    fp, ep, wp = cell_forces_streaming(st, model, cfg, compute_energy=True, backend="torch")
    px, py, pz = (st.positions[..., i].contiguous() for i in range(3))
    sk = cell_forces_streaming_split(px, py, pz, v, cfg, uniform_params=uni, backend="cuda")
    sp = cell_forces_streaming_split(px, py, pz, v, cfg, uniform_params=uni, backend="torch")
    torch.cuda.synchronize()
    scale = max(float(fp[v].abs().max()), 1.0)
    err = max(close(f"K5 M=12 C={C_F1} per-atom forces", fk[v], fp[v], atol=2e-5 * scale),
              *(close(f"K5 M=12 C={C_F1} split f{a}", a_k[v], a_p[v], atol=2e-5 * scale)
                for a, a_k, a_p in zip("xyz", sk, sp)))
    close(f"K5 M=12 C={C_F1} energies", ek[v], ep[v], atol=1e-4, rtol=1e-4)
    close(f"K5 M=12 C={C_F1} virials", wk[v], wp[v], atol=2e-3, rtol=1e-4)
    if bool((fk[~v] != 0).any()) or bool((ek[~v] != 0).any()) or any(bool((a[~v] != 0).any()) for a in sk):
        raise AssertionError(f"K5 M=12 C={C_F1}: nonzero values on empty slots")
    ms_k = cuda_ms(lambda: cell_forces_streaming_split(px, py, pz, v, cfg, uniform_params=uni, backend="cuda"), 50)
    ms_e = cuda_ms(lambda: cell_forces_streaming(st, model, cfg, compute_energy=True, backend="cuda"), 20)
    plain = cuda_ms(lambda: cell_forces_streaming_split(px, py, pz, v, cfg, uniform_params=uni, backend="torch"), 3)
    pairs = grid_pairs(px, py, pz, v, cfg)
    b_ms, b_by = bound(25 * cfg.num_slots, OPS_PER_PAIR * pairs)
    res = {name: k5_resources(cfg, *flags) for name, flags in (
        ("uniform", (True, False)), ("per-atom", (False, False)), ("per-atom energies", (False, True)))}
    log(f"{tag} F1: melt M=12 C={C_F1} (estimate {est:,} B) 'auto' -> {family!r}; K5 (chunked variant) vs plain max "
        f"|dF| {err:.3e} (scale {scale:.2f}), energies, virials in tolerance, empty slots 0; split {ms_k:.4f} ms a "
        f"launch pair, per-atom + energies {ms_e:.4f}, plain {plain:.3f}, bound {b_ms:.5f} ms ({b_by}; {pairs:,} "
        f"pairs); resources {resources_line(res)}")

    roll, energy = make_cell_dense_sim(cfg, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    roll(st0, num_steps=2 * k, rebin_every=k)  # warm-up
    steps = 200
    label = f"melt M=12 C={C_F1} ('auto', K5)"
    _, sec, drift, counts = gate_rollout(label, roll, energy, st0, steps, k,
                                         launches(cell_forces_streaming=2 * (steps + 2 + 2),
                                                  rebin_routing=-(-steps // k)))
    bitwise_rerun(label, roll, st0, 50, k)
    no_host_waits(label, lambda: roll(st0, num_steps=2 * k, rebin_every=k))
    ms = 1e3 * sec / steps
    log(f"{tag} {label}: {steps} NVE steps in {sec:.3f} s = {ms:.4f} ms/step, drift {drift:.3e}; launches {counts}; "
        "reruns bitwise; no host waits")
    row = {"c104_max_abs_err": err, "c104_ms": ms_k, "c104_energy_ms": ms_e, "c104_plain_ms": plain,
           "c104_bound_ms": b_ms, "c104_bound_by": b_by, "c104_pairs": pairs, "c104_resources": res,
           "c104_ms_per_step": ms, "c104_drift": drift}
    return row, {"melt_m12_c104": counts}, ms


def phase_1m(device, tag):
    """bench_all.py's 1M melt on the dense engine through `backend="auto"`,
    which must resolve to the streaming family: equilibrate, then the gated
    1,000-step component-carry rollout (overflow, drift, K5 and K4 launch
    counts), bitwise reruns, and a short stacked per-atom rollout.  Returns
    {path: launch counts}, the rollout's ms/step and the equilibrated melt
    (positions, velocities, rebin interval, config, model, params, uniform
    params) for the grid's 1M phase."""
    from emdee_tpu_torch import cell_dense_init, make_cell_dense_sim, resolve_dense_backend

    state, config, model, params, uni, n = melt(device, N_CELLS_1M)
    family = resolve_dense_backend(config, "auto", device=device)
    if family != "cuda_streaming" or (config.cells_per_dim, config.capacity) != (37, 32):
        raise AssertionError(f"1M melt: M={config.cells_per_dim} C={config.capacity} resolves to {family!r}")
    rollout, energy = make_cell_dense_sim(config, model, dt=DT, backend="auto", uniform_params=uni, uniform_mass=1.0)
    t0 = time.perf_counter()
    pos_eq, vel_eq, t_eq, k = equilibrate(rollout, state, config, n)
    st0 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, config, device=device)
    if bool(st0.overflow):
        raise AssertionError("1M re-init overflow")
    log(f"1M melt: {n} atoms, M={config.cells_per_dim} C={config.capacity}, backend 'auto' -> {family!r}; "
        f"equilibrated 200 steps (rebin every 2) in {time.perf_counter() - t0:.2f} s: T* = {t_eq:.4f}, "
        f"rebin every {k} steps")

    steps = 1000
    _, sec, drift, counts = gate_rollout(
        "1M path", rollout, energy, st0, steps, k,
        launches(cell_forces_streaming=2 * (steps + 2 + 2), rebin_routing=-(-steps // k)),
    )
    bitwise_rerun("1M path", rollout, st0, 100, k)
    ms = 1e3 * sec / steps
    log(f"{tag} 1M path (component carry, uniform params, K5): {steps} steps in {sec:.3f} s = {ms:.4f} ms/step, "
        f"{n * steps / sec:,.0f} atom-steps/s; NVE drift {drift:.3e}; launches {counts}; "
        "two 100-step rollouts bitwise equal")

    roll_s, energy_s = make_cell_dense_sim(config, model, dt=DT)
    steps_s = 100
    _, sec_s, drift_s, counts_s = gate_rollout(
        "1M stacked path", roll_s, energy_s, st0, steps_s, k,
        launches(cell_forces_streaming=2 * (steps_s + 2 + 2), rebin_routing=-(-steps_s // k)),
    )
    bitwise_rerun("1M stacked path", roll_s, st0, 50, k)
    log(f"{tag} 1M stacked path (per-atom params, K5): {steps_s} steps, {1e3 * sec_s / steps_s:.4f} ms/step; "
        f"NVE drift {drift_s:.3e}; launches {counts_s}; two 50-step rollouts bitwise equal")
    eq = dict(pos=pos_eq, vel=vel_eq, k=k, config=config, model=model, params=params, uni=uni)
    return {"dense_1m": counts, "stacked_1m": counts_s}, ms, eq


def phase_straggler_1m(device, tag, eq):
    """The straggler engine on the streaming family at 1M: the equilibrated
    1M melt of `phase_1m` at the reference's 1M straggler config
    (tools/perf_strag_1m.py: M = 37, C_t = 30, C_w = 36, A = 96, Kn = 16,
    rebin every 6) on 'cuda_streaming' (K5's split entry for the grid, the
    gather pass with the fixed-order fold for the tail, K4 for the wide
    rebin, K2b for the energies): K5 split vs its plain version on the
    straggler grid within 2e-5 of the force scale; 600 gated steps (no
    overflow and no Kn flag, drift, launches), a parked tail at the end,
    bitwise reruns, no host waits; its ms/step and device kernels a step
    beside the dense 1M carry's on 'auto' (K5) and 'cuda' (K2a) at the
    same rebin interval.  Returns ({path: counts}, ms/step, K5's max |dF|
    vs plain)."""
    from emdee_tpu_torch import cell_dense_init, make_cell_dense_sim, make_straggler_sim, straggler_init
    from emdee_tpu_torch.neighbors.streaming_kernel import cell_forces_streaming_split

    config, model, params, uni = eq["config"], eq["model"], eq["params"], eq["uni"]
    n = config.num_atoms
    sconfig = straggler_config(config, 2, 96, 16)
    if (sconfig.grid.cells_per_dim, sconfig.grid.capacity, sconfig.wide_capacity) != (37, 30, 36):
        raise AssertionError(f"1M straggler config: {sconfig}")
    k = 6
    s0 = straggler_init(eq["pos"], eq["vel"], np.ones(n), params, sconfig, device=device)
    nc = sconfig.grid.num_cells
    parked0 = int((s0.aux_cell < nc).sum())
    if bool(s0.grid.overflow) or parked0 < 1:
        raise AssertionError(f"1M straggler init: overflow {bool(s0.grid.overflow)}, {parked0} parked")
    p3 = s0.grid.positions.permute(2, 0, 1).contiguous()
    args = (p3[0], p3[1], p3[2], s0.grid.valid, sconfig.grid)
    got = torch.stack(cell_forces_streaming_split(*args, uniform_params=uni, backend="cuda"))
    want = torch.stack(cell_forces_streaming_split(*args, uniform_params=uni, backend="torch"))
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = close("1M straggler grid: K5 split vs plain", got, want, atol=2e-5 * scale)
    del got, want, p3

    roll, energy = make_straggler_sim(sconfig, model, dt=DT, uniform_params=uni, uniform_mass=1.0,
                                      backend="cuda_streaming")
    roll(s0, num_steps=2 * k, rebin_every=k)  # warm-up
    steps = 600
    out, sec, drift, counts = gate_rollout(
        "1M straggler path", roll, energy, s0, steps, k,
        launches(cell_forces_streaming=2 * (steps + 2), cell_forces=2, rebin_routing=-(-steps // k)),
    )
    parked1 = int((out.aux_cell < nc).sum())
    if parked1 < 1:
        raise AssertionError("1M straggler path: no parked aux atom at the end")
    bitwise_rerun("1M straggler path", roll, s0, 60, k)
    no_host_waits("1M straggler path", lambda: roll(s0, num_steps=2 * k, rebin_every=k))
    ms = 1e3 * sec / steps
    kps = kernels_per_step(lambda: roll(s0, num_steps=30, rebin_every=k), 30)
    del out
    st0 = cell_dense_init(eq["pos"], eq["vel"], np.ones(n), params, config, device=device)
    dense = {}
    for backend in ("auto", "cuda"):
        d_roll, _ = make_cell_dense_sim(config, model, dt=DT, backend=backend, uniform_params=uni, uniform_mass=1.0)
        d_roll(st0, num_steps=2 * k, rebin_every=k)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if bool(d_roll(st0, num_steps=300, rebin_every=k).overflow):
            raise AssertionError(f"1M dense carry on {backend!r}: overflow")
        dense[backend] = (1e3 * (time.perf_counter() - t0) / 300,
                          kernels_per_step(lambda: d_roll(st0, num_steps=30, rebin_every=k), 30))
    fmt = lambda v: "not measured" if v is None else f"{v:.1f}"  # noqa: E731
    log(f"{tag} 1M straggler path ('cuda_streaming': K5 split + the gather pass; C_t={sconfig.grid.capacity} "
        f"C_w={sconfig.wide_capacity} A={sconfig.aux_capacity} Kn={sconfig.kn}, rebin every {k}): K5 split vs plain "
        f"max |dF| {err:.3e} (scale {scale:.3f}); {steps} steps in {sec:.3f} s = {ms:.4f} ms/step, "
        f"{n * steps / sec:,.0f} atom-steps/s, {fmt(kps)} device kernels a step; NVE drift {drift:.3e}; parked "
        f"{parked0} -> {parked1}; launches {counts}; reruns bitwise equal; no host waits.  The dense 1M carry at "
        f"the same rebin interval: 'auto' (K5) {dense['auto'][0]:.4f} ms/step, {fmt(dense['auto'][1])} kernels a "
        f"step; 'cuda' (K2a) {dense['cuda'][0]:.4f} ms/step, {fmt(dense['cuda'][1])} kernels a step")
    return {"straggler_1m": counts}, ms, err


def counters():
    """{kernel: (its wrapper's module, the module's launch counter)}."""
    from emdee_tpu_torch.neighbors import (
        cell_kernel, compact_kernel, rebin_kernel, rebin_window_kernel, sort_rebin_kernel, straggler_kernel,
        streaming_kernel,
    )
    from emdee_tpu_torch.tools import probes

    return {"cell_forces": (cell_kernel, "LAUNCHES"), "cell_forces_streaming": (streaming_kernel, "LAUNCHES"),
            "rebin_routing": (rebin_kernel, "LAUNCHES"), "straggler_aux": (straggler_kernel, "LAUNCHES"),
            "compact_window": (compact_kernel, "LAUNCHES"), "rebin_window": (rebin_window_kernel, "LAUNCHES"),
            "spill_window": (rebin_window_kernel, "SPILL_LAUNCHES"),
            "spill_grid": (rebin_window_kernel, "GRID_SPILL_LAUNCHES"), "probes": (probes, "LAUNCHES"),
            "sort_rebin": (sort_rebin_kernel, "LAUNCHES")}


def zero_counts() -> None:
    """Every kernel's launch count set to 0."""
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    """{kernel: launches since `zero_counts`}."""
    return {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}


def launches(**nonzero):
    """The expected launch counts of a path: every kernel 0 but those named."""
    return {**{name: 0 for name in counters()}, **nonzero}


def no_host_waits(label, fn) -> None:
    """Run `fn` under `torch.cuda.set_sync_debug_mode("error")`: any call
    that waits for the device raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        raise AssertionError(f"{label}: waits for the device: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def kernels_per_step(run, steps: int):
    """Device kernels a step of `run()`, a call that runs `steps` steps, from
    one `torch.profiler` window after a warm-up call; None (not measured)
    where the profiler records no device activity."""
    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return n / steps if n else None


def gate_rollout(label, rollout, energy, st0, steps, rebin_every, expected, drift_gate=DRIFT_GATE):
    """Run one measured rollout with every launch counter set to 0 just
    before it; gate overflow, NVE drift (≤ `drift_gate`) and the launch
    counts (`expected`, by kernel, the two energy calls included).  Returns
    (final state, seconds, drift, counts)."""
    zero_counts()
    pe0, _, ke0 = energy(st0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = rollout(st0, num_steps=steps, rebin_every=rebin_every)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    pe1, _, ke1 = energy(out)
    counts = read_counts()
    e0, e1 = float(pe0 + ke0), float(pe1 + ke1)
    drift = abs(e1 - e0) / max(abs(e0), 1.0)
    if bool(getattr(out, "grid", out).overflow):
        raise AssertionError(f"{label}: overflow")
    if not drift <= drift_gate:
        raise AssertionError(f"{label}: NVE drift {drift:.3e} > {drift_gate}")
    if counts != expected:
        raise AssertionError(f"{label}: kernel launches {counts}, expected {expected}")
    return out, seconds, drift, counts


def bitwise_rerun(label, rollout, st0, steps, rebin_every, seed=None):
    """Two rollouts from st0 are bitwise equal; with `seed`, both draw from
    a generator seeded with it, and a third from seed + 1 differs."""
    def run(s):
        kw = {} if s is None else {"rng": torch.Generator(device=st0.positions.device).manual_seed(s)}
        return rollout(st0, num_steps=steps, rebin_every=rebin_every, **kw)

    a, b = run(seed), run(seed)
    for (name, x), (_, y) in zip(tensors(a), tensors(b)):
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: reruns differ in {name}")
    if seed is not None and torch.equal(run(seed + 1).velocities, a.velocities):
        raise AssertionError(f"{label}: another seed gave the same trajectory")


def phase_straggler_kernel(device, tag, label, sconfig, pos_eq, vel_eq, params, model, uni, n):
    """K3 on the equilibrated melt, its atoms then drifted 0.45·skin along
    their velocities: both CUDA sides vs the plain version, exact zeros on
    empty slots and lanes, the forces vs the wide state's, the gather pass
    vs the kernel pass, and the times of each launch and plain side.  Also
    K2b and K4 vs their plain versions at the wide capacity C_w, on the
    wide state and the widened fields that the path's energy closure and
    rebin hand them."""
    from emdee_tpu_torch import make_straggler_sim, straggler_init
    from emdee_tpu_torch.csrc import build
    from emdee_tpu_torch.neighbors import cell_kernel
    from emdee_tpu_torch.neighbors import straggler_kernel as sk
    from emdee_tpu_torch.tools.ab_rebin import aux_call
    from emdee_tpu_torch.neighbors.cell_dense import _rebin_shift_core, cell_dense_forces
    from emdee_tpu_torch.neighbors.cell_dense_straggler import _bindings, _hood_matrix

    cfg = sconfig.grid
    nc, m, a_cap = cfg.num_cells, cfg.cells_per_dim, sconfig.aux_capacity
    st = straggler_init(pos_eq, vel_eq, np.ones(n), params, sconfig, device=device)
    parked = int((st.aux_cell < nc).sum())
    if bool(st.grid.overflow) or parked < 1:
        raise AssertionError(f"K3 {label}: init overflow {bool(st.grid.overflow)}, {parked} parked")
    av = st.aux_cell < nc
    vmax = max(float(st.grid.velocities.abs().max()), float(st.aux_velocities.abs().max()))
    step = 0.45 * SKIN / vmax
    grid = st.grid._replace(positions=torch.where(
        st.grid.valid[..., None], st.grid.positions + step * st.grid.velocities, 0.0))
    st = st._replace(grid=grid, aux_positions=torch.where(
        av[:, None], st.aux_positions + step * st.aux_velocities, 0.0))

    v = st.grid.valid
    p = st.grid.positions.permute(2, 0, 1).contiguous()
    a = st.aux_positions.t().contiguous()
    table, knovf = _bindings(st.aux_cell, av, sconfig, _hood_matrix(m, device))
    if bool(knovf):
        raise AssertionError(f"K3 {label}: Kn overflow")
    args = (p[0], p[1], p[2], v, a[0], a[1], a[2], st.aux_cell, table, sconfig, uni)
    fg, fa = sk.straggler_forces(*args, backend="cuda")
    pg, pa = sk.straggler_forces(*args, backend="torch")
    torch.cuda.synchronize()
    scale = max(float(pg[:, v].abs().max()), float(pa[:, av].abs().max()), 1.0)
    err_g = close(f"K3 {label} grid forces", fg[:, v], pg[:, v], atol=2e-5 * scale)
    err_a = close(f"K3 {label} aux forces", fa[:, av], pa[:, av], atol=2e-5 * scale)
    if bool((fg[:, ~v] != 0).any()) or bool((fa[:, ~av] != 0).any()):
        raise AssertionError(f"K3 {label}: nonzero forces on empty slots or aux lanes")

    # Elementwise against the wide state's forces at C_w, in atom order.
    roll_k, _ = make_straggler_sim(sconfig, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    wide = roll_k.wide_state(st)
    fw = cell_dense_forces(wide, model, sconfig.wide)[0]
    ref = torch.zeros((n, 3), dtype=torch.float32, device=device)
    ref[wide.atom_id[wide.valid].long()] = fw[wide.valid]
    got = torch.zeros_like(ref)
    got[st.grid.atom_id[v].long()] = fg.permute(1, 2, 0)[v]
    got[st.aux_atom_id[av].long()] = fa.t()[av]
    wscale = float(ref.abs().max())
    err_w = close(f"K3 {label} vs wide state", got, ref, atol=WIDE_GATE * wscale)

    # K2b at C_w on the wide state, as the energy closure calls it.
    cfg_w = sconfig.wide
    err_e, _ = check_cell_forces(wide, cfg_w, model, f"K2b {label} C_w={cfg_w.capacity}")
    # K4 at C_w on the widened fields (positions, velocities, atom id), as
    # the rollout's rebin calls it: bit-exact in every field and the flag.
    fields = [wide.positions[..., i] for i in range(3)]
    fields += [wide.velocities[..., i] for i in range(3)] + [wide.atom_id]
    ovf0 = torch.zeros((), dtype=torch.bool, device=device)
    rk, vk, ok_ = _rebin_shift_core(list(fields), wide.valid, ovf0, cfg_w, "cuda")
    rp, vp, op_ = _rebin_shift_core(list(fields), wide.valid, ovf0, cfg_w, "torch")
    torch.cuda.synchronize()
    same_fields(f"K4 {label} C_w={cfg_w.capacity} kernel vs plain", rk + [vk, ok_], rp + [vp, op_])
    moved_w = int(((rk[6] != wide.atom_id) & vk).sum())
    tail_w = int(vk[:, cfg.capacity:].sum())
    if bool(ok_) or moved_w < 1000:
        raise AssertionError(f"K4 {label} C_w fixture: overflow {bool(ok_)}, {moved_w} slots moved")

    # The gather pass (torch ops around the split kernel) against the kernel pass.
    roll_x, _ = make_straggler_sim(sconfig, model, dt=DT, uniform_params=uni, uniform_mass=1.0, strag_pass="xla")
    xg, xa, _ = roll_x.forces(st)
    err_x = max(close(f"K3 {label} gather pass grid", xg[:, v], fg[:, v], atol=2e-5 * scale),
                close(f"K3 {label} gather pass aux", xa[:, av], fa[:, av], atol=2e-5 * scale))

    # K3's grid side with nothing listed is K2a, bit for bit.
    out_g = torch.empty_like(fg)
    cell_kernel.launch_strag(*args[:7], torch.full_like(table, -1), out_g, cfg, uni)
    same_fields(f"K3 {label} grid side with an empty table vs K2a", list(out_g),
                list(cell_kernel.cell_forces_split(*args[:4], cfg, uniform_params=uni, backend="cuda")))
    # The aux side vs the former one-warp-a-slot kernel (the source's
    # witness), bit for bit in every lane.
    out_a = torch.empty_like(fa)
    out_w = torch.empty_like(fa)
    aux = lambda: sk.launch_aux(*args[:8], out_a, sconfig, uni)  # noqa: E731
    aux_w = lambda: aux_call(build.load(), "emdee_straggler_aux_warp", args[:8], out_w, sconfig, uni)  # noqa: E731
    aux_w()
    torch.cuda.synchronize()
    same_fields(f"K3 {label} aux side vs the former kernel", [fa], [out_w])
    strag_ms = cuda_ms(lambda: cell_kernel.launch_strag(*args[:7], table, out_g, cfg, uni), 50)
    aux_t = dict(before_device_ms=device_ms(aux_w, 200), device_ms=device_ms(aux, 200),
                 before_ms=cuda_ms(aux_w, 200), ms=cuda_ms(aux, 200))
    strag_plain_ms = cuda_ms(lambda: sk.grid_forces_plain(*args[:7], table, sconfig, uni), 5)
    aux_plain_ms = cuda_ms(lambda: sk.aux_forces_plain(*args[:8], sconfig, uni), 20)
    gg = grid_pairs(p[0], p[1], p[2], v, cfg)
    ag, aa, cells = aux_pairs(*args[:8], sconfig)
    strag_bound = bound(25 * cfg.num_slots + 12 * a_cap + 4 * table.numel(),
                        OPS_PER_PAIR * gg + OPS_PER_MIN_IMAGED_PAIR * ag)
    aux_bound = bound(13 * cells * cfg.capacity + 28 * a_cap, OPS_PER_MIN_IMAGED_PAIR * (ag + aa))
    log(f"{tag} K3 {label}: C_t={cfg.capacity} C_w={sconfig.wide_capacity} A={a_cap} Kn={sconfig.kn}, "
        f"{parked} parked, {int((table >= 0).sum())} list entries; kernel vs plain max |dF| grid "
        f"{err_g:.3e} aux {err_a:.3e} (scale {scale:.3f}); vs wide state max |dF| {err_w:.3e} "
        f"(rel {err_w / wscale:.3e}); gather pass vs kernel {err_x:.3e}; empty slots and lanes exactly 0; "
        "with an empty table the grid side equals K2a bit for bit")
    log(f"{tag} K3 {label} at C_w={cfg_w.capacity}: K2b kernel vs plain max |dF| {err_e:.3e} (energies, "
        f"virials in tolerance, empty slots exactly 0); K4 kernel vs plain bit-exact in every field and "
        f"the flag, {moved_w} slots moved, {tail_w} atoms in the pad slots after the rebin")
    before = f"before the redesign {K3_BEFORE['strag_ms']}, " if label == "production" else ""
    log(f"{tag} K3 {label} times: grid launch (STRAG) {strag_ms:.4f} ms ({before}plain {strag_plain_ms:.3f} ms, "
        f"bound {strag_bound[0]:.5f} ms {strag_bound[1]}); aux launch {aux_t['device_ms']:.5f} ms on the device, "
        f"{aux_t['ms']:.5f} with the host's launch cost (bit for bit the former one-warp-a-slot kernel: "
        f"{aux_t['before_device_ms']:.5f} and {aux_t['before_ms']:.5f}; plain {aux_plain_ms:.3f} ms, bound "
        f"{aux_bound[0]:.6f} ms {aux_bound[1]}); pairs: grid {gg:,}, aux-grid {ag:,}, aux-aux {aa}")
    return {
        "strag": {"max_abs_err": err_g, "ms": strag_ms, "plain_ms": strag_plain_ms,
                  "bound_ms": strag_bound[0], "bound_by": strag_bound[1]},
        "aux": {"max_abs_err": err_a, **aux_t, "plain_ms": aux_plain_ms,
                "bound_ms": aux_bound[0], "bound_by": aux_bound[1], "library_ms": None},
        "wide_force_err": err_e,
    }


def by_atom(state, values, n):
    """Per-slot values (M³, C, …) of a dense state in atom order (n, …)."""
    out = torch.zeros((n,) + tuple(values.shape[2:]), dtype=values.dtype, device=values.device)
    out[state.atom_id[state.valid].long()] = values[state.valid]
    return out


def spill_counts(pos, config):
    """(atoms the spill init stores outside their own cell, of them across
    the periodic seam) for atom positions `pos` on a spill config."""
    from emdee_tpu_torch.neighbors.cell_dense import _spill_assign_np

    p64 = pos.astype(np.float64)
    p64 = p64 - np.floor(p64 / config.box) * config.box
    cells, _, seam, ok = _spill_assign_np(p64, config)
    if not ok:
        raise AssertionError("spill init: the assignment overflows")
    free = _spill_assign_np(p64, config._replace(capacity=len(pos)))[0]
    return int((cells != free).sum()), int(seam.any(1).sum())


def split_vs_plain(st, config, uni, scale, label):
    """The split force kernel (K2a) vs its plain version on one state,
    within 2e-5 of the force scale: returns ((fx, fy, fz), max |dF|)."""
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces_split

    px, py, pz = (st.positions[..., i].contiguous() for i in range(3))
    fk = cell_forces_split(px, py, pz, st.valid, config, uniform_params=uni, backend="cuda")
    fp = cell_forces_split(px, py, pz, st.valid, config, uniform_params=uni, backend="torch")
    torch.cuda.synchronize()
    v = st.valid
    return fk, max(close(f"{label} split f{a}", k[v], p[v], atol=2e-5 * scale) for a, k, p in zip("xyz", fk, fp))


def phase_seam(device, tag, model, uni):
    """A spill init with seam spills on the card: 1,500 atoms at random at
    ρ = 0.75, 0.85σ apart at least (seed 0), on their spill config with the
    capacity cut to 28 (tests/test_torch_spill.py's fixture), so that the
    init stores atoms across the periodic seam; then K2b and K2a vs their
    plain versions, which min-image every difference, on the init state —
    a seam spill stored a box away from its cell's frame fails this.
    Returns max |dF|."""
    from emdee_tpu_torch import cell_dense_init, lennard_jones_atom, suggest_cell_dense_config
    from emdee_tpu_torch.utils.lattice import maxwell_boltzmann, random_fluid

    n = 1500
    pos, box = random_fluid(n, 0.75, 0.85, seed=0)
    config = suggest_cell_dense_config(n, box, CUTOFF, SWITCH, 0.3, spill=True)._replace(capacity=28)
    params = lennard_jones_atom(np.ones(n), np.ones(n), device=device)
    st = cell_dense_init(pos, maxwell_boltzmann(n, 1.0, seed=1), np.ones(n), params, config, device=device)
    spilled, at_seam = spill_counts(pos, config)
    if bool(st.overflow) or at_seam < 1:
        raise AssertionError(f"seam fixture: overflow {bool(st.overflow)}, {at_seam} atoms spilled at the seam")
    err_e, scale = check_cell_forces(st, config, model, "seam spill init")
    _, err_s = split_vs_plain(st, config, uni, scale, "seam spill init")
    log(f"{tag} seam spill init: {n} atoms, M={config.cells_per_dim} C={config.capacity}, {spilled} atoms "
        f"spilled at init, {at_seam} across the seam; kernel vs plain max |dF| per-atom+energies {err_e:.3e}, "
        f"split {err_s:.3e} (scale {scale:.3f})")
    return max(err_e, err_s)


def phase_spill_init(device, tag, pos_eq, vel_eq, params, model, uni, wide):
    """The equilibrated melt re-initialised on its spill config: how many
    atoms the init spills (across the periodic seam), then K2b and K2a vs
    their plain versions on the init state, and the kernel's forces in atom
    order vs the wide state's.  Returns (state, config, max |dF|)."""
    from emdee_tpu_torch import cell_dense_init
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces

    n = wide.num_atoms
    scfg = spill_config(wide)
    st = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, scfg, device=device)
    spilled, at_seam = spill_counts(pos_eq, scfg)
    if bool(st.overflow) or spilled < 1:
        raise AssertionError(f"spill init: overflow {bool(st.overflow)}, {spilled} spilled")
    err_e, scale = check_cell_forces(st, scfg, model, "spill init")
    fk, err_s = split_vs_plain(st, scfg, uni, scale, "spill init")
    wst = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, wide, device=device)
    fw = by_atom(wst, cell_forces(wst, model, wide, backend="cuda")[0], n)
    fs = by_atom(st, torch.stack(fk, -1), n)
    torch.cuda.synchronize()
    err_w = close("spill init vs wide state", fs, fw, atol=2e-5 * scale)
    log(f"{tag} spill init: {n} atoms, M={scfg.cells_per_dim} C={scfg.capacity} "
        f"(eps {scfg.cell_side - CUTOFF - SKIN:.4f}), {spilled} atoms spilled at init, {at_seam} across the seam; "
        f"kernel vs plain max |dF| per-atom+energies {err_e:.3e}, split {err_s:.3e}; vs the wide state's "
        f"forces in atom order {err_w:.3e} (scale {scale:.3f})")
    return st, scfg, max(err_e, err_s)


def phase_compact(device, tag, st, scfg):
    """K7, the spill route's three passes in one cooperative launch, on the
    spill state drifted 0.45·skin as the component carry calls it (raw
    positions and velocities as strided views, atom id, the valid mask, the
    wrap) — and with the cells at y = 0 moved one cell up, so that the y
    pass overflows between the other two — vs its plain version and vs the
    former route on the card (the torch masks and ranks with the former
    compaction kernel, `compact_window.cu`, three launches): every field,
    the valid mask and the flag, bit for bit; then the times of K7, of the
    former route, of the plain version and of one pass's compaction by one
    `scatter_` call, on both clocks, and K7's bound and cooperative grid."""
    import ctypes

    from emdee_tpu_torch.csrc import build
    from emdee_tpu_torch.neighbors.cell_dense import _axis_coords, _rebin_shift_core, _roll_cells, _route_windows, \
        _spill_params
    from emdee_tpu_torch.neighbors.compact_kernel import spill_route_plain, spill_routing

    sd = drifted(st, SKIN)
    m, c, ns = scfg.cells_per_dim, scfg.capacity, scfg.num_slots
    box = torch.full((), scfg.box, dtype=torch.float32, device=device)
    spill = _spill_params(scfg)
    ovf0 = torch.zeros((), dtype=torch.bool, device=device)

    def fields_of(pos):
        return [pos[..., i] for i in range(3)] + [sd.velocities[..., i] for i in range(3)] + [sd.atom_id]

    fields = fields_of(sd.positions)
    rk, vk, ok_ = _rebin_shift_core(list(fields), sd.valid, ovf0, scfg, "cuda")
    rp, vp, op_ = _rebin_shift_core(list(fields), sd.valid, ovf0, scfg, "torch")
    torch.cuda.synchronize()
    same_fields("spill route kernel vs plain", rk + [vk, ok_], rp + [vp, op_])
    moved = int(((rk[6] != sd.atom_id) & vk).sum())
    if bool(ok_) or moved < 1000:
        raise AssertionError(f"spill route fixture: overflow {bool(ok_)}, {moved} slots moved")

    def held(label, flds, flag):
        args = (flds, box, m, c, ns, spill, sd.valid)
        plain = spill_routing(*args, backend="torch")
        witness = spill_route_plain(*args, compact="cuda")
        flat = lambda r: list(r[0]) + [r[1], r[2]]  # noqa: E731
        got = spill_routing(*args, backend="cuda")
        torch.cuda.synchronize()
        same_fields(f"K7 {label} vs plain", flat(got), flat(plain))
        same_fields(f"K7 {label} vs the former route", flat(got), flat(witness))
        if bool(plain[2]) != flag:
            raise AssertionError(f"K7 {label}: flag {bool(plain[2])}, expected {flag}")

    held("drifted", fields, False)
    crowd = ((torch.arange(m**3, device=device) // m) % m == 0)[:, None] & sd.valid
    crowded = sd.positions.clone()
    crowded[..., 1] += torch.where(crowd, float(scfg.cell_side), 0.0)
    held("y pass overflowing", fields_of(crowded), True)

    args = (fields, box, m, c, ns, spill, sd.valid)
    call = lambda: spill_routing(*args, backend="cuda")  # noqa: E731
    former = lambda: spill_route_plain(*args, compact="cuda")  # noqa: E731
    reps = 50
    t = dict(device_ms=device_ms(call, reps), before_device_ms=device_ms(former, reps), ms=cuda_ms(call, reps),
             before_ms=cuda_ms(former, reps))
    plain_ms = cuda_ms(lambda: spill_routing(*args, backend="torch"), 10)
    # One pass's compaction as one scatter_ (the z pass's windows): the part
    # of the route that one PyTorch call computes.
    wrapped = [torch.where(sd.valid, f - torch.floor(f / box) * box, 0.0) for f in fields[:3]] + fields[3:]
    nbr = lambda x, d: _roll_cells(x, (0, 0, d), m)  # noqa: E731  the z pass
    s_, keep, win, _, _ = _route_windows(wrapped, sd.valid, ovf0, 2, _axis_coords(m, device)[0], m, c, nbr, box,
                                         spill)
    nf, rows, k3 = win.shape
    lane = torch.arange(k3, device=device)
    placed = keep & (lane - s_ < c)
    dest = torch.where(placed, lane - s_.long(), c).expand(nf, rows, k3)
    dump = torch.zeros((nf, rows, c + 1), dtype=torch.int32, device=device)
    scatter_ms = device_ms(lambda: dump.scatter_(2, dest, win), 200)
    grid = (ctypes.c_int * 4)()
    build.check(build.load().emdee_spill_routing_attrs(grid), "spill_routing attrs")
    # The nf fields read once and written once, and the valid mask.
    bound_ms, bound_by = bound(2 * 4 * nf * ns + ns, 0)
    log(f"{tag} K7 at the spill config (M={m} C={c} squeeze target {scfg.spill_target}, nf={nf}, strided "
        f"positions and velocities, the valid mask, the wrap): bit for bit the plain version and the former route "
        f"(torch masks + compact_window.cu) in every field, the mask and the flag (drifted, {moved} slots moved; a "
        f"y pass overflowing between the other two); one cooperative launch, {grid[0]} blocks an SM on {grid[1]} "
        f"SMs, {grid[2]} threads a block, a warp a row: {t['device_ms']:.5f} ms a rebin on the device "
        f"({t['ms']:.5f} with the host's launch cost); the former route {t['before_device_ms']:.5f} "
        f"({t['before_ms']:.5f}); plain {plain_ms:.3f} ms; one pass's compaction by one scatter_ {scatter_ms:.5f} "
        f"ms; bound {bound_ms:.5f} ms ({bound_by}, {bound_ms / t['device_ms']:.1%} of it reached)")
    return {"max_abs_err": 0.0, **t, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "scatter_ms": scatter_ms,
            "grid": {"blocks_per_sm": grid[0], "sms": grid[1], "threads": grid[2], "rows_a_block": grid[3],
                     "rows": m**3}}


def off_true_cell(st, config) -> int:
    """Atoms a spill state stores outside their true cell (spills and
    hold-backs since the last rebin)."""
    m = config.cells_per_dim
    p = st.positions[st.valid]
    v = torch.clamp(torch.floor(m * (p / config.box - torch.floor(p / config.box))).long(), 0, m - 1)
    true = v[:, 0] + m * (v[:, 1] + m * v[:, 2])
    cell = torch.arange(config.num_cells, device=p.device)[:, None].expand_as(st.valid)[st.valid]
    return int((true != cell).sum())


def flag_cause(st, config) -> str:
    """What a spill state meets at its next rebin: the occupancy of the
    atoms' true cells, and per routing pass the largest arrival count, the
    cells above capacity and whether the pass raises the flag."""
    from emdee_tpu_torch.neighbors.cell_dense import (
        _PASSES, _axis_coords, _roll_cells, _route_axis_pass, _route_windows, _spill_params,
    )

    m, c = config.cells_per_dim, config.capacity
    dev = st.positions.device
    box = torch.full((), config.box, dtype=torch.float32, device=dev)
    p = st.positions[st.valid]
    v = torch.clamp(torch.floor(m * (p / box - torch.floor(p / box))).long(), 0, m - 1)
    occ = torch.bincount(v[:, 0] + m * (v[:, 1] + m * v[:, 2]), minlength=m**3).double()
    notes = [f"true-cell occupancy mean {float(occ.mean()):.2f}, sd {float(occ.std()):.2f}, max {int(occ.max())}"]
    valid = st.valid
    fields = [torch.where(valid, st.positions[..., i] - torch.floor(st.positions[..., i] / box) * box, 0.0)
              for i in range(3)]
    fields += [st.velocities[..., i] for i in range(3)] + [st.atom_id]
    coords = _axis_coords(m, dev)
    for axis, off, cf in _PASSES:
        nbr = lambda x, d, off=off: _roll_cells(x, tuple(d * o for o in off), m)  # noqa: E731
        ovf = torch.zeros((), dtype=torch.bool, device=dev)
        args = (fields, valid, ovf, cf, coords[axis], m, c, nbr, box)
        counts, flag = _route_windows(*args, _spill_params(config))[3:]
        notes.append(f"{'zyx'[axis]} pass: max arrivals {int(counts.max())}, {int((counts > c).sum())} cells "
                     f"above C, flag {bool(flag)}")
        fields, valid, _ = _route_axis_pass(*args, spill=_spill_params(config), last_fill=config.num_slots,
                                            backend="cuda")
    return "; ".join(notes)


def phase_spill_path(tag, st0, scfg, model, uni, k, main_ms, save_flag=None):
    """Spill NVE on the component carry: first, at the suggested capacity
    without squeeze, how many rebin blocks pass before the sticky flag trips
    (a measurement, not a gate; with `save_flag`, the state before the
    flagged block's rebin and its config go to that .npz file); then at the
    squeeze target 1,000 gated steps (K7 once a rebin, K4 never),
    bitwise reruns, no host waits; then a short stacked per-atom run.
    Returns ({path: counts}, ms/step)."""
    from emdee_tpu_torch import make_cell_dense_sim
    from emdee_tpu_torch.neighbors.cell_dense import _rebin_shift, state_to_numpy

    n = scfg.num_atoms
    plain_cfg = scfg._replace(spill_target=0)
    roll0, _ = make_cell_dense_sim(plain_cfg, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    st, prev, blocks = st0, st0, 0
    while blocks < 200 and not bool(st.overflow):
        prev, st, blocks = st, roll0(st, num_steps=k, rebin_every=k), blocks + 1
    log(f"{tag} spill config without squeeze (C={plain_cfg.capacity}): "
        + (f"sticky flag after {blocks} rebin blocks of {k} steps; its last rebin: {flag_cause(prev, plain_cfg)}"
           if bool(st.overflow) else f"no flag in {blocks} rebin blocks of {k} steps"))
    if save_flag and bool(st.overflow):
        np.savez(save_flag, config=json.dumps(plain_cfg._asdict(), default=float), blocks=blocks,
                 rebin_every=k, **state_to_numpy(prev))
        log(f"{tag} saved the state before the flagged rebin to {save_flag}")

    rollout, energy = make_cell_dense_sim(scfg, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    rollout(st0, num_steps=2 * k, rebin_every=k)  # warm-up
    steps = 1000
    out, sec, drift, counts = gate_rollout(
        "spill path", rollout, energy, st0, steps, k,
        launches(cell_forces=steps + 2 + 2, compact_window=-(-steps // k)),
    )
    off = off_true_cell(_rebin_shift(out, scfg, backend="cuda"), scfg)
    bitwise_rerun("spill path", rollout, st0, 100, k)
    no_host_waits("spill path", lambda: rollout(st0, num_steps=2 * k, rebin_every=k))
    ms = 1e3 * sec / steps
    log(f"{tag} spill path (component carry, M={scfg.cells_per_dim} C={scfg.capacity} squeeze target "
        f"{scfg.spill_target}): {steps} steps in {sec:.3f} s = {ms:.4f} ms/step, {n * steps / sec:,.0f} "
        f"atom-steps/s; NVE drift {drift:.3e}; launches {counts}; {off} atoms stored off their true cell after "
        "a rebin of the end state; two 100-step rollouts bitwise equal; no host waits")

    roll_s, energy_s = make_cell_dense_sim(scfg, model, dt=DT)
    steps_s = 100
    _, sec_s, drift_s, counts_s = gate_rollout(
        "spill stacked path", roll_s, energy_s, st0, steps_s, k,
        launches(cell_forces=steps_s + 2 + 2, compact_window=-(-steps_s // k)),
    )
    bitwise_rerun("spill stacked path", roll_s, st0, 50, k)
    no_host_waits("spill stacked path", lambda: roll_s(st0, num_steps=2 * k, rebin_every=k))
    log(f"{tag} spill stacked path (per-atom params): {steps_s} steps, {1e3 * sec_s / steps_s:.4f} ms/step; "
        f"NVE drift {drift_s:.3e}; launches {counts_s}; reruns bitwise equal; no host waits")
    log(f"{tag}: spill path {ms:.4f} ms/step ({n * 1e3 / ms:,.0f} atom-steps/s) vs dense main path "
        f"{main_ms:.4f} ms/step ({n * 1e3 / main_ms:,.0f} atom-steps/s)")
    return {"spill": counts, "spill_stacked": counts_s}, ms


def pressure(energy, st, config):
    _, vir, ke = energy(st)
    box = config.box if st.box is None else float(st.box)
    return (2.0 * float(ke) + float(vir)) / (3.0 * box**3)


def phase_thermostat(tag, label, config, model, st0, thermostat, rebin, main_ms, **extra):
    """An NVT (or, with a barostat in `extra`, NPT) path: 1,000 steps from
    st0 with per-block records and the launch counts gated, the temperature
    of the last 500 steps, reruns bitwise equal from one generator seed and
    different from another, no host waits.  Returns (end state, counts,
    ms/step, mean T* of the last 500 steps, records)."""
    from emdee_tpu_torch import make_cell_dense_sim

    n = config.num_atoms
    device = st0.positions.device
    rollout, energy = make_cell_dense_sim(config, model, dt=DT, thermostat=thermostat, **extra)
    rollout(st0, num_steps=2 * rebin, rebin_every=rebin, rng=torch.Generator(device=device).manual_seed(1))
    steps = 1000
    records, rebins = steps // rebin, -(-steps // rebin)
    # One force pass a step and one to start; K2b with energies for each
    # record and, with a barostat, for each block's pressure.
    forces = 1 + steps + records + (rebins if "barostat" in extra else 0)
    routing = {"compact_window": rebins} if config.spill else {"rebin_routing": rebins}
    expected = launches(cell_forces=forces, **routing)
    zero_counts()
    g = torch.Generator(device=device).manual_seed(7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, rec = rollout(st0, num_steps=steps, rebin_every=rebin, record=True, rng=g)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = read_counts()
    if bool(out.overflow):
        raise AssertionError(f"{label}: overflow")
    if counts != expected:
        raise AssertionError(f"{label}: kernel launches {counts}, expected {expected}")
    step, _, _, ke = rec
    last = step > int(st0.step) + steps - 500
    t_last = float((2.0 * ke[last].double() / (3.0 * n - 3.0)).mean())
    if not abs(t_last / T_NVT - 1.0) <= T_GATE:
        raise AssertionError(f"{label}: mean T* of the last 500 steps {t_last:.4f}, target {T_NVT}")
    bitwise_rerun(label, rollout, st0, 100, rebin, seed=11)
    no_host_waits(label, lambda: rollout(st0, num_steps=2 * rebin, rebin_every=rebin, record=True,
                                         rng=torch.Generator(device=device).manual_seed(3)))
    ms = 1e3 * sec / steps
    log(f"{tag} {label} (M={config.cells_per_dim} C={config.capacity}, rebin every {rebin}): {steps} steps in "
        f"{sec:.3f} s = {ms:.4f} ms/step, {n * steps / sec:,.0f} atom-steps/s (dense main path {main_ms:.4f} "
        f"ms/step); mean T* of the last 500 steps {t_last:.4f}; launches {counts}; reruns from one seed "
        "bitwise equal, another seed differs; no host waits")
    return out, counts, ms, t_last, energy


def phase_nvt_npt(device, tag, wide, spill_st, scfg, model, pos_eq, vel_eq, params, main_ms):
    """CSVR NVT on the wide config (K2b + K4), Langevin NVT on the spill
    config (K2b + K7), NPT from the CSVR state (K2b and K4 reading the
    dynamic box on the device), and `reconfigure_dense_state` on the NPT
    end state.  Returns ({path: counts}, {path: ms/step})."""
    from emdee_tpu_torch import (
        BerendsenBarostatConfig, CSVRConfig, LangevinConfig, cell_dense_init, gather_dense_fields,
        reconfigure_dense_state, suggest_rebin_interval,
    )

    n = wide.num_atoms
    k = suggest_rebin_interval(SKIN, DT, T_NVT)
    csvr = CSVRConfig(T_NVT, TAU_T)
    st0 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, wide, device=device)
    nvt, c_nvt, ms_nvt, _, energy = phase_thermostat(tag, "NVT CSVR path", wide, model, st0, csvr, k, main_ms)
    _, c_lan, ms_lan, _, _ = phase_thermostat(tag, "NVT Langevin spill path", scfg, model, spill_st,
                                              LangevinConfig(T_NVT, FRICTION), k, main_ms)

    p0 = pressure(energy, nvt, wide)
    npt, c_npt, ms_npt, _, _ = phase_thermostat(
        tag, "NPT path", wide, model, nvt, csvr, k, main_ms,
        barostat=BerendsenBarostatConfig(P_NPT, TAU_P, KAPPA))
    p1 = pressure(energy, npt, wide)
    grew = float(npt.box) / wide.box - 1.0
    log(f"{tag} NPT: P* {p0:.4f} -> {p1:.4f} (target {P_NPT}), box {wide.box:.4f} -> {float(npt.box):.4f} "
        f"({100 * grew:+.2f}%)")
    if not (grew > 0.01 and abs(p1 - P_NPT) < 0.5 * abs(p0 - P_NPT)):
        raise AssertionError(f"NPT: box grew {grew:.4f}, P* {p0:.4f} -> {p1:.4f}")

    st2, cfg2 = reconfigure_dense_state(npt, wide)
    a, b = gather_dense_fields(npt, n), gather_dense_fields(st2, n)
    box2 = np.float32(cfg2.box)
    for name in ("velocities", "masses", "half_sigma", "twice_sqrt_eps"):
        if not np.array_equal(a[name], b[name]):
            raise AssertionError(f"reconfigure: {name} changed")
    wrap = lambda p: p - np.floor(p / box2) * box2  # noqa: E731
    if not np.array_equal(wrap(a["positions"]), wrap(b["positions"])):
        raise AssertionError("reconfigure: positions changed beyond the wrap")
    if int(st2.step) != int(npt.step) or bool(st2.overflow) or int(st2.valid.sum()) != n:
        raise AssertionError("reconfigure: step, flag or atom count")
    log(f"{tag} reconfigure_dense_state on the NPT end state: M={wide.cells_per_dim} C={wide.capacity} -> "
        f"M={cfg2.cells_per_dim} C={cfg2.capacity} at box {cfg2.box:.4f}; every per-atom field survives "
        f"exactly, step {int(st2.step)} carried over")
    return ({"nvt_csvr": c_nvt, "nvt_langevin_spill": c_lan, "npt": c_npt},
            {"nvt_csvr": ms_nvt, "nvt_langevin_spill": ms_lan, "npt": ms_npt})


def grid_fields(sh, ns):
    """A grid-sharded state's transported fields as the grid engine's NVE
    rebin reads them: x, y, z, vx, vy, vz, 1/m, σ/2, 2√ε (views of the
    state's tensors), atom id (ns in empty slots)."""
    pos3, vel3 = sh.positions.movedim(-1, 0), sh.velocities.movedim(-1, 0)
    return ([pos3[i] for i in range(3)] + [vel3[i] for i in range(3)]
            + [sh.inv_masses, sh.half_sigma, sh.twice_sqrt_eps, torch.where(sh.valid, sh.atom_id, ns)])


def k7g_passes(fields, mesh, coords, box, m, c, ns, spill, check):
    """K7-G's per-pass form: three launches over two-layer halo planes; with
    `check`, each pass vs its plain version, bit for bit in every slot and
    the flag.  Returns (out, flag)."""
    from emdee_tpu_torch.neighbors import rebin_window_kernel as k6

    x, raised = fields, torch.zeros((), dtype=torch.int32, device=fields[0].device)
    for axis in range(3):
        lo, hi = k6.halo_planes(x, mesh, axis, depth=2)
        args = (x, lo, hi, coords[axis], box, axis, m, c, ns, spill, axis == 0)
        got, flag = k6.spill_halo_pass(*args, backend="cuda")
        if check:
            plain, ovf = k6.spill_halo_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, plain) or bool(flag) != bool(ovf):
                raise AssertionError(f"K7-G: the {'zyx'[axis]} pass differs from its plain version")
        raised = raised | flag
        x = got
    return x, raised


def k7g_forms(fields, mesh, coords, box, m, c, ns, spill, label):
    """K7-G's one-launch form vs its plain version and vs the per-pass
    form's three launches (each pass vs its plain version), bit for bit in
    every slot and the flag.  Returns (per-pass out, one-launch out, flag)."""
    from emdee_tpu_torch.neighbors import rebin_window_kernel as k6

    x, raised = k7g_passes(fields, mesh, coords, box, m, c, ns, spill, True)
    y, flag = k6.spill_grid_rebin(fields, mesh, coords, box, m, c, ns, spill, backend="cuda")
    plain, ovf = k6.spill_grid_rebin_plain(fields, box, m, c, ns, spill)
    torch.cuda.synchronize()
    if not torch.equal(y, plain) or bool(flag) != bool(ovf):
        raise AssertionError(f"K7-G one launch {label}: differs from its plain version")
    if not torch.equal(y, x) or bool(flag) != bool(raised):
        raise AssertionError(f"K7-G one launch {label}: differs from the three per-pass launches")
    return x, y, bool(flag)


def k7g_grid_warps():
    """The one-launch form's cooperative grid as the card reports it:
    (resident blocks an SM, SMs, threads a block, rows a block at a time),
    and the resident warps, each taking every warps-th row."""
    import ctypes

    from emdee_tpu_torch.csrc import build

    attrs = (ctypes.c_int * 4)()
    build.check(build.load().emdee_spill_grid_attrs(attrs), "spill_grid attrs")
    res = dict(zip(("blocks_per_sm", "sms", "threads", "rows_a_block"), attrs))
    return res, res["blocks_per_sm"] * res["sms"] * res["rows_a_block"]


def phase_sort_rebin(device, tag):
    """The sort rebin kernel at the 1M melt's config (M = 37, C = 32; the
    benchmark's), drifted across the seam: `cell_dense._rebin` on 'cuda'
    (one launch) vs 'torch' (the plain torch ops), bit for bit in every
    field and the flag, without and with forces.  Times on both clocks
    (CUDA events behind a device spin, and around back-to-back calls), the
    plain rebin's beside them, the byte bound, and the cooperative grid."""
    import ctypes

    from emdee_tpu_torch.csrc import build
    from emdee_tpu_torch.neighbors.cell_dense import _rebin

    st, config, _, _, _, n = melt(device, N_CELLS_1M)
    st = drifted(st, SKIN)
    ns = config.num_slots
    forces = torch.randn(st.positions.shape, generator=torch.Generator(device=device).manual_seed(3), device=device)
    for label, f in (("", None), (" with forces", forces)):
        a = _rebin(st, config, f, backend="cuda")
        b = _rebin(st, config, f, backend="torch")
        torch.cuda.synchronize()
        if f is not None:
            (a, fa), (b, fb) = a, b
            same_fields("sort rebin kernel forces vs plain", [fa], [fb])
        same_fields(f"sort rebin kernel{label} vs plain", list(a), list(b))
    moved = int(((a.atom_id != st.atom_id) & a.valid).sum())
    if bool(a.overflow) or moved < 10_000:
        raise AssertionError(f"sort rebin fixture: overflow {bool(a.overflow)}, {moved} slots moved")

    call = lambda: _rebin(st, config, backend="cuda")  # noqa: E731
    t = dict(device_ms=device_ms(call, 50), ms=cuda_ms(call, 50))
    plain_ms = cuda_ms(lambda: _rebin(st, config, backend="torch"), 10)
    grid = (ctypes.c_int * 4)()
    build.check(build.load().emdee_sort_rebin_attrs(grid), "sort_rebin attrs")
    # Each slot's position and valid byte read (13 B), each atom's bucket
    # entry written and read back (8 B) and its ten words gathered (40 B),
    # each slot's ten words and valid byte written (41 B).
    bound_ms, bound_by = bound(54 * ns + 48 * n, 0)
    log(f"{tag} sort rebin kernel at {n} atoms, M={config.cells_per_dim} C={config.capacity}: bit for bit the "
        f"plain sort rebin in every field and the flag, without and with forces ({moved} slots moved); one "
        f"cooperative launch, {grid[0]} blocks an SM on {grid[1]} SMs, {grid[2]} threads a block, a warp a "
        f"cell; {t['device_ms']:.5f} ms a rebin on the device ({t['ms']:.5f} with the host's launch cost); "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return {"max_abs_err": 0.0, **t, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "grid": {"blocks_per_sm": grid[0], "sms": grid[1], "threads": grid[2],
                                         "cells_a_block": grid[3], "cells": config.num_cells}}


def phase_rebin_window(device, tag):
    """K6 (the grid engine's rebin pass: a warp a row over each shard's own
    rows, with only the halo planes exchanged) as the grid's rebin calls it
    — the first pass on the transported fields where they lie (strided
    position and velocity views, per-atom parameters, atom id), parked and
    wrapped in the kernel — on the drifted melt as one shard holding the
    whole periodic grid (M = 17, C = 32) and on (2,2,2) at M = 16, C = 40:
    each pass vs its plain version and vs the former kernel over whole
    windows, bit for bit in every slot and the flag; on one shard the three
    passes vs K4's rebin; then, on both clocks, the z pass alone and the
    whole rebin (halo planes and three passes) beside the former ones
    (`before_*`: the former kernel alone on pre-built windows, and the torch
    park, stack and window copies with it), the plain version and the
    bound."""
    from emdee_tpu_torch import cell_dense_init, gather_dense_atoms
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid
    from emdee_tpu_torch.distributed.mesh import LocalMesh
    from emdee_tpu_torch.neighbors import rebin_window_kernel as k6
    from emdee_tpu_torch.neighbors.rebin_kernel import rebin_routing

    st, config, _, params, _, n = melt(device)
    box = torch.full((), config.box, dtype=torch.float32, device=device)

    def new_rebin(x, mesh, local, m, c, ns):
        flag = None
        for axis in range(3):
            lo, hi = k6.halo_planes(x, mesh, axis)
            x, flag = k6.rebin_halo_pass(x, lo, hi, k6.global_coords(mesh, local, axis), box, axis, m, c, ns,
                                         raw=axis == 0, flag=flag, backend="cuda")
        return x, flag

    out = {}
    for shape in ((1, 1, 1), (2, 2, 2)):
        if shape == (1, 1, 1):
            cfg, s = config, drifted(st, SKIN)
        else:  # M = 16, C = 40
            cfg = even_config(st, config)
            pos, vel = gather_dense_atoms(st, n)
            s = drifted(cell_dense_init(pos, vel, np.ones(n), params, cfg, device=device), SKIN)
        m, c, ns = cfg.cells_per_dim, cfg.capacity, cfg.num_slots
        mesh = LocalMesh(shape, device)
        local = tuple(m // d for d in shape)
        sh = distribute_grid(s, cfg, mesh)
        fields = grid_fields(sh, ns)
        x = fields
        z_pass = None
        for axis in range(3):
            lo, hi = k6.halo_planes(x, mesh, axis)
            args = (x, lo, hi, k6.global_coords(mesh, local, axis), box, axis, m, c, ns, axis == 0)
            got, flag = k6.rebin_halo_pass(*args, backend="cuda")
            plain, ovf_p = k6.rebin_halo_plain(*args)
            witness, ovf_w = k6.rebin_halo_plain(*args, windows="cuda")
            torch.cuda.synchronize()
            if not (torch.equal(got, plain) and torch.equal(got, witness)) or not int(flag) == int(ovf_p) == \
                    int(ovf_w) == 0:
                raise AssertionError(f"K6 {shape}: the {'zyx'[axis]} pass differs from its plain version or the "
                                     "former kernel")
            z_pass = z_pass or args
            x = got
        moved = int(((x[-1] != fields[-1]) & (x[-1] < ns)).sum())
        if moved < 1000:
            raise AssertionError(f"K6 {shape} fixture: {moved} slots moved")
        if shape == (1, 1, 1):
            flds = [s.positions[..., i] for i in range(3)] + [s.velocities[..., i] for i in range(3)]
            flds += [s.inv_masses, s.half_sigma, s.twice_sqrt_eps, s.atom_id]
            ref, ovf = rebin_routing(tuple(flds), box, m, c, ns, backend="cuda", valid=s.valid, wrap=True)
            torch.cuda.synchronize()
            for i, r in enumerate(ref):
                if not torch.equal(x[i].reshape(m**3, c), r.view(torch.int32)):
                    raise AssertionError(f"K6 (one shard) vs K4: field {i} differs")
        former, fflag = k6.grid_rebin_witness(fields, mesh, local, box, m, c, ns)
        torch.cuda.synchronize()
        if not torch.equal(former, x) or bool(fflag):
            raise AssertionError(f"K6 {shape}: the rebin differs from the former grid rebin")
        # The former kernel alone on the z pass's pre-built windows.
        xs = torch.stack(k6._parked(fields, box, ns))
        win_args = k6.whole_windows(xs, *k6.halo_planes(xs, mesh, 0), 0) + (k6.global_coords(mesh, local, 0), box, 2,
                                                                             m, c, ns)
        z = lambda: k6.rebin_halo_pass(*z_pass, backend="cuda")  # noqa: E731
        z_former = lambda: k6.rebin_halo_plain(*z_pass, windows="cuda")  # noqa: E731
        z_kernel = lambda: k6.rebin_window_pass(*win_args, backend="cuda")  # noqa: E731
        whole = lambda: new_rebin(fields, mesh, local, m, c, ns)  # noqa: E731
        whole_former = lambda: k6.grid_rebin_witness(fields, mesh, local, box, m, c, ns)  # noqa: E731
        reps = 50
        t = dict(device_ms=device_ms(z, reps), before_kernel_device_ms=device_ms(z_kernel, reps),
                 before_device_ms=device_ms(z_former, reps), ms=cuda_ms(z, reps),
                 before_kernel_ms=cuda_ms(z_kernel, reps), before_ms=cuda_ms(z_former, reps),
                 rebin_device_ms=device_ms(whole, 20), before_rebin_device_ms=device_ms(whole_former, 20),
                 rebin_ms=cuda_ms(whole, 20), before_rebin_ms=cuda_ms(whole_former, 20))
        plain_ms = cuda_ms(lambda: k6.rebin_halo_plain(*z_pass), 10)
        # Each field read once and written once, the halo planes read once
        # (none on an axis of one shard), and each row's coordinate.
        nf, rows = len(fields), m**3
        halo_slots = 0 if shape[0] == 1 else 2 * rows // local[0] * c
        bound_ms, bound_by = bound(4 * nf * (2 * rows * c + halo_slots) + 4 * rows, 0)
        log(f"{tag} K6 {shape} at {n} atoms drifted, M={m} C={c}, nf={nf} (strided positions and velocities, "
            f"parked and wrapped in the first pass): each pass vs plain and vs the former kernel over whole windows "
            f"bit-exact in every slot and the flag" + (", the three vs K4 bit-exact" if shape == (1, 1, 1) else "")
            + f" ({moved} slots moved); z pass {t['device_ms']:.5f} ms on the device ({t['ms']:.5f} with the host's "
            f"launch cost), the former kernel on pre-built windows {t['before_kernel_device_ms']:.5f} "
            f"({t['before_kernel_ms']:.5f}), with the torch park, stack and windows {t['before_device_ms']:.5f} "
            f"({t['before_ms']:.5f}); the whole rebin {t['rebin_device_ms']:.5f} ({t['rebin_ms']:.5f}), the former "
            f"{t['before_rebin_device_ms']:.5f} ({t['before_rebin_ms']:.5f}); plain z pass {plain_ms:.4f} ms; bound "
            f"{bound_ms:.5f} ms ({bound_by}, {bound_ms / t['device_ms']:.1%} of it reached)")
        out[shape] = {**t, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "m": m, "c": c}
    one = out[(1, 1, 1)]
    return {"max_abs_err": 0.0, **{key: value for key, value in one.items() if key not in ("m", "c")},
            "library_ms": None, "grid_222_m16": out[(2, 2, 2)]}


def grid_forces_check(tag, label, cfg, model, uni, mesh, st):
    """The grid engine's force pass (K2-G, the LJ pass's GHOST mode) on `st`
    drifted 0.45·skin: the uniform entry vs the one-card split kernel (K2a)
    and the per-atom entry with energies vs K2b, bit for bit; the kernel vs
    the ghost grid's plain version within 2e-5 of the force scale; the
    times of K2-G alone (beside its time before the redesign, where
    PERF.md has one), of its plain version, of the grid's force pass (halo
    exchange included) and of K2a at the same config, and K2-G's bound.
    Returns (max |dF| vs plain, K2-G's row fields)."""
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid, gather_grid_state, make_grid_sharded_sim
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces, cell_forces_split, ghost_forces

    sd = drifted(st, SKIN)
    sh = distribute_grid(sd, cfg, mesh)
    whole = lambda f, e=None, w=None: gather_grid_state(  # noqa: E731
        sh._replace(positions=f, half_sigma=sh.half_sigma if e is None else e,
                    twice_sqrt_eps=sh.twice_sqrt_eps if w is None else w), cfg, mesh)
    roll_u, _ = make_grid_sharded_sim(cfg, model, DT, mesh, uniform_params=uni)
    roll_a, _ = make_grid_sharded_sim(cfg, model, DT, mesh)
    roll_p, _ = make_grid_sharded_sim(cfg, model, DT, mesh, uniform_params=uni, backend="torch")
    fu = whole(roll_u.forces(sh)[0]).positions
    fa = whole(*roll_a.forces(sh, compute_energy=True))
    fp = whole(roll_p.forces(sh)[0]).positions
    px, py, pz = (sd.positions[..., i].contiguous() for i in range(3))
    ref_u = cell_forces_split(px, py, pz, sd.valid, cfg, uniform_params=uni, backend="cuda")
    ref_a = cell_forces(sd, model, cfg, compute_energy=True, backend="cuda")
    torch.cuda.synchronize()
    same = all(torch.equal(fu[..., i].view(torch.int32), ref_u[i].view(torch.int32)) for i in range(3))
    same = same and all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip((fa.positions, fa.half_sigma, fa.twice_sqrt_eps), ref_a))
    if not same:
        raise AssertionError(f"{label}: grid forces differ from the one-card kernel's")
    v = sd.valid
    scale = max(float(fp[v].abs().max()), 1.0)
    err = close(f"{label} ghost kernel vs plain", fu[v], fp[v], atol=2e-5 * scale)
    ms_grid = cuda_ms(lambda: roll_u.forces(sh), 20)
    ms_k2 = cuda_ms(lambda: cell_forces_split(px, py, pz, sd.valid, cfg, uniform_params=uni, backend="cuda"), 20)
    gh = ghost_stack(sh, mesh, per_atom=False, mol=False)
    args = (gh, mesh.local_shape, mesh.base, cfg, model)
    ms_g = cuda_ms(lambda: ghost_forces(*args, uniform_params=uni, backend="cuda"), 20)
    plain_g = cuda_ms(lambda: ghost_forces(*args, uniform_params=uni, backend="torch"), 2)
    pairs = grid_pairs(px, py, pz, sd.valid, cfg)
    # in: the ghost grids' x, y, z; out: the own slots' forces
    b_ms, b_by = bound(12 * gh[0].numel() + 12 * sd.valid.numel(), OPS_PER_PAIR * pairs)
    before = K2G_BEFORE.get((cfg.cells_per_dim, tuple(mesh.shape)), "not measured")
    k2_before = f" (before its redesign {K2_BEFORE['split_ms']})" if cfg.cells_per_dim == 17 else ""
    log(f"{tag} {label}: K2-G (uniform) {ms_g:.4f} ms a launch (before its redesign {before}), plain {plain_g:.3f} "
        f"ms, bound {b_ms:.5f} ms ({b_by}; {pairs:,} pairs inside the cutoff); force pass with the halo exchange "
        f"{ms_grid:.4f} ms, one-card K2a at this config {ms_k2:.4f} ms{k2_before}; K2-G vs plain max |dF| "
        f"{err:.3e} (scale {scale:.3f}); per-atom + energies and uniform bit for bit the one-card K2b and K2a")
    return err, {"ms": ms_g, "plain_ms": plain_g, "bound_ms": b_ms, "bound_by": b_by,
                 "pairs": pairs, "pass_ms": ms_grid, "k2a_ms": ms_k2, "max_abs_err": err, "force_scale": scale}


def grid_vs_dense_fixture(shape, device) -> float:
    """tests/test_grid_sharded.py's rollout gate on the card: its fixture
    (2,048 atoms on a jittered lattice at ρ = 0.09, T = 0.9, per-atom
    parameters, M = 8), 30 steps at dt = 0.002, rebin every 5, on the grid
    engine over `shape` and on the dense engine; returns the largest
    |Δposition| or |Δvelocity| by atom, which must be ≤ 2e-4."""
    from emdee_tpu_torch import (
        LennardJonesModel, cell_dense_init, gather_dense_atoms, lennard_jones_atom, make_cell_dense_sim,
        suggest_cell_dense_config,
    )
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid, gather_grid_atoms, make_grid_sharded_sim
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.utils.lattice import cubic_lattice, maxwell_boltzmann

    n = 2048
    pos, box = cubic_lattice(n, 0.09, jitter=0.1, seed=21)
    config = suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.3)
    config = config._replace(cells_per_dim=max((config.cells_per_dim // 8) * 8, 8))
    model = LennardJonesModel.create(2.5, 2.0, device=device)
    st = cell_dense_init(pos, maxwell_boltzmann(n, 0.9, seed=22), np.ones(n),
                         lennard_jones_atom(np.ones(n), np.ones(n), device=device), config, device=device)
    dense, _ = make_cell_dense_sim(config, model, dt=0.002)
    mesh = make_grid_mesh(shape, device=device)
    grid, _ = make_grid_sharded_sim(config, model, 0.002, mesh)
    ref, out = dense(st, num_steps=30, rebin_every=5), grid(distribute_grid(st, config, mesh), num_steps=30, rebin_every=5)
    if bool(ref.overflow) or bool(out.overflow):
        raise AssertionError(f"grid {shape} fixture: overflow")
    (pr, vr), (pg, vg) = gather_dense_atoms(ref, n), gather_grid_atoms(out, config, n, mesh)
    gap = float(max(np.abs(pg - pr).max(), np.abs(vg - vr).max()))
    if not gap <= 2e-4:
        raise AssertionError(f"grid {shape} fixture: 30 steps differ from the dense engine by {gap:.3e}")
    return gap


def phase_grid(device, tag, config, model, uni, pos_eq, vel_eq, params, k, main_ms):
    """The grid-sharded engine on the equilibrated melt: (1,1,1) at the main
    path's config, then at `reconfigure_dense_state(cells_multiple_of=2)`'s
    (1,1,1), (2,2,2) and (2,4,1), all shards on this card (`LocalMesh`).
    Each: forces bit for bit vs the one-card K2 and vs the plain version,
    energy vs the dense energy closure (rtol 1e-5), 30 steps vs the dense
    engine (on the JAX test's fixture within its 2e-4; on the melt
    measured), 1,000 gated NVE steps (no flag, drift, exact K2/K6
    launches), bitwise reruns, no host waits.  Then the three M = 16 runs
    bitwise equal, the (1,1,1) run through a one-rank NCCL `DistMesh`
    bitwise equal to `LocalMesh`, and a short CSVR run; K2-G's variants'
    resources as the card reports them.  Returns ({path: counts}, {path:
    ms/step}, max |dF| vs plain, K2-G's row fields by path, {path: device
    kernels a step})."""
    from emdee_tpu_torch import cell_dense_init, gather_dense_atoms, make_cell_dense_sim, reconfigure_dense_state
    from emdee_tpu_torch.distributed.grid_sharded import (
        distribute_grid, gather_grid_atoms, gather_grid_state, make_grid_sharded_sim,
    )
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors.cell_dense import state_to_numpy

    n = config.num_atoms
    st17 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, config, device=device)
    st16, cfg16 = reconfigure_dense_state(st17, config, cells_multiple_of=2)
    if cfg16.cells_per_dim != 16 or bool(st16.overflow):
        raise AssertionError(f"grid config: M={cfg16.cells_per_dim}, overflow {bool(st16.overflow)}")
    runs = [((1, 1, 1), config, st17), ((1, 1, 1), cfg16, st16), ((2, 2, 2), cfg16, st16), ((2, 4, 1), cfg16, st16)]
    steps, short = 1000, 30
    counts, ms, finals, err, k2g, kps = {}, {}, {}, 0.0, {}, {}
    fixture_gap = {shape: grid_vs_dense_fixture(shape, device) for shape in dict.fromkeys(r[0] for r in runs)}
    for shape, cfg, st in runs:
        name = f"grid_{''.join(map(str, shape))}_m{cfg.cells_per_dim}"
        label = f"grid {shape} M={cfg.cells_per_dim} C={cfg.capacity}"
        mesh = make_grid_mesh(shape, device=device)
        e, k2g[name] = grid_forces_check(tag, label, cfg, model, uni, mesh, st)
        err = max(err, e)
        roll, energy = make_grid_sharded_sim(cfg, model, DT, mesh, uniform_params=uni)
        d_roll, d_energy = make_cell_dense_sim(cfg, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
        sh = distribute_grid(st, cfg, mesh)
        for a, b, what in zip(energy(sh), d_energy(st), ("pe", "virial", "ke")):
            close(f"{label} {what} vs the dense energy closure", a, b, atol=0.0, rtol=1e-5)
        # The melt's gap to the dense engine after 30 steps, a measurement:
        # the dense leapfrog is Kahan-compensated, the grid's (as the
        # reference's) is not.  The gate is the JAX test's, on its fixture.
        pg, vg = gather_grid_atoms(roll(sh, num_steps=short, rebin_every=k), cfg, n, mesh)
        pd, vd = gather_dense_atoms(d_roll(st, num_steps=short, rebin_every=k), n)
        melt_gap = (float(np.abs(pg - pd).max()), float(np.abs(vg - vd).max()))
        vs_dense = fixture_gap[shape]
        out, sec, drift, c = gate_rollout(label, roll, energy, sh, steps, k,
                                          launches(cell_forces=steps + 4, rebin_window=3 * -(-steps // k)))
        bitwise_rerun(label, roll, sh, 100, k)
        no_host_waits(label, lambda: roll(sh, num_steps=2 * k, rebin_every=k))
        counts[name], ms[name] = c, 1e3 * sec / steps
        finals[name] = state_to_numpy(gather_grid_state(out, cfg, mesh))
        kps[name] = kernels_per_step(lambda: roll(sh, num_steps=60, rebin_every=k), 60)
        log(f"{tag} {label} (LocalMesh, uniform params): {steps} steps in {sec:.3f} s = {ms[name]:.4f} ms/step, "
            f"{ms[name] / main_ms:.2f}x the dense main path ({main_ms:.4f}); NVE drift {drift:.3e}; launches {c}; "
            f"forces bit-exact vs one-card K2; {short} steps vs the dense engine: the JAX test's fixture max |d| "
            f"{vs_dense:.3e} (gate 2e-4), the melt at dt={DT} positions {melt_gap[0]:.3e} velocities {melt_gap[1]:.3e}; "
            "energies vs the dense closure in rtol 1e-5; reruns bitwise equal; no host waits")
    m16 = [name for name in finals if name.endswith("m16")]
    for name in m16[1:]:
        for field, want in finals[m16[0]].items():
            if not np.array_equal(np.atleast_1d(finals[name][field]).view(np.uint8), np.atleast_1d(want).view(np.uint8)):
                raise AssertionError(f"{name} vs {m16[0]}: {field} differs after {steps} steps")
    log(f"{tag} grid M=16: {', '.join(m16)} bitwise equal in every field after {steps} steps")

    # The (1,1,1) run through torch.distributed: a one-rank NCCL group.
    nccl_vs_local_mesh("grid (1,1,1)", config, model, DT, st17, {"uniform_params": uni}, 100, k, device)
    log(f"{tag} grid (1,1,1) M=17 through a one-rank NCCL DistMesh: 100 steps and the energies bitwise equal "
        "to LocalMesh")

    # A short CSVR run on (2,2,2).
    from emdee_tpu_torch import CSVRConfig

    mesh = make_grid_mesh((2, 2, 2), device=device)
    sh = distribute_grid(st16, cfg16, mesh)
    roll, energy = make_grid_sharded_sim(cfg16, model, DT, mesh, uniform_params=uni, thermostat=CSVRConfig(T_NVT, TAU_T))
    roll(sh, num_steps=2 * k, rebin_every=k, rng=torch.Generator(device=device).manual_seed(1))  # warm-up
    zero_counts()
    csvr_steps = 200
    t0 = time.perf_counter()
    out = roll(sh, num_steps=csvr_steps, rebin_every=k, rng=torch.Generator(device=device).manual_seed(7))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    c = read_counts()
    if c != launches(cell_forces=csvr_steps + 1, rebin_window=3 * -(-csvr_steps // k)) or bool(out.overflow):
        raise AssertionError(f"grid CSVR: launches {c}, overflow {bool(out.overflow)}")
    t_of = lambda s: 2.0 * float(energy(s)[2]) / (3.0 * n - 3.0)  # noqa: E731
    t0_, t1_ = t_of(sh), t_of(out)
    if not abs(t1_ - T_NVT) < abs(t0_ - T_NVT):
        raise AssertionError(f"grid CSVR: T* {t0_:.4f} -> {t1_:.4f}, target {T_NVT}")
    bitwise_rerun("grid CSVR", roll, sh, 50, k, seed=11)
    no_host_waits("grid CSVR", lambda: roll(sh, num_steps=2 * k, rebin_every=k,
                                            rng=torch.Generator(device=device).manual_seed(3)))
    counts["grid_222_m16_csvr"], ms["grid_222_m16_csvr"] = c, 1e3 * sec / csvr_steps
    log(f"{tag} grid (2,2,2) M=16 CSVR (T*={T_NVT}, tau={TAU_T}): {csvr_steps} steps, "
        f"{ms['grid_222_m16_csvr']:.4f} ms/step; T* {t0_:.4f} -> {t1_:.4f}; launches {c}; reruns from one seed "
        "bitwise equal, another seed differs; no host waits")
    log(f"{tag}: grid ms/step " + ", ".join(f"{p} {v:.4f} ({v / main_ms:.2f}x)" for p, v in ms.items())
        + f" vs dense main path {main_ms:.4f}")
    from emdee_tpu_torch.neighbors.cell_kernel import lj_resources

    res = {name: lj_resources(u, e, False, True) for name, u, e in (
        ("uniform", True, False), ("per-atom", False, False), ("per-atom energies", False, True))}
    log(f"{tag} K2-G (cell_lj_kernel, GHOST) resources: {resources_line(res)}")
    return counts, ms, err, {**k2g, "resources": res}, kps


def phase_probes(device, tag):
    """P1 and P2 (the TPU probes of tools/) vs their plain versions on the
    card — P1 bit for bit for K in {5, 15, 25, 45}, P2 in both layouts
    within 1e-5 relative of the plain version and of `torch.matmul` (TF32
    off) — with their times and bounds.  Returns (P1 row, P2 row)."""
    from emdee_tpu_torch.tools import probes

    m, c = probes.M, probes.C
    ghost, centers = probes.probe_fma_inputs(m, c, device)
    sweep = {}
    for k_ops in probes.K_SWEEP:
        got = probes.probe_fma(ghost, centers, m, c, k_ops)
        want = probes.probe_fma_plain(ghost, centers, m, c, k_ops)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"P1 K={k_ops}: kernel vs plain differ")
        t = cuda_ms(lambda: probes.probe_fma(ghost, centers, m, c, k_ops), 50)
        lanes, ops, nbytes = probes.fma_counts(m, c, k_ops)
        sweep[k_ops] = (t, ops, nbytes)
        log(f"{tag} P1 K={k_ops}: bit-exact vs plain; {t:.4f} ms, {1e6 * t / (m * m * probes.TILES):.2f} ns a tile, "
            f"{ops / t / 1e9:.1f} T separately rounded op/s (at most {FP32_OPS_PER_S / 2e12:.1f} on this card)")
    k_top = probes.K_SWEEP[-1]
    t, ops, nbytes = sweep[k_top]
    plain_ms = cuda_ms(lambda: probes.probe_fma_plain(ghost, centers, m, c, k_top), 3)
    # P1 issues no FMA: each separately rounded multiply or add takes the
    # issue slot of an FMA, which FP32_OPS_PER_S counts as two operations.
    bound_ms, bound_by = bound(nbytes, 2 * ops)
    p1 = {"max_abs_err": 0.0, "ms": t, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "library_ms": None, "k_ops": k_top, "ms_by_k": {str(kk): v[0] for kk, v in sweep.items()}}
    log(f"{tag} P1 at K={k_top}: {t:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by})")

    rows = {}
    for transposed in (False, True):
        cen, expand = probes.probe_cen_inputs(transposed, device)
        a = cen.transpose(1, 2) if transposed else cen
        got = probes.probe_cen(cen, expand, transposed)
        want = probes.probe_cen_plain(cen, expand, transposed)
        lib = torch.matmul(a, expand)
        torch.cuda.synchronize()
        err = max(close(f"P2 {transposed=} vs plain", got, want, atol=0.0, rtol=1e-5),
                  close(f"P2 {transposed=} vs matmul", got, lib, atol=0.0, rtol=1e-5))
        t = cuda_ms(lambda: probes.probe_cen(cen, expand, transposed), 50)
        t_plain = cuda_ms(lambda: probes.probe_cen_plain(cen, expand, transposed), 5)
        t_lib = cuda_ms(lambda: torch.matmul(a, expand), 50)
        rows[transposed] = (err, t, t_plain, t_lib)
        before = P2_BEFORE["dgt" if transposed else "std"]
        log(f"{tag} P2 {'dgt (M, nC)' if transposed else 'std (nC, M)'}: vs plain and matmul within 1e-5 rel "
            f"(max |d| {err:.3e}); {t:.4f} ms (before the redesign {before}), plain {t_plain:.4f} ms, torch.matmul "
            f"(TF32 off) {t_lib:.4f} ms")
    ops, nbytes = probes.cen_counts()
    bound_ms, bound_by = bound(nbytes, ops)
    err, t, t_plain, t_lib = rows[False]
    p2 = {"max_abs_err": max(r[0] for r in rows.values()), "ms": t, "plain_ms": t_plain, "bound_ms": bound_ms,
          "bound_by": bound_by, "library_ms": t_lib, "dgt_ms": rows[True][1], "dgt_plain_ms": rows[True][2],
          "dgt_library_ms": rows[True][3]}
    log(f"{tag} P2 bound {bound_ms:.5f} ms ({bound_by})")
    return p1, p2


# ---------------------------------------------------------------------------
# The molecular dense engine: K2c and the flexible-water box
# ---------------------------------------------------------------------------

MOL_FORCE_GATE = 2e-4  # K2c vs plain, of the force scale (the reference's K2c tolerance)
MOL_E_GATE = 1e-3  # K2c vs plain, per-slot energies and virials
WATER_DRIFT_GATE = 1e-4  # relative NVE drift of the water path (the verify recipe's healthy bound)
WATER_EQ_STEPS = 2000
WATER_STEPS = 600
WATER_REBIN = 6
WATER_1M_GEOMETRY = (26, 88)  # (M, C) of the 985,527-atom box's plain config
WATER_1M_STEPS = 200
# K5c and P2 before their redesign: the last times of the pencil K5c and
# the one-thread-an-output P2 (PERF.md §6, chip_smoke.py's runs; NVIDIA H100
# 80GB HBM3, 700.00 W), printed on the log lines beside this run's times.
K5C_BEFORE = {"water_ms": 1.9579, "water_energy_ms": 1.8441, "n1m_water_ms": 15.1297}
P2_BEFORE = {"std": 0.1178, "dgt": 0.1423}
# K2c (one thread a centre slot, the full shell unculled) and K5s-mol (the
# pencil kernel on the ghost grids) before their redesign: their last
# chip_smoke.py times (PERF.md §6; NVIDIA H100 80GB HBM3, 700.00 W), printed
# on the log lines beside this run's times.
K2C_BEFORE = {"water_ms": 1.4731, "water_energy_ms": 1.2764, "n1m_water_ms": 11.6446}
K5S_MOL_BEFORE = {"ms": 9.4924}
# K2c-G before it moved onto K2c's kernel (a block a cell, a thread a centre
# slot, every slot of the 27 ghost neighbours tested): its last chip_smoke.py
# times on the (2,2,2) water grid and on the 985,527-atom grid's ghost grids
# (PERF.md §6; NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's.
K2CG_BEFORE = {"ms": 1.2185, "energy_ms": 1.2803, "n111_ms": 1.2271, "n1m_ms": 9.7770}
# float32 operations of one molecular pair inside the cutoff, each pair once
# with Newton's third law.  The force launch: OPS_PER_PAIR, the per-atom
# mixing 3, DSF Coulomb's force part 47 (√r, 1/r, αr 3, erfc ≈ 20, exp and
# its argument ≈ 11, the Gaussian and g(r) 6, qq 3, the force term 4) and 3
# per exclusion tag (compare, mask, subtract); each bonded pair inside the
# cutoff adds the bond force 4.  The energy launch (no bond tags):
# OPS_PER_PAIR_ENERGY (mixing included), the same DSF force part, its energy
# term 6, and the tags.
OPS_MIX, OPS_DSF_FORCE, OPS_DSF_ENERGY, OPS_BOND_FORCE = 3, 47, 6, 4


def mol_ops(pairs: int, bonded_pairs: int, e_tags: int, energy: bool) -> int:
    """Operations of one K2c launch: `pairs` inside the cutoff, of which
    `bonded_pairs` carry a bond term (forces launch only)."""
    if energy:
        return (OPS_PER_PAIR_ENERGY + OPS_DSF_FORCE + OPS_DSF_ENERGY + 3 * e_tags) * pairs
    return (OPS_PER_PAIR + OPS_MIX + OPS_DSF_FORCE + 3 * e_tags) * pairs + OPS_BOND_FORCE * bonded_pairs


def mol_bytes(config, e_tags: int, e_bonds: int, energy: bool) -> int:
    """Bytes a K2c launch must move: positions 12, σ/2 and 2√ε 8, valid 1,
    charge 4, atom id 4, the tags 12E and bond weights 8E_b (12E_b with
    energies) per slot in; forces 12 (and energy and virial 8) out."""
    per_slot = 12 + 8 + 1 + 4 + 4 + 12 * e_tags + (12 if energy else 8) * e_bonds + 12 + (8 if energy else 0)
    return per_slot * config.num_slots


def check_mol_kernel(st, config, model, coulomb, tags, label, kernel="K2c"):
    """K2c (or, with kernel="K5c", the streaming kernel's molecular
    branches) vs its plain version on one state, with DSF and the exclusion
    tags, without and with the bond tags, forces alone and with energies:
    forces within MOL_FORCE_GATE of the force scale, energies and virials
    within MOL_E_GATE, exact zeros on empty slots.  Returns (max |dF|,
    force scale, max |dE|, max |dW|)."""
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces
    from emdee_tpu_torch.neighbors.streaming_kernel import cell_forces_streaming

    fn = cell_forces_streaming if kernel == "K5c" else cell_forces
    v = st.valid
    err = scale = err_e = err_w = 0.0
    for excl in (tags[:3], tags):
        for energy in (False, True):
            kw = dict(compute_energy=energy, coulomb=coulomb, excl=excl)
            fk, ek, wk = fn(st, model, config, backend="cuda", **kw)
            fp, ep, wp = cell_forces(st, model, config, backend="torch", **kw)
            torch.cuda.synchronize()
            sc = max(float(fp[v].abs().max()), 1.0)
            scale = max(scale, sc)
            what = f"{label} {kernel} {'with' if len(excl) > 3 else 'without'} bond tags{' + energies' if energy else ''}"
            err = max(err, close(f"{what}: forces", fk[v], fp[v], atol=MOL_FORCE_GATE * sc))
            if bool((fk[~v] != 0).any()):
                raise AssertionError(f"{what}: nonzero forces on empty slots")
            if energy:
                err_e = max(err_e, close(f"{what}: energies", ek[v], ep[v], atol=MOL_E_GATE))
                err_w = max(err_w, close(f"{what}: virials", wk[v], wp[v], atol=MOL_E_GATE))
                if bool((ek[~v] != 0).any()) or bool((wk[~v] != 0).any()):
                    raise AssertionError(f"{what}: nonzero energies on empty slots")
    return err, scale, err_e, err_w


def water_tags(box, n, device, st):
    """The water box's slot tags as the 'cuda' path builds them (the O–H
    bonds on the tags): (tags, E, E_b)."""
    from emdee_tpu_torch import build_exclusion_tables, make_exclusion_aux_fn

    tabs, _, bond_tabs, _ = build_exclusion_tables(
        n, box["exclusion_pairs"], box["exclusion_scales"], None,
        bonds=(box["bonds"], box["bond_k"], box["bond_r0"]))
    return make_exclusion_aux_fn(n, *tabs, bond_tabs=bond_tabs)(st), tabs[0].shape[-1], bond_tabs[0].shape[-1]


def water_blocks_to_flag(roll, st, blocks):
    """Run up to `blocks` rebin blocks; return (blocks run, the state before
    the last block, the last state)."""
    prev, done = st, 0
    while done < blocks and not bool(st.overflow):
        prev, st, done = st, roll(st, num_steps=WATER_REBIN, rebin_every=WATER_REBIN), done + 1
    return done, prev, st


def phase_water(device, tag):
    """The 98,304-atom flexible-water box (`tools/water.py`) on the molecular
    dense engine: its spill config must resolve to the resident kernel
    family under 'auto'; equilibrate with CSVR at 300 K on the plain config
    that holds the lattice start ('cuda' named, so that this window holds
    K2c: 'auto' picks the streaming family there, which `phase_water_auto`
    gates; the thermostat forwarded through
    `make_molecular_dense_sim`), re-initialise on the spill config and, if
    that holds, run the
    gated NVE window there; else log the flag's cause and run it on the
    plain config with 'cuda'.  Gates: flag false, exact launch counts,
    drift ≤ 1e-4, bitwise reruns, no host waits; K2c vs plain on the
    window's state; 'cuda' (bonds in K2c) vs 'torch' (the gather path) after
    20 steps.  Returns (K2c row fields, {path: counts}, ms/step, facts, the
    box, config, models and equilibrated state for the later water phases)."""
    from emdee_tpu_torch import cell_dense_init, gather_dense_atoms, resolve_dense_backend
    from emdee_tpu_torch.neighbors.cell_kernel import k2c_resources
    from emdee_tpu_torch.tools import water

    box, spill_cfg, model, coul, params = water.water_setup(device, spill=True)
    _, plain_cfg, _, _, _ = water.water_setup(device, spill=False)
    n = len(box["masses"])
    rb = lambda cfg: resolve_dense_backend(cfg, "auto", device=device, with_coulomb=True, with_excl=True)  # noqa: E731
    if (spill_cfg.cells_per_dim, spill_cfg.capacity) != (12, 64) or rb(spill_cfg) != "cuda":
        raise AssertionError(f"water spill config M={spill_cfg.cells_per_dim} C={spill_cfg.capacity} resolves to "
                             f"{rb(spill_cfg)!r}")
    init = lambda pos, vel, cfg: cell_dense_init(pos, vel, box["masses"], params, cfg,  # noqa: E731
                                                 charges=box["charges"], device=device)
    st = init(box["positions"], box["velocities"], plain_cfg)
    if bool(st.overflow):
        raise AssertionError("water: init overflow on the plain config")
    log(f"water box: {n} atoms ({n // 3} flexible TIP3P waters), L = {box['box']:.2f} Å; spill config "
        f"M={spill_cfg.cells_per_dim} C={spill_cfg.capacity} "
        f"-> 'auto' resolves to {rb(spill_cfg)!r}; the lattice start needs C={plain_cfg.capacity} "
        f"(M={plain_cfg.cells_per_dim}), where 'auto' picks {rb(plain_cfg)!r} (K5c, gated after this window): "
        "equilibrating, and this window, on 'cuda' (K2c)")
    roll_eq, energy_eq = water.molecular_sim(box, plain_cfg, model, coul, params, "cuda", device)
    roll_nvt, _ = water.molecular_sim(box, plain_cfg, model, coul, params, "cuda", device, water.csvr())
    t0 = time.perf_counter()
    eq = roll_nvt(st, num_steps=WATER_EQ_STEPS, rebin_every=WATER_REBIN,
                  rng=torch.Generator(device=device).manual_seed(water.SEED))
    if bool(eq.overflow):
        raise AssertionError("water: equilibration overflow")
    pos_eq, vel_eq = gather_dense_atoms(eq, n)
    ke = float(energy_eq(eq)[2])
    t_eq = 2.0 * ke / ((3 * n - 3) * water.KB)
    log(f"water: equilibrated {WATER_EQ_STEPS} steps (dt {water.DT}, {WATER_EQ_STEPS * water.DT * 100:.1f} fs; CSVR "
        f"{water.TEMPERATURE:.0f} K, tau {water.TAU * 100:.0f} fs) in {time.perf_counter() - t0:.2f} s on "
        f"M={plain_cfg.cells_per_dim} C={plain_cfg.capacity}: T = {t_eq:.1f} K")

    roll_s, energy_s = water.molecular_sim(box, spill_cfg, model, coul, params, "auto", device)
    st_s = init(pos_eq, vel_eq, spill_cfg)
    facts = {"spill_holds": False}
    if bool(st_s.overflow):
        occ = water.occupancy(pos_eq, spill_cfg)
        eps = spill_cfg.cell_side - spill_cfg.cutoff - spill_cfg.skin
        cause = (f"the spill init overflows: true-cell occupancy mean {occ.mean():.2f}, sd {occ.std():.2f}, max "
                 f"{occ.max()}, {int((occ > spill_cfg.capacity).sum())} cells above C; only atoms within the spill "
                 f"margin {eps:.3f} Å of a +face may move")
    else:
        blocks, prev, end = water_blocks_to_flag(roll_s, st_s, WATER_STEPS // WATER_REBIN)
        facts["spill_holds"] = not bool(end.overflow)
        cause = (f"sticky flag after {blocks} rebin blocks; its last rebin: {flag_cause(prev, spill_cfg)}"
                 if bool(end.overflow) else f"no flag in {blocks} rebin blocks")
    log(f"{tag} water spill config (M={spill_cfg.cells_per_dim} C={spill_cfg.capacity}): {cause}")
    if facts["spill_holds"]:
        cfg, roll, energy, st0, backend = spill_cfg, roll_s, energy_s, st_s, "auto"
        kernel_counts = {"compact_window": -(-WATER_STEPS // WATER_REBIN)}
    else:
        cfg, roll, energy, backend = plain_cfg, roll_eq, energy_eq, "cuda"
        st0 = init(pos_eq, vel_eq, plain_cfg)
        kernel_counts = {"rebin_routing": -(-WATER_STEPS // WATER_REBIN)}
        log(f"water: the gated path runs on the plain config M={cfg.cells_per_dim} C={cfg.capacity} with "
            f"backend='cuda' named, so that it holds K2c; 'auto' picks {rb(cfg)!r} (K5c) there")
    roll(st0, num_steps=2 * WATER_REBIN, rebin_every=WATER_REBIN)  # warm-up
    out, sec, drift, counts = gate_rollout(
        "water path", roll, energy, st0, WATER_STEPS, WATER_REBIN,
        launches(cell_forces=WATER_STEPS + 4, **kernel_counts), drift_gate=WATER_DRIFT_GATE,
    )
    bitwise_rerun("water path", roll, st0, 100, WATER_REBIN)
    no_host_waits("water path", lambda: roll(st0, num_steps=2 * WATER_REBIN, rebin_every=WATER_REBIN))
    ms = 1e3 * sec / WATER_STEPS
    log(f"{tag} water path ({'spill' if facts['spill_holds'] else 'plain'} config M={cfg.cells_per_dim} "
        f"C={cfg.capacity}, backend {backend!r}, DSF + tags + bonds in K2c, angles by scatter-set): "
        f"{WATER_STEPS} steps in {sec:.3f} s = {ms:.4f} ms/step, {n * WATER_STEPS / sec:,.0f} atom-steps/s; "
        f"NVE drift {drift:.3e} (gate {WATER_DRIFT_GATE}); launches {counts}; two 100-step rollouts bitwise "
        "equal; no host waits")

    # K2c vs plain on the window's end state, and its times there.
    tags, e_tags, e_bonds = water_tags(box, n, device, out)
    err, scale, err_e, err_w = check_mol_kernel(out, cfg, model, coul, tags, f"water {n}")
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces

    step_kw = dict(coulomb=coul, excl=tags)
    e_kw = dict(coulomb=coul, excl=tags[:3], compute_energy=True)
    k_ms = cuda_ms(lambda: cell_forces(out, model, cfg, backend="cuda", **step_kw), 20)
    k_e_ms = cuda_ms(lambda: cell_forces(out, model, cfg, backend="cuda", **e_kw), 10)
    p_ms = cuda_ms(lambda: cell_forces(out, model, cfg, backend="torch", **step_kw), 2)
    p_e_ms = cuda_ms(lambda: cell_forces(out, model, cfg, backend="torch", **e_kw), 2)
    px, py, pz = (out.positions[..., i].contiguous() for i in range(3))
    pairs = grid_pairs(px, py, pz, out.valid, cfg)
    pos_end, _ = gather_dense_atoms(out, n)
    d = pos_end[box["bonds"][:, 1]] - pos_end[box["bonds"][:, 0]]
    d -= np.round(d / box["box"]) * box["box"]
    bonded_pairs = int(((d * d).sum(1) < cfg.cutoff**2).sum())
    b_ms, b_by = bound(mol_bytes(cfg, e_tags, e_bonds, False), mol_ops(pairs, bonded_pairs, e_tags, False))
    b_e = bound(mol_bytes(cfg, e_tags, 0, True), mol_ops(pairs, 0, e_tags, True))
    res = {"step": k2c_resources(cfg, coul, tags, False), "energy": k2c_resources(cfg, coul, tags[:3], True)}
    log(f"{tag} K2c vs plain on the water path's end state (M={cfg.cells_per_dim} C={cfg.capacity}, E={e_tags} "
        f"E_b={e_bonds}): max |dF| {err:.3e} (rel {err / scale:.3e}, scale {scale:.1f}), max |dE| {err_e:.3e}, "
        f"max |dW| {err_w:.3e}; step launch (DSF + tags + bonds) {k_ms:.4f} ms (before the redesign "
        f"{K2C_BEFORE['water_ms']}), plain {p_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by}); energy launch (no bond "
        f"tags) {k_e_ms:.4f} ms (before {K2C_BEFORE['water_energy_ms']}), plain {p_e_ms:.3f} ms, bound "
        f"{b_e[0]:.5f} ms ({b_e[1]}); {pairs:,} pairs inside the cutoff ({bonded_pairs:,} bonded), "
        f"{cfg.num_cells * cfg.capacity * 27 * cfg.capacity:,} candidates a launch before the cull")
    log(f"{tag} K2c resources at M={cfg.cells_per_dim} C={cfg.capacity}: " + resources_line(res))

    # 'cuda' (bonds in K2c) vs 'torch' (the gather path) after 20 steps.
    roll_t, energy_t = water.molecular_sim(box, cfg, model, coul, params, "torch", device)
    a = roll(st0, num_steps=20, rebin_every=5)
    b = roll_t(st0, num_steps=20, rebin_every=5)
    (pa, va), (pb, vb) = gather_dense_atoms(a, n), gather_dense_atoms(b, n)
    dp, dv = float(np.abs(pa - pb).max()), float(np.abs(va - vb).max())
    if not (dp <= 2e-3 and dv <= 5e-2) or bool(a.overflow) or bool(b.overflow):
        raise AssertionError(f"water 'cuda' vs 'torch' after 20 steps: positions {dp:.3e}, velocities {dv:.3e}")
    pe_k, pe_t = float(energy(st0)[0]), float(energy_t(st0)[0])
    log(f"{tag} water 'cuda' (bonds in K2c) vs 'torch' (bonds on the gather path) after 20 steps on the card: "
        f"max |dx| {dp:.3e} Å (gate 2e-3), max |dv| {dv:.3e} Å/(0.1 ps) (gate 5e-2); PE {pe_k:.3f} vs {pe_t:.3f} "
        "kJ/mol")
    row = {"mol_water_max_abs_err": err, "mol_water_force_scale": scale, "mol_water_rel_err": err / scale,
           "mol_water_energy_err": max(err_e, err_w), "mol_ms": k_ms, "mol_plain_ms": p_ms,
           "mol_bound_ms": b_ms, "mol_bound_by": b_by, "mol_energy_ms": k_e_ms, "mol_energy_plain_ms": p_e_ms, "mol_energy_bound_ms": b_e[0],
           "mol_pairs": pairs, "mol_bonded_pairs": bonded_pairs, "mol_resources": res}
    facts.update(config=f"M={cfg.cells_per_dim} C={cfg.capacity}", drift=drift, t_eq=t_eq)
    w = dict(box=box, cfg=plain_cfg, model=model, coul=coul, params=params, pos_eq=pos_eq, vel_eq=vel_eq,
             energy=energy_eq, init=init)
    return row, {"water": counts}, ms, facts, w


MODEL_CHUNK, MODEL_CHUNKS = 500, 4  # the runner's chunks on the System-built water box


def atom_forces(st, config, model, coulomb, tags, bonded, n, kernel):
    """Total forces in atom order: the pair pass (`kernel`, on the card,
    with DSF and the exclusion tags `tags`) plus every bonded term of
    `bonded` at the state's positions.  Returns (forces, positions)."""
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces
    from emdee_tpu_torch.neighbors.streaming_kernel import cell_forces_streaming
    from emdee_tpu_torch.potentials.bonded import bonded_forces_analytic

    fn = cell_forces_streaming if kernel == "K5c" else cell_forces
    pair = fn(st, model, config, backend="cuda", coulomb=coulomb, excl=tags)[0]
    ids = st.atom_id[st.valid].long()
    f = pair.new_zeros((n, 3)).index_put_((ids,), pair[st.valid])
    pos = st.positions.new_zeros((n, 3)).index_put_((ids,), st.positions[st.valid])
    return f + bonded_forces_analytic(pos, config.box, bonded), pos


def system_tags(system, bonded, n, st):
    """The System's slot tags as its kernel paths build them (the harmonic
    bonds on the tags), by `water_tags` on the System's tables (their
    Coulomb scales equal the LJ scales here, as `water.check_system`
    holds): (tags, E, E_b)."""
    valid = bonded.bonds.valid.cpu().numpy()
    atoms, k, r0 = (getattr(bonded.bonds, f).cpu().numpy()[valid] for f in ("atoms", "k", "length"))
    pairs, ljs = system.exclusions()
    return water_tags({"exclusion_pairs": pairs, "exclusion_scales": ljs, "bonds": atoms, "bond_k": k,
                       "bond_r0": r0}, n, st.positions.device, st)


def phase_modelling(device, tag):
    """The molecular front door at full width: the 98,304-atom water box of
    `tools/water.py` written as a PDB and typed by the modelling layer
    (`ForceField` on `tip3p_flexible.xml`, `System`, the native library's
    parser and canonical forms, asserted loaded), its tables held against
    the hand-built box's; `dense_sim_from_system` on 'auto' with CSVR at
    300 K from Maxwell-Boltzmann velocities (a seeded generator, the
    System's masses), which must resolve to the streaming family (K5c): K5c
    vs plain on its start, the start's total forces vs the hand-built box's
    at the same positions and masses (both within MOL_FORCE_GATE of the
    force scale); 2,000 steps of the path's own rollout to equilibrate, then
    `run_dense_simulation` for 4 chunks of 500 steps (rebin every 6) with
    trajectory and checkpoint files (guards on; launches: K5c and K4 only,
    K4 once a rebin block; 4 XYZ frames of 98,304 atoms); the
    checkpoint loaded with its generator and resumed for one chunk equals
    the uninterrupted run bit for bit; then the same System at the run's
    end state on `backend="cuda"` (K2c): K2c vs plain and one gated NVE
    chunk.  Logs the host seconds of each modelling step and the ms/step.
    Returns ({path: counts}, the K5c and K2c check fields, ms/step)."""
    import dataclasses
    import os
    import tempfile

    from emdee_tpu_torch import (
        ForceField, LennardJonesModel, System, cell_dense_init, dense_sim_from_system, gather_dense_atoms,
        resolve_dense_backend,
    )
    from emdee_tpu_torch.modelling.bonded import build_bonded_system
    from emdee_tpu_torch.native import build as native_build, canon, chemio
    from emdee_tpu_torch.potentials.coulomb import KJMOL_ANGSTROM, DSFCoulomb
    from emdee_tpu_torch.tools import water
    from emdee_tpu_torch.utils.checkpoint import load_state
    from emdee_tpu_torch.utils.runner import RunnerConfig, run_dense_simulation

    t0 = time.perf_counter()
    if not (canon.available() and chemio.available()):
        raise AssertionError("modelling: the native library (canon, chemio) did not build or load")
    log(f"modelling: native library built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({native_build.library_path().name})")
    secs = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t
        return out

    with tempfile.TemporaryDirectory(prefix="emdee_modelling_") as tmp:
        box = water.water_box()
        pdb = os.path.join(tmp, "water.pdb")
        timed("write_pdb", lambda: water.write_box_pdb(pdb, box))
        ff = timed("ForceField", lambda: ForceField(str(water.FORCE_FIELD)))
        system = timed("System", lambda: System(pdb, ff))
        bonded = timed("build_bonded_system",
                       lambda: build_bonded_system(system, length_scale=water.LENGTH_SCALE, device=device))
        timed("check_system", lambda: water.check_system(system, bonded, box))
        n = len(system)
        log(f"modelling: {n} atoms, {system.count_residues()} residues, {len(system.bonds)} bonds from the PDB "
            f"alias table; host seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
            + "; the System's tables equal tools/water.py's (types, charges, masses per pdb_aliases.json, "
            "exclusions, bonds, angles)")

        rng = np.random.default_rng(water.SEED + 1)
        masses = system.masses
        vel = rng.normal(size=(n, 3)) * np.sqrt(water.KB * water.TEMPERATURE / masses)[:, None]
        vel -= (masses[:, None] * vel).sum(0) / masses.sum()
        kw = dict(cutoff=water.CUTOFF, switch=water.SWITCH, skin=water.SKIN, dt=water.DT,
                  coulomb_alpha=water.ALPHA, length_scale=water.LENGTH_SCALE, device=device)
        st, roll, energy, cfg = timed("dense_sim_auto", lambda: dense_sim_from_system(
            system, **kw, backend="auto", velocities=vel, thermostat=water.csvr()))
        hand_cfg = water.plain_config(box)
        geometry = (cfg.cells_per_dim, cfg.capacity)
        if geometry != (hand_cfg.cells_per_dim, hand_cfg.capacity):
            log(f"modelling: dense_sim_from_system chose M={geometry[0]} C={geometry[1]}, tools/water.py "
                f"M={hand_cfg.cells_per_dim} C={hand_cfg.capacity}; the path runs on the former")
        family = resolve_dense_backend(cfg, "auto", device=device, with_coulomb=True, with_excl=True)
        if family != "cuda_streaming" or bool(st.overflow):
            raise AssertionError(f"modelling: M={geometry[0]} C={geometry[1]} resolves to {family!r} "
                                 f"(overflow {bool(st.overflow)})")
        model = LennardJonesModel.create(water.CUTOFF, water.SWITCH, device=device)
        coul = DSFCoulomb.create(water.CUTOFF, water.ALPHA, KJMOL_ANGSTROM, device=device)
        tags, e_tags, e_bonds = system_tags(system, bonded, n, st)
        k5c_err, k5c_scale, k5c_e, k5c_w = check_mol_kernel(st, cfg, model, coul, tags, "System-built water", "K5c")
        hbox, hcfg, hmodel, hcoul, hparams = water.water_setup(device, spill=False)
        hst = cell_dense_init(system.positions, vel, masses, hparams, hcfg, charges=hbox["charges"], device=device)
        f_sys, _ = atom_forces(st, cfg, model, coul, tags[:3], bonded, n, "K5c")
        f_hand, _ = atom_forces(hst, hcfg, hmodel, hcoul, water_tags(hbox, n, device, hst)[0][:3],
                                water.bonded_system(hbox, device), n, "K5c")
        hand_scale = max(float(f_hand.abs().max()), 1.0)
        hand_err = close("modelling: System-built vs hand-built forces", f_sys, f_hand,
                         atol=MOL_FORCE_GATE * hand_scale)
        log(f"{tag} modelling: dense_sim_from_system('auto', CSVR) in {secs['dense_sim_auto']:.3f} s -> M={geometry[0]} "
            f"C={geometry[1]} (tools/water.py: M={hand_cfg.cells_per_dim} C={hand_cfg.capacity}), {family!r}, E={e_tags} "
            f"E_b={e_bonds}; K5c vs plain max |dF| {k5c_err:.3e} (rel {k5c_err / k5c_scale:.3e}, scale "
            f"{k5c_scale:.1f}), max |dE| {k5c_e:.3e}, max |dW| {k5c_w:.3e}; total forces vs the hand-built box at the "
            f"same positions and masses: max |dF| {hand_err:.3e} (rel {hand_err / hand_scale:.3e}, scale "
            f"{hand_scale:.1f}, gate {MOL_FORCE_GATE})")
        del hst, f_sys, f_hand

        # The lattice start holds much potential energy, which CSVR takes out
        # as the box melts: the total falls several-fold in the first chunks,
        # past the runner's energy-jump guard (50% a chunk).  So the same
        # thermostatted rollout first equilibrates it, as `phase_water` does.
        gen = torch.Generator(device=device).manual_seed(water.SEED)
        totals = []
        for _ in range(WATER_EQ_STEPS // MODEL_CHUNK):
            st = roll(st, num_steps=MODEL_CHUNK, rebin_every=WATER_REBIN, rng=gen)
            pe, _, ke = energy(st)
            totals.append(float(pe + ke))
        if bool(st.overflow):
            raise AssertionError("modelling: equilibration overflow")
        log(f"modelling: equilibrated {WATER_EQ_STEPS} steps with the path's own CSVR rollout; total energy by "
            f"chunk of {MODEL_CHUNK}: " + ", ".join(f"{e:.0f}" for e in totals) + " kJ/mol")
        traj, ckpt = os.path.join(tmp, "traj.xyz"), os.path.join(tmp, "ckpt.npz")
        zero_counts()
        t0 = time.perf_counter()
        final, history = run_dense_simulation(
            st, roll, energy, RunnerConfig(total_steps=MODEL_CHUNKS * MODEL_CHUNK, chunk_steps=MODEL_CHUNK,
                                           trajectory_path=traj, checkpoint_path=ckpt),
            n, names=system.names, rebin_every=WATER_REBIN, rng=gen)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        # K5c: two launches a force evaluation, each chunk's first forces, its
        # steps and its energy; K4: one a rebin block.
        expected = launches(cell_forces_streaming=2 * MODEL_CHUNKS * (MODEL_CHUNK + 2),
                            rebin_routing=MODEL_CHUNKS * -(-MODEL_CHUNK // WATER_REBIN))
        if counts != expected:
            raise AssertionError(f"modelling runner: kernel launches {counts}, expected {expected}")
        with open(traj) as fh:
            lines = fh.read().splitlines()
        if lines.count(str(n)) != MODEL_CHUNKS or len(lines) != MODEL_CHUNKS * (n + 2):
            raise AssertionError(f"modelling: {traj} holds {lines.count(str(n))} frame headers, {len(lines)} lines")
        frame = np.array([line.split()[1:4] for line in lines[-n:]], np.float64)
        if not np.isfinite(frame).all():
            raise AssertionError("modelling: the last XYZ frame is not finite")
        ke = history[-1]["kinetic"]
        meter_ms = 1e3 / history[-1]["steps_per_s"]
        log(f"{tag} modelling: run_dense_simulation {MODEL_CHUNKS} x {MODEL_CHUNK} steps (CSVR "
            f"{water.TEMPERATURE:.0f} K, rebin every {WATER_REBIN}) in {run_s:.3f} s, ThroughputMeter "
            f"{meter_ms:.4f} ms/step (dumps and checkpoints included); guards passed; T "
            f"{2.0 * ke / ((3 * n - 3) * water.KB):.1f} K, PE {history[-1]['potential']:.1f} kJ/mol; "
            f"{MODEL_CHUNKS} XYZ frames of {n} atoms; launches {counts}")

        t0 = time.perf_counter()
        cont, cont_hist = run_dense_simulation(
            final, roll, energy, RunnerConfig(total_steps=MODEL_CHUNK, chunk_steps=MODEL_CHUNK, log=True),
            n, rebin_every=WATER_REBIN, rng=gen)
        torch.cuda.synchronize()
        chunk_ms = 1e3 * (time.perf_counter() - t0) / MODEL_CHUNK
        gen2 = torch.Generator(device=device).manual_seed(water.SEED + 7)
        loaded, meta = load_state(ckpt, final, rng=gen2)
        if meta["step"] != int(final.step) or loaded.positions.device != final.positions.device:
            raise AssertionError(f"modelling: checkpoint meta {meta}, device {loaded.positions.device}")
        resumed, _ = run_dense_simulation(
            loaded, roll, energy, RunnerConfig(total_steps=MODEL_CHUNK, chunk_steps=MODEL_CHUNK, log=False),
            n, rebin_every=WATER_REBIN, rng=gen2)
        for (name, a), (_, b) in zip(tensors(cont), tensors(resumed)):
            if not torch.equal(a, b):
                raise AssertionError(f"modelling: the resumed run differs from the uninterrupted one in {name}")
        log(f"{tag} modelling: load_state of the step-{meta['step']} checkpoint (its generator restored) resumed "
            f"for {MODEL_CHUNK} steps equals the uninterrupted run bit for bit; that chunk {chunk_ms:.4f} ms/step "
            f"(ThroughputMeter {1e3 / cont_hist[-1]['steps_per_s']:.4f}) on the card")

    pos_end, vel_end = gather_dense_atoms(resumed, n)
    del st, final, cont, loaded, resumed
    moved = dataclasses.replace(system, positions=pos_end.astype(np.float64), velocities=vel_end.astype(np.float64))
    st_c, roll_c, energy_c, cfg_c = timed("dense_sim_cuda", lambda: dense_sim_from_system(
        moved, **kw, backend="cuda"))
    tags_c, _, _ = system_tags(system, bonded, n, st_c)
    k2c_err, k2c_scale, k2c_e, k2c_w = check_mol_kernel(st_c, cfg_c, model, coul, tags_c, "System-built water")
    _, sec, drift, counts_c = gate_rollout(
        "modelling 'cuda' path", roll_c, energy_c, st_c, MODEL_CHUNK, WATER_REBIN,
        launches(cell_forces=MODEL_CHUNK + 4, rebin_routing=-(-MODEL_CHUNK // WATER_REBIN)),
        drift_gate=WATER_DRIFT_GATE)
    cuda_ms = 1e3 * sec / MODEL_CHUNK
    log(f"{tag} modelling: the System at the run's end on backend 'cuda' (K2c; dense_sim_from_system in "
        f"{secs['dense_sim_cuda']:.3f} s, M={cfg_c.cells_per_dim} C={cfg_c.capacity}): K2c vs plain max |dF| "
        f"{k2c_err:.3e} (rel {k2c_err / k2c_scale:.3e}), max |dE| {k2c_e:.3e}, max |dW| {k2c_w:.3e}; {MODEL_CHUNK} "
        f"gated NVE steps {cuda_ms:.4f} ms/step, drift {drift:.3e} (gate {WATER_DRIFT_GATE}); launches {counts_c}")
    log(f"{card()}: modelling path at {n} atoms — 'auto' (K5c, CSVR) {meter_ms:.4f} ms/step by the ThroughputMeter "
        f"over the runner's chunks, {chunk_ms:.4f} a chunk without dumps; 'cuda' (K2c, NVE) {cuda_ms:.4f}")
    checks = {"k5c": {"modelling_max_abs_err": k5c_err, "modelling_force_scale": k5c_scale,
                      "modelling_energy_err": max(k5c_e, k5c_w), "modelling_vs_hand_built_max_abs_err": hand_err,
                      "modelling_ms_per_step": meter_ms, "modelling_chunk_ms_per_step": chunk_ms},
              "k2c": {"modelling_max_abs_err": k2c_err, "modelling_force_scale": k2c_scale,
                      "modelling_energy_err": max(k2c_e, k2c_w), "modelling_ms_per_step": cuda_ms},
              "host_seconds": secs}
    return {"modelling_auto": counts, "modelling_cuda": counts_c}, checks


def k5c_vs_k2c(st, config, model, coulomb, tags, label):
    """K5c vs K2c on one state: the step launch (bond tags) within
    MOL_FORCE_GATE of K2c's force scale, the energy launch (no bond tags)
    within MOL_E_GATE in per-slot energies and virials.  Returns (max |dF|,
    max |dE| or |dW|)."""
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces
    from emdee_tpu_torch.neighbors.streaming_kernel import cell_forces_streaming

    v = st.valid
    f5, _, _ = cell_forces_streaming(st, model, config, backend="cuda", coulomb=coulomb, excl=tags)
    f2, _, _ = cell_forces(st, model, config, backend="cuda", coulomb=coulomb, excl=tags)
    kw = dict(coulomb=coulomb, excl=tags[:3], compute_energy=True)
    _, e5, w5 = cell_forces_streaming(st, model, config, backend="cuda", **kw)
    _, e2, w2 = cell_forces(st, model, config, backend="cuda", **kw)
    torch.cuda.synchronize()
    scale = max(float(f2[v].abs().max()), 1.0)
    err = close(f"{label} K5c vs K2c forces", f5[v], f2[v], atol=MOL_FORCE_GATE * scale)
    err_e = max(close(f"{label} K5c vs K2c energies", e5[v], e2[v], atol=MOL_E_GATE),
                close(f"{label} K5c vs K2c virials", w5[v], w2[v], atol=MOL_E_GATE))
    return err, err_e


def resources_line(res) -> str:
    """A kernel's variants' resources (`cell_kernel.resources`) on one line."""
    return "; ".join(f"{name}: {r['registers']} registers and {r['local_bytes']} local bytes a thread, "
                     f"{r['smem_bytes']:,} shared bytes a block of {r['warps_per_block']} warps, "
                     f"{r['blocks_per_sm']} blocks an SM"
                     for name, r in res.items())


def phase_k5c_fixture(device, tag):
    """K5c vs its plain version on the 864-atom charged fixture, with and
    without bond tags and energies, and vs K2c.  Returns the K5c row's
    fixture fields."""
    from emdee_tpu_torch.tools import fixtures

    st, config, model, coul, tags = fixtures.charged_fixture(device)
    err, scale, err_e, err_w = check_mol_kernel(st, config, model, coul, tags, "864 fixture", "K5c")
    vs_f, vs_e = k5c_vs_k2c(st, config, model, coul, tags, "864 fixture")
    log(f"{tag} K5c vs plain, 864-atom charged fixture (drifted, M={config.cells_per_dim} C={config.capacity}): "
        f"max |dF| {err:.3e} (rel {err / scale:.3e}, scale {scale:.1f}), max |dE| {err_e:.3e}, max |dW| {err_w:.3e}; "
        f"vs K2c max |dF| {vs_f:.3e}, max |dE|, |dW| {vs_e:.3e}; empty slots exactly 0")
    return {"fixture_max_abs_err": err, "fixture_force_scale": scale, "fixture_rel_err": err / scale,
            "fixture_energy_err": max(err_e, err_w), "fixture_vs_k2c_max_abs_err": vs_f}


def mol_pairs(state, config, bonds, box_edge):
    """(unique pairs inside the cutoff, bonded pairs inside it) of a water
    state, for the bounds."""
    from emdee_tpu_torch import gather_dense_atoms

    px, py, pz = (state.positions[..., i].contiguous() for i in range(3))
    pairs = grid_pairs(px, py, pz, state.valid, config)
    pos, _ = gather_dense_atoms(state, config.num_atoms)
    d = pos[bonds[:, 1]] - pos[bonds[:, 0]]
    d -= np.round(d / box_edge) * box_edge
    return pairs, int(((d * d).sum(1) < config.cutoff**2).sum())


def phase_water_auto(device, tag, w):
    """The 98,304-atom water box on `backend="auto"`, which resolves to the
    streaming family (K5c) at its plain config: the gated 600-step NVE
    window from the equilibrated state (drift ≤ 1e-4, no flag, two K5c
    launches a force evaluation and three K4 a rebin, bitwise reruns, no
    host waits); 20 steps against 'cuda' (K2c) and 'torch' within 2e-3 Å
    and 5e-2 Å/(0.1 ps); K5c vs plain and vs K2c on the window's end state,
    and their times.  Returns (K5c row fields, counts, ms/step, drift)."""
    from emdee_tpu_torch import gather_dense_atoms, resolve_dense_backend
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces
    from emdee_tpu_torch.neighbors.streaming_kernel import cell_forces_streaming, k5c_resources
    from emdee_tpu_torch.tools import water

    box, cfg, model, coul, params = w["box"], w["cfg"], w["model"], w["coul"], w["params"]
    n = len(box["masses"])
    family = resolve_dense_backend(cfg, "auto", device=device, with_coulomb=True, with_excl=True)
    if family != "cuda_streaming":
        raise AssertionError(f"water plain config M={cfg.cells_per_dim} C={cfg.capacity}: 'auto' -> {family!r}")
    st0 = w["init"](w["pos_eq"], w["vel_eq"], cfg)
    roll, energy = water.molecular_sim(box, cfg, model, coul, params, "auto", device)
    roll(st0, num_steps=2 * WATER_REBIN, rebin_every=WATER_REBIN)  # warm-up
    out, sec, drift, counts = gate_rollout(
        "water path ('auto', K5c)", roll, energy, st0, WATER_STEPS, WATER_REBIN,
        launches(cell_forces_streaming=2 * (WATER_STEPS + 4), rebin_routing=-(-WATER_STEPS // WATER_REBIN)),
        drift_gate=WATER_DRIFT_GATE,
    )
    bitwise_rerun("water path ('auto')", roll, st0, 100, WATER_REBIN)
    no_host_waits("water path ('auto')", lambda: roll(st0, num_steps=2 * WATER_REBIN, rebin_every=WATER_REBIN))
    ms = 1e3 * sec / WATER_STEPS
    log(f"{tag} water path (plain config M={cfg.cells_per_dim} C={cfg.capacity}, backend 'auto' -> {family!r}: "
        f"DSF + tags + bonds in K5c, angles by scatter-set): {WATER_STEPS} steps in {sec:.3f} s = {ms:.4f} ms/step, "
        f"{n * WATER_STEPS / sec:,.0f} atom-steps/s; NVE drift {drift:.3e} (gate {WATER_DRIFT_GATE}); launches "
        f"{counts}; two 100-step rollouts bitwise equal; no host waits")

    a = roll(st0, num_steps=20, rebin_every=5)
    pa, va = gather_dense_atoms(a, n)
    gaps = {}
    for other in ("cuda", "torch"):
        b = water.molecular_sim(box, cfg, model, coul, params, other, device)[0](st0, num_steps=20, rebin_every=5)
        pb, vb = gather_dense_atoms(b, n)
        gaps[other] = (float(np.abs(pa - pb).max()), float(np.abs(va - vb).max()))
        if not (gaps[other][0] <= 2e-3 and gaps[other][1] <= 5e-2) or bool(a.overflow) or bool(b.overflow):
            raise AssertionError(f"water 'auto' vs {other!r} after 20 steps: {gaps[other]}")
    log(f"{tag} water 'auto' (K5c) after 20 steps vs 'cuda' (K2c): max |dx| {gaps['cuda'][0]:.3e} Å, max |dv| "
        f"{gaps['cuda'][1]:.3e}; vs 'torch': max |dx| {gaps['torch'][0]:.3e} Å, max |dv| {gaps['torch'][1]:.3e} "
        "(gates 2e-3, 5e-2)")

    tags, e_tags, e_bonds = water_tags(box, n, device, out)
    err, scale, err_e, err_w = check_mol_kernel(out, cfg, model, coul, tags, f"water {n}", "K5c")
    vs_f, vs_e = k5c_vs_k2c(out, cfg, model, coul, tags, f"water {n}")
    step_kw = dict(coulomb=coul, excl=tags)
    e_kw = dict(coulomb=coul, excl=tags[:3], compute_energy=True)
    k_ms = cuda_ms(lambda: cell_forces_streaming(out, model, cfg, backend="cuda", **step_kw), 20)
    k_e_ms = cuda_ms(lambda: cell_forces_streaming(out, model, cfg, backend="cuda", **e_kw), 10)
    k2_ms = cuda_ms(lambda: cell_forces(out, model, cfg, backend="cuda", **step_kw), 20)
    k2_e_ms = cuda_ms(lambda: cell_forces(out, model, cfg, backend="cuda", **e_kw), 10)
    p_ms = cuda_ms(lambda: cell_forces(out, model, cfg, backend="torch", **step_kw), 2)
    p_e_ms = cuda_ms(lambda: cell_forces(out, model, cfg, backend="torch", **e_kw), 2)
    pairs, bonded_pairs = mol_pairs(out, cfg, box["bonds"], box["box"])
    b_ms, b_by = bound(mol_bytes(cfg, e_tags, e_bonds, False), mol_ops(pairs, bonded_pairs, e_tags, False))
    b_e = bound(mol_bytes(cfg, e_tags, 0, True), mol_ops(pairs, 0, e_tags, True))
    log(f"{tag} K5c vs plain on the 'auto' window's end state (M={cfg.cells_per_dim} C={cfg.capacity}, E={e_tags} "
        f"E_b={e_bonds}): max |dF| {err:.3e} (rel {err / scale:.3e}, scale {scale:.1f}), max |dE| {err_e:.3e}, "
        f"max |dW| {err_w:.3e}; vs K2c max |dF| {vs_f:.3e}, |dE|, |dW| {vs_e:.3e}")
    res = {"step": k5c_resources(cfg, coul, tags, False), "energy": k5c_resources(cfg, coul, tags[:3], True)}
    log(f"{tag} K5c times at {n} atoms: step launch pair (DSF + tags + bonds) {k_ms:.4f} ms (before the redesign "
        f"{K5C_BEFORE['water_ms']}) vs K2c {k2_ms:.4f} ms (K2c before its redesign {K2C_BEFORE['water_ms']}), plain "
        f"{p_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by}); energy launch pair {k_e_ms:.4f} ms (before "
        f"{K5C_BEFORE['water_energy_ms']}) vs K2c {k2_e_ms:.4f} ms (before {K2C_BEFORE['water_energy_ms']}), plain "
        f"{p_e_ms:.3f} ms, bound {b_e[0]:.5f} ms ({b_e[1]}); {pairs:,} unique pairs inside the cutoff "
        f"({bonded_pairs:,} bonded)")
    log(f"{tag} K5c resources at M={cfg.cells_per_dim} C={cfg.capacity}: " + resources_line(res))
    row = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "resources": res,
           "water_force_scale": scale, "water_rel_err": err / scale, "water_energy_err": max(err_e, err_w),
           "water_vs_k2c_max_abs_err": vs_f, "water_vs_k2c_energy_err": vs_e, "k2c_ms": k2_ms,
           "energy_ms": k_e_ms, "energy_plain_ms": p_e_ms, "energy_bound_ms": b_e[0], "k2c_energy_ms": k2_e_ms,
           "pairs": pairs, "bonded_pairs": bonded_pairs, "water_auto_ms_per_step": ms, "water_auto_drift": drift}
    return row, {"water_auto": counts}, ms, drift


def phase_water_c104(device, tag, w):
    """F1 on the 98,304-atom water box at C = 104 (its plain geometry, M =
    12): 'auto' must resolve to the streaming family, whose chunked
    molecular variant (K5c) runs above 96; K5c vs its plain version on the
    equilibrated state re-initialised there, with DSF and the tags, without
    and with the bond tags, forces alone and with energies (within 2e-4 of
    the force scale and 1e-3), and its step launch's time.  Returns K5c
    row fields."""
    from emdee_tpu_torch import resolve_dense_backend
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces
    from emdee_tpu_torch.neighbors.streaming_kernel import cell_forces_streaming, k5c_resources

    box, model, coul = w["box"], w["model"], w["coul"]
    cfg = w["cfg"]._replace(capacity=C_F1)
    n = len(box["masses"])
    family = resolve_dense_backend(cfg, "auto", device=device, with_coulomb=True, with_excl=True)
    if family != "cuda_streaming":
        raise AssertionError(f"water M={cfg.cells_per_dim} C={C_F1}: 'auto' -> {family!r}")
    st = w["init"](w["pos_eq"], w["vel_eq"], cfg)
    if bool(st.overflow):
        raise AssertionError(f"water C={C_F1}: init overflow")
    tags, e_tags, e_bonds = water_tags(box, n, device, st)
    err, scale, err_e, err_w = check_mol_kernel(st, cfg, model, coul, tags, f"water C={C_F1}", "K5c")
    k_ms = cuda_ms(lambda: cell_forces_streaming(st, model, cfg, backend="cuda", coulomb=coul, excl=tags), 20)
    p_ms = cuda_ms(lambda: cell_forces(st, model, cfg, backend="torch", coulomb=coul, excl=tags), 2)
    pairs, bonded_pairs = mol_pairs(st, cfg, box["bonds"], box["box"])
    b_ms, b_by = bound(mol_bytes(cfg, e_tags, e_bonds, False), mol_ops(pairs, bonded_pairs, e_tags, False))
    res = k5c_resources(cfg, coul, tags, False)
    log(f"{tag} F1: water M={cfg.cells_per_dim} C={C_F1} 'auto' -> {family!r}; K5c (chunked variant) vs plain max "
        f"|dF| {err:.3e} (rel {err / scale:.3e}), max |dE| {err_e:.3e}, max |dW| {err_w:.3e}; step launch pair "
        f"{k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by}); resources {resources_line({'step': res})}")
    return {"water_c104_max_abs_err": err, "water_c104_energy_err": max(err_e, err_w), "water_c104_ms": k_ms,
            "water_c104_plain_ms": p_ms, "water_c104_bound_ms": b_ms, "water_c104_resources": res}


@contextlib.contextmanager
def plain_one_offset_tiles():
    """The plain version (`cell_dense._dense_forces`) with its half-shell
    tiles one offset wide, (M³, C, C), in place of four: the same pair sums
    grouped otherwise, in about a quarter of the memory.  At the 985,527-atom
    box (M = 26, C = 88) the four-wide tiles' molecular terms outgrow the
    card; `phase_water_1m` prints the one-wide peak."""
    from emdee_tpu_torch.neighbors import cell_dense

    group, cell_dense._GROUP = cell_dense._GROUP, 1
    try:
        yield
    finally:
        cell_dense._GROUP = group


def phase_water_1m(device, tag):
    """The 985,527-atom water box (69³ waters, plain config M = 26, C = 88)
    on `backend="auto"` (asserted to resolve to the streaming family): K5c
    held to its plain version (`plain_one_offset_tiles`) and to K2c within
    MOL_FORCE_GATE of the force scale on the path's operands (DSF, the tags
    and the bonds on them); one K5c and one K2c launch timed; a gated NVE
    window of 200 steps from the lattice start (no flag, drift ≤ 1e-4,
    exact launches).  Returns (row fields, counts, ms/step, the box's set-up
    for the grid's 1M water phase)."""
    from emdee_tpu_torch import cell_dense_init, resolve_dense_backend
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces
    from emdee_tpu_torch.neighbors.streaming_kernel import cell_forces_streaming, k5c_resources
    from emdee_tpu_torch.tools import water

    t0 = time.perf_counter()
    box, cfg, model, coul, params = water.water_setup(device, n_side=water.N_SIDE_1M, spill=False)
    n = len(box["masses"])
    family = resolve_dense_backend(cfg, "auto", device=device, with_coulomb=True, with_excl=True)
    if (cfg.cells_per_dim, cfg.capacity) != WATER_1M_GEOMETRY or family != "cuda_streaming":
        raise AssertionError(f"1M water config M={cfg.cells_per_dim} C={cfg.capacity} resolves to {family!r}")
    st = cell_dense_init(box["positions"], box["velocities"], box["masses"], params, cfg, charges=box["charges"],
                         device=device)
    if bool(st.overflow):
        raise AssertionError("1M water: init overflow")
    tags, e_tags, e_bonds = water_tags(box, n, device, st)
    roll, energy = water.molecular_sim(box, cfg, model, coul, params, "auto", device)
    setup = time.perf_counter() - t0
    v = st.valid
    f5 = cell_forces_streaming(st, model, cfg, backend="cuda", coulomb=coul, excl=tags)[0]
    f2 = cell_forces(st, model, cfg, backend="cuda", coulomb=coul, excl=tags)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    with plain_one_offset_tiles():
        fp = cell_forces_streaming(st, model, cfg, backend="torch", coulomb=coul, excl=tags)[0]
    torch.cuda.synchronize()
    plain_gb = torch.cuda.max_memory_allocated(device) / 1e9
    scale = max(float(fp[v].abs().max()), 1.0)
    err_p = close("1M water K5c vs plain forces", f5[v], fp[v], atol=MOL_FORCE_GATE * scale)
    err = close("1M water K5c vs K2c forces", f5[v], f2[v], atol=MOL_FORCE_GATE * scale)
    del f5, f2, fp
    k_ms = cuda_ms(lambda: cell_forces_streaming(st, model, cfg, backend="cuda", coulomb=coul, excl=tags), 5)
    k2_ms = cuda_ms(lambda: cell_forces(st, model, cfg, backend="cuda", coulomb=coul, excl=tags), 5)
    res = {"step": k5c_resources(cfg, coul, tags, False)}
    pairs, bonded_pairs = mol_pairs(st, cfg, box["bonds"], box["box"])
    b_ms, b_by = bound(mol_bytes(cfg, e_tags, e_bonds, False), mol_ops(pairs, bonded_pairs, e_tags, False))
    steps = WATER_1M_STEPS
    roll(st, num_steps=WATER_REBIN, rebin_every=WATER_REBIN)  # warm-up
    _, sec, drift, counts = gate_rollout(
        "1M water path ('auto', K5c)", roll, energy, st, steps, WATER_REBIN,
        launches(cell_forces_streaming=2 * (steps + 4), rebin_routing=-(-steps // WATER_REBIN)),
        drift_gate=WATER_DRIFT_GATE,
    )
    ms = 1e3 * sec / steps
    log(f"{tag} 1M water box: {n:,} atoms ({n // 3:,} waters), L = {box['box']:.2f} Å, M={cfg.cells_per_dim} "
        f"C={cfg.capacity}, 'auto' -> {family!r} (set-up {setup:.1f} s); K5c vs plain max |dF| {err_p:.3e} (rel "
        f"{err_p / scale:.3e}, scale {scale:.1f}; the card's peak allocation while the plain ran {plain_gb:.1f} GB), vs K2c "
        f"{err:.3e} (rel {err / scale:.3e}); step launch K5c {k_ms:.4f} ms (2 launches; before the redesign "
        f"{K5C_BEFORE['n1m_water_ms']}) vs K2c {k2_ms:.4f} ms (before its redesign {K2C_BEFORE['n1m_water_ms']}), "
        f"K5c {resources_line(res)}, bound {b_ms:.5f} ms "
        f"({b_by}; {pairs:,} pairs inside the cutoff); {steps} NVE steps from the lattice start in {sec:.3f} s = {ms:.4f} ms/step, "
        f"{n * steps / sec:,.0f} atom-steps/s, drift {drift:.3e} (gate {WATER_DRIFT_GATE}), no flag; launches {counts}")
    row = {"n1m_water_ms": k_ms, "n1m_water_resources": res, "n1m_water_k2c_ms": k2_ms, "n1m_water_bound_ms": b_ms,
           "n1m_water_max_abs_err": err_p, "n1m_water_rel_err": err_p / scale, "n1m_water_vs_k2c_max_abs_err": err, "n1m_water_force_scale": scale, "n1m_water_ms_per_step": ms,
           "n1m_water_drift": drift, "n1m_water_pairs": pairs}
    return row, {"water_1m": counts}, ms, dict(box=box, cfg=cfg, model=model, coul=coul, st=st)


def nccl_vs_local_mesh(label, config, model, dt, st, kwargs, steps, rebin_every, device):
    """A (1,1,1) grid run through a one-rank NCCL `DistMesh` (in-process,
    `file://` rendezvous) bitwise equal, state and energies, to the same
    run on a `LocalMesh`."""
    import tempfile

    import torch.distributed as dist

    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid, gather_grid_state, make_grid_sharded_sim
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors.cell_dense import state_to_numpy

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0)
        try:
            runs = []
            for mesh in (make_grid_mesh((1, 1, 1), group=dist.group.WORLD, device=device),
                         make_grid_mesh((1, 1, 1), device=device)):
                roll, energy = make_grid_sharded_sim(config, model, dt, mesh, **kwargs)
                out = roll(distribute_grid(st, config, mesh), num_steps=steps, rebin_every=rebin_every)
                runs.append([*state_to_numpy(gather_grid_state(out, config, mesh)).values(),
                             *(np.float32(float(e)) for e in energy(out))])
        finally:
            dist.destroy_process_group()
    if not all(np.array_equal(np.atleast_1d(a).view(np.uint8), np.atleast_1d(b).view(np.uint8))
               for a, b in zip(*runs)):
        raise AssertionError(f"{label}: the NCCL DistMesh run differs from the LocalMesh run")


def ghost_stack(sh, mesh, per_atom=True, mol=True):
    """The ghost grids of a grid-sharded state, as the grid engine builds
    them: x, y, z (NaN in empty slots), with `per_atom` σ/2 and 2√ε, with
    `mol` q and the atom ids (−2 on empty slots) as a float32 bit view."""
    from emdee_tpu_torch.distributed.grid_sharded import _ghost3

    parts = [torch.where(sh.valid, sh.positions.movedim(-1, 0), float("nan"))]
    if per_atom:
        parts += [sh.half_sigma[None], sh.twice_sqrt_eps[None]]
    if mol:
        parts += [sh.charges[None], torch.where(sh.valid, sh.atom_id, -2).view(torch.float32)[None]]
    return _ghost3(torch.cat(parts), mesh)


# ---------------------------------------------------------------------------
# The streaming kernel on the grid's shards (K5s) and the grid's ensembles
# ---------------------------------------------------------------------------

GRID_1M_STEPS = 1000  # the (1,1,1) window at 1M, bench.py's length
GRID_1M_SHORT = 200  # the M = 36 windows


def k5s_check(label, sh, mesh, cfg, model, one_card, gate, e_gate, w_gate, rtol, **kw):
    """K5s on a grid-sharded state vs its plain version before the fold
    (interior forces, the reaction ghost grid, per-slot energies and
    virials) and, after the fold, vs the one-card forces `one_card` (M³, C,
    3); empty slots exactly 0.  Returns (max |dF| vs plain, max |dF| vs one
    card, force scale, max |dE|/|dW| vs plain, ghost slots, own slots).
    Energies within e_gate + rtol·|E|, virials within w_gate + rtol·|W|."""
    from emdee_tpu_torch.distributed.grid_sharded import _fold3, gather_grid_state
    from emdee_tpu_torch.neighbors.streaming_kernel import streaming_ghost_forces

    gh = ghost_stack(sh, mesh, kw.get("uniform_params") is None, kw.get("coulomb") is not None)
    call = lambda be, e: streaming_ghost_forces(gh, mesh.local_shape, mesh.base, cfg, model,  # noqa: E731
                                                compute_energy=e, backend=be, **kw)
    fk, rk, ek, wk = call("cuda", True)
    fp, rp, ep, wp = call("torch", True)
    torch.cuda.synchronize()
    v = sh.valid
    scale = max(float(fp.movedim(0, -1)[v].abs().max()), 1.0)
    err = max(close(f"{label} K5s vs plain forces", fk.movedim(0, -1)[v], fp.movedim(0, -1)[v], atol=gate * scale),
              close(f"{label} K5s vs plain reaction ghosts", rk[:3], rp[:3], atol=gate * scale))
    err_e = max(close(f"{label} K5s vs plain energies", ek[v], ep[v], atol=e_gate, rtol=rtol),
                close(f"{label} K5s vs plain virials", wk[v], wp[v], atol=w_gate, rtol=rtol),
                close(f"{label} K5s vs plain energy reaction ghosts", rk[3], rp[3], atol=e_gate, rtol=rtol),
                close(f"{label} K5s vs plain virial reaction ghosts", rk[4], rp[4], atol=w_gate, rtol=rtol))
    if bool(fk.movedim(0, -1)[~v].any()) or bool(ek[~v].any()) or bool(rk.movedim(0, -1)[torch.isnan(gh[0])].any()):
        raise AssertionError(f"{label}: K5s wrote nonzero values on empty slots")
    fk = call("cuda", False)
    total = fk[0] + _fold3(fk[1], mesh)
    whole = gather_grid_state(sh._replace(positions=total.movedim(0, -1)), cfg, mesh)
    vs_one = close(f"{label} K5s + fold vs the one-card kernel", whole.positions[whole.valid], one_card[whole.valid],
                   atol=gate * scale)
    return err, vs_one, scale, err_e, int(gh[0].numel()), int(v.numel())


def k5s_times(sh, mesh, cfg, model, reps, **kw):
    """Device times of K5s (the pair pass and the assembly), of its energy
    variant, of the plain version, of the fold alone, and of the resident
    GHOST kernel (K2-G) on the same ghost grids, in ms."""
    from emdee_tpu_torch.distributed.grid_sharded import _fold3
    from emdee_tpu_torch.neighbors.cell_kernel import ghost_forces
    from emdee_tpu_torch.neighbors.streaming_kernel import streaming_ghost_forces

    gh = ghost_stack(sh, mesh, kw.get("uniform_params") is None, kw.get("coulomb") is not None)
    args = (gh, mesh.local_shape, mesh.base, cfg, model)
    react = streaming_ghost_forces(*args, backend="cuda", **kw)[1]
    return dict(
        ms=cuda_ms(lambda: streaming_ghost_forces(*args, backend="cuda", **kw), reps),
        energy_ms=cuda_ms(lambda: streaming_ghost_forces(*args, backend="cuda", compute_energy=True, **kw), reps),
        plain_ms=cuda_ms(lambda: streaming_ghost_forces(*args, backend="torch", **kw), 2),
        fold_ms=cuda_ms(lambda: _fold3(react, mesh), reps),
        k2g_ms=cuda_ms(lambda: ghost_forces(*args, backend="cuda", **kw), reps),
    )


def k5s_bound(pairs, ops_per_pair, ghost_slots, own_slots, in_fields, in_bytes=0):
    """(bound ms, what bounds it) of K5s, forces only — the pair pass and
    the assembly that `k5s_times` times as `ms`, not the fold (timed apart
    as `fold_ms`): the pairs inside the cutoff at 67 TFLOP/s against the
    bytes at 3.35 TB/s — the ghost grids' `in_fields` float32 fields (and
    `in_bytes` more) read once, the interior forces and the reaction ghost
    grid written once."""
    nbytes = in_bytes + 4 * (in_fields * ghost_slots + 3 * own_slots + 3 * ghost_slots)
    return bound(nbytes, ops_per_pair * pairs)


def phase_grid_1m(device, tag, eq):
    """bench_all.py's 1M melt on the grid engine (every shard on the card):
    (1,1,1) at M = 37, C = 32 on 'auto', which must resolve to the streaming
    family (K5s + the fold); then M = 36, C = 40 (`melt.even_config`) on
    (2,1,1) 'auto' (K5s again) and on (2,2,2) with backend="cuda_streaming"
    named ('auto' gives K2-G there, run last).  Gates: K5s
    vs its plain version (2e-5 of the force scale) and, after the fold, vs
    the one-card K5; E and W within rtol 1e-5 of the dense closure; the
    decompositions' forces by atom within 2e-5 of the scale; 1,000 NVE
    steps on (1,1,1) (no flag, drift ≤ 3e-5, exact launches: two K5s a force
    evaluation, three K6 a rebin), 200 on each M = 36 mesh; reruns bitwise;
    no host waits.  Last, (2,2,2) at M = 36 on 'auto', which must resolve to
    the resident family (K2-G): K2-G bit for bit the one-card K2a and K2b
    and within 2e-5 of the force scale of its plain version, its time, and
    200 gated NVE steps (one K2-G launch a force evaluation).  Returns (row
    fields, {path: counts}, {path: ms/step}, K2-G's row fields)."""
    from emdee_tpu_torch import cell_dense_init, make_cell_dense_sim
    from emdee_tpu_torch.distributed.grid_sharded import (
        distribute_grid, gather_grid_state, grid_vmem_estimate, make_grid_sharded_sim,
    )
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors.streaming_kernel import cell_forces_streaming, k5_resources

    config, model, params, uni, k = eq["config"], eq["model"], eq["params"], eq["uni"], eq["k"]
    n = config.num_atoms
    st37 = cell_dense_init(eq["pos"], eq["vel"], np.ones(n), params, config, device=device)
    cfg36 = even_config(st37, config)
    st36 = cell_dense_init(eq["pos"], eq["vel"], np.ones(n), params, cfg36, device=device)
    if (cfg36.cells_per_dim, cfg36.capacity) != (36, 40) or bool(st36.overflow):
        raise AssertionError(f"1M grid config: M={cfg36.cells_per_dim} C={cfg36.capacity}, "
                             f"overflow {bool(st36.overflow)}")
    runs = [((1, 1, 1), config, st37, "auto"), ((2, 1, 1), cfg36, st36, "auto"),
            ((2, 2, 2), cfg36, st36, "cuda_streaming")]
    row, counts, ms, forces_by_atom = {}, {}, {}, {}
    err = vs_one = err_e = 0.0
    for shape, cfg, st, backend in runs:
        name = f"grid_1m_{''.join(map(str, shape))}_m{cfg.cells_per_dim}"
        label = f"1M grid {shape} M={cfg.cells_per_dim} C={cfg.capacity}"
        mesh = make_grid_mesh(shape, device=device)
        roll, energy = make_grid_sharded_sim(cfg, model, DT, mesh, backend=backend, uniform_params=uni)
        est = grid_vmem_estimate(cfg, mesh, uni)
        if roll.family != "cuda_streaming":
            raise AssertionError(f"{label}: backend {backend!r} resolves to {roll.family!r} (estimate {est / 1e6:.2f} MB)")
        sd = drifted(st, SKIN)
        sh = distribute_grid(sd, cfg, mesh)
        one = cell_forces_streaming(sd, model, cfg, backend="cuda", uniform_params=uni)[0]
        e, o, scale, ee, ghost_slots, own_slots = k5s_check(label, sh, mesh, cfg, model, one, 2e-5, 1e-4, 2e-3,
                                                            1e-4, uniform_params=uni)
        err, vs_one, err_e = max(err, e), max(vs_one, o), max(err_e, ee)
        f_grid = gather_grid_state(sh._replace(positions=roll.forces(sh)[0]), cfg, mesh)
        forces_by_atom[name] = (by_atom(f_grid, f_grid.positions, n), scale)
        d_energy = make_cell_dense_sim(cfg, model, dt=DT, uniform_params=uni, uniform_mass=1.0)[1]
        sg = distribute_grid(st, cfg, mesh)
        for a, b, what in zip(energy(sg), d_energy(st), ("pe", "virial", "ke")):
            close(f"{label} {what} vs the dense energy closure", a, b, atol=0.0, rtol=1e-5)
        t = k5s_times(sh, mesh, cfg, model, 10, uniform_params=uni)
        t["pass_ms"] = cuda_ms(lambda: roll.forces(sh), 10)
        px, py, pz = (sd.positions[..., i].contiguous() for i in range(3))
        pairs = grid_pairs(px, py, pz, sd.valid, cfg)
        t["bound_ms"], t["bound_by"] = k5s_bound(pairs, OPS_PER_PAIR, ghost_slots, own_slots, 3)
        steps = GRID_1M_STEPS if shape == (1, 1, 1) else GRID_1M_SHORT
        roll(sg, num_steps=2 * k, rebin_every=k)  # warm-up
        _, sec, drift, c = gate_rollout(label, roll, energy, sg, steps, k,
                                        launches(cell_forces_streaming=2 * (steps + 4),
                                                 rebin_window=3 * -(-steps // k)))
        bitwise_rerun(label, roll, sg, 100 if shape == (1, 1, 1) else 50, k)
        no_host_waits(label, lambda: roll(sg, num_steps=2 * k, rebin_every=k))
        counts[name], ms[name] = c, 1e3 * sec / steps
        row[name] = {**t, "pairs": pairs, "estimate_mb": est / 1e6, "force_scale": scale}
        before = K5S_BEFORE.get((cfg.cells_per_dim, shape))
        log(f"{tag} {label} (LocalMesh, uniform params, backend {backend!r} -> {roll.family!r}, per-shard "
            f"estimate {est / 1e6:.2f} MB): K5s vs plain max |dF| {e:.3e}, + fold vs one-card K5 {o:.3e} "
            f"(scale {scale:.2f}); E, W vs the dense closure in rtol 1e-5; K5s {t['ms']:.4f} ms (2 launches"
            + ("" if before is None else f"; the pencil before the redesign {before:.4f}, PERF.md §6") + "), "
            f"energy variant {t['energy_ms']:.4f}, plain {t['plain_ms']:.3f}, fold {t['fold_ms']:.4f}, the force "
            f"pass with halo and fold {t['pass_ms']:.4f}, K2-G on the same ghost grids {t['k2g_ms']:.4f} ms; bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']}; {pairs:,} pairs inside the cutoff); {steps} NVE steps in "
            f"{sec:.3f} s = {ms[name]:.4f} ms/step, drift {drift:.3e}; launches {c}; reruns bitwise; no host waits")
    names = list(forces_by_atom)
    first, scale = forces_by_atom[names[0]]
    decomp = max(close(f"1M grid forces by atom {a} vs {names[0]}", forces_by_atom[a][0], first,
                       atol=2e-5 * scale) for a in names[1:])
    log(f"{tag} 1M grid: forces by atom of {', '.join(names)} agree to max |dF| {decomp:.3e} (gate 2e-5 of the "
        "scale; the fold's order, not bit for bit)")
    res = {f"C={cfg.capacity} {what}": k5_resources(cfg, u, e, ghost=True) for cfg in (config, cfg36)
           for what, u, e in (("uniform", True, False), ("uniform energies", True, True),
                              ("per-atom", False, False), ("per-atom energies", False, True))}
    log(f"{tag} K5s (streaming_lj_kernel, GHOST) resources: {resources_line(res)}")

    # (2,2,2) M = 36 on 'auto', which picks the resident family there: K2-G.
    shape, name = (2, 2, 2), "grid_1m_222_m36_auto"
    label = f"1M grid {shape} M={cfg36.cells_per_dim} C={cfg36.capacity} 'auto'"
    mesh = make_grid_mesh(shape, device=device)
    roll, energy = make_grid_sharded_sim(cfg36, model, DT, mesh, uniform_params=uni)
    est = grid_vmem_estimate(cfg36, mesh, uni)
    if roll.family != "cuda":
        raise AssertionError(f"{label}: 'auto' resolves to {roll.family!r} (estimate {est / 1e6:.2f} MB), not K2-G")
    _, k2g = grid_forces_check(tag, label, cfg36, model, uni, mesh, st36)
    sg = distribute_grid(st36, cfg36, mesh)
    roll(sg, num_steps=2 * k, rebin_every=k)  # warm-up
    _, sec, drift, c = gate_rollout(label, roll, energy, sg, GRID_1M_SHORT, k,
                                    launches(cell_forces=GRID_1M_SHORT + 4, rebin_window=3 * -(-GRID_1M_SHORT // k)))
    bitwise_rerun(label, roll, sg, 50, k)
    no_host_waits(label, lambda: roll(sg, num_steps=2 * k, rebin_every=k))
    counts[name], ms[name] = c, 1e3 * sec / GRID_1M_SHORT
    k2g.update(ms_per_step=ms[name], drift=drift, estimate_mb=est / 1e6)
    log(f"{tag} {label} -> {roll.family!r} (K2-G; per-shard estimate {est / 1e6:.2f} MB): {GRID_1M_SHORT} NVE steps "
        f"in {sec:.3f} s = {ms[name]:.4f} ms/step (before K2-G's redesign 3.55, PERF.md §5), drift {drift:.3e}; "
        f"launches {c}; reruns bitwise; no host waits")
    return (dict(runs=row, max_abs_err=err, vs_one_card=vs_one, energy_err=err_e, decomp_err=decomp, resources=res),
            counts, ms, k2g)


def phase_grid_water_1m(device, tag, w1m):
    """The 985,527-atom water box (M = 26, C = 88) on the grid (2,2,2) on
    'auto', which must resolve to the streaming family's molecular branches
    (K5s-mol: DSF + tags; bonds and angles as term rows), from the lattice
    start: K5s-mol vs its plain version within 2e-4 of the force scale and
    1e-3 kJ/mol in E and W, after the fold vs the one-card K5c the same;
    200 gated NVE steps (drift ≤ 1e-4, no flag, exact launches), reruns
    bitwise; K5s-mol's resources and the card's peak allocation while its
    energy variant (the largest scratch) runs and over the phase.  Returns
    (row fields, counts, ms/step)."""
    from emdee_tpu_torch import build_exclusion_tables, make_exclusion_aux_fn
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid, grid_vmem_estimate, make_grid_sharded_sim
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors.streaming_kernel import (
        cell_forces_streaming, ghost_scratch_bytes, k5s_mol_resources, streaming_ghost_forces,
    )
    from emdee_tpu_torch.tools import water

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)

    box, cfg, model, coul, st = w1m["box"], w1m["cfg"], w1m["model"], w1m["coul"], w1m["st"]
    n = len(box["masses"])
    tabs = build_exclusion_tables(n, box["exclusion_pairs"], box["exclusion_scales"], None)
    aux = make_exclusion_aux_fn(n, *tabs)
    mesh = make_grid_mesh((2, 2, 2), device=device)
    roll, energy = make_grid_sharded_sim(cfg, model, water.DT, mesh, coulomb=coul, excl_tables=tabs,
                                         bonded=water.bonded_system(box, device))
    est = grid_vmem_estimate(cfg, mesh, None, True, True)
    if roll.family != "cuda_streaming":
        raise AssertionError(f"1M water grid: 'auto' resolves to {roll.family!r} (estimate {est / 1e6:.2f} MB)")
    sh = distribute_grid(st, cfg, mesh)
    one = cell_forces_streaming(st, model, cfg, backend="cuda", coulomb=coul, excl=aux(st))[0]
    err, vs_one, scale, err_e, ghost_slots, own_slots = k5s_check(
        "1M water grid (2,2,2)", sh, mesh, cfg, model, one, MOL_FORCE_GATE, MOL_E_GATE, MOL_E_GATE, 0.0,
        coulomb=coul, excl=aux(sh)[:3])
    t = k5s_times(sh, mesh, cfg, model, 5, coulomb=coul, excl=aux(sh)[:3])
    t["pass_ms"] = cuda_ms(lambda: roll.forces(sh), 5)
    t["resources"] = {"step": k5s_mol_resources(cfg, coul, aux(sh)[:3], False),
                      "energy": k5s_mol_resources(cfg, coul, aux(sh)[:3], True)}
    gh = ghost_stack(sh, mesh)
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated(device) / 1e9
    torch.cuda.reset_peak_memory_stats(device)
    streaming_ghost_forces(gh, mesh.local_shape, mesh.base, cfg, model, compute_energy=True, backend="cuda",
                           coulomb=coul, excl=aux(sh)[:3])
    torch.cuda.synchronize()
    t["energy_peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    del gh
    e_tags = int(tabs[0].shape[-1])
    pairs = mol_pairs(st, cfg, box["bonds"], box["box"])[0]
    # Bytes: the ghost grids' 7 fields and the own slots' tags (12E a slot) in.
    t["bound_ms"], t["bound_by"] = k5s_bound(pairs, OPS_PER_PAIR + OPS_MIX + OPS_DSF_FORCE + 3 * e_tags,
                                             ghost_slots, own_slots, 7, 12 * e_tags * own_slots)
    steps = WATER_1M_STEPS
    roll(sh, num_steps=WATER_REBIN, rebin_every=WATER_REBIN)  # warm-up
    _, sec, drift, counts = gate_rollout(
        "1M water grid (2,2,2)", roll, energy, sh, steps, WATER_REBIN,
        launches(cell_forces_streaming=2 * (steps + 4), rebin_window=3 * -(-steps // WATER_REBIN)),
        drift_gate=WATER_DRIFT_GATE,
    )
    bitwise_rerun("1M water grid (2,2,2)", roll, sh, 2 * WATER_REBIN, WATER_REBIN)
    ms = 1e3 * sec / steps
    phase_gb = torch.cuda.max_memory_allocated(device) / 1e9
    log(f"{tag} 1M water grid (2,2,2) (M={cfg.cells_per_dim} C={cfg.capacity}, 'auto' -> {roll.family!r}, "
        f"per-shard estimate {est / 1e6:.2f} MB): K5s-mol vs plain max |dF| {err:.3e} (scale {scale:.1f}), "
        f"|dE|, |dW| {err_e:.3e}; + fold vs the one-card K5c {vs_one:.3e}; K5s-mol {t['ms']:.4f} ms (2 launches; "
        f"before the redesign {K5S_MOL_BEFORE['ms']}), energy variant {t['energy_ms']:.4f}, plain "
        f"{t['plain_ms']:.3f}, fold {t['fold_ms']:.4f}, the force pass with halo, fold and term rows "
        f"{t['pass_ms']:.4f}, K2c-G on the same ghost grids {t['k2g_ms']:.4f} ms (before its redesign "
        f"{K2CG_BEFORE['n1m_ms']}); bound {t['bound_ms']:.5f} ms "
        f"({t['bound_by']}; {pairs:,} pairs inside the cutoff); {steps} NVE steps from the lattice start in "
        f"{sec:.3f} s = {ms:.4f} ms/step, drift {drift:.3e} (gate {WATER_DRIFT_GATE}); launches {counts}; reruns "
        "bitwise")
    log(f"{tag} K5s-mol resources at C={cfg.capacity}: {resources_line(t['resources'])}; the card's peak "
        f"allocation {t['energy_peak_gb']:.2f} GB while the energy variant ran ({base_gb:.2f} GB held before it; "
        f"scratch {ghost_scratch_bytes(8, (cfg.cells_per_dim // 2,) * 3, cfg.capacity, True, mol=True) / 1e9:.2f} GB), "
        f"{phase_gb:.2f} GB over the phase")
    row = {**t, "max_abs_err": err, "vs_one_card": vs_one, "energy_err": err_e, "force_scale": scale,
           "pairs": pairs, "estimate_mb": est / 1e6, "ms_per_step": ms, "drift": drift, "phase_peak_gb": phase_gb}
    return row, {"grid_water_1m_222": counts}, ms


def phase_grid_ensembles(device, tag, config, model, uni, pos_eq, vel_eq, params):
    """Langevin, Berendsen NPT and `reconfigure_grid_state` on the grid
    engine, (2,2,2), at the 97,556-atom melt's M = 16, C = 40
    (`reconfigure_dense_state(cells_multiple_of=2)`): Langevin (friction
    2.0) 1,000 steps, mean T* of the last 500 within 2%; CSVR 500 steps,
    then NPT (CSVR + Berendsen P* = 0.5) 1,000 steps on 'auto' (K2-G's
    energy pass for the pressure) and on 'cuda_streaming' (K5s's): the box
    grows by more than 1% and half the pressure gap closes; launches exact;
    seeded reruns bitwise and another seed differs; no host waits; then
    `reconfigure_grid_state` on the NPT end state and 100 more NPT steps
    with no flag.  Returns ({path: counts}, {path: ms/step})."""
    from emdee_tpu_torch import (
        BerendsenBarostatConfig, CSVRConfig, LangevinConfig, cell_dense_init, reconfigure_dense_state,
        suggest_rebin_interval,
    )
    from emdee_tpu_torch.distributed.grid_sharded import (
        distribute_grid, gather_grid_atoms, make_grid_sharded_sim, reconfigure_grid_state,
    )
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh

    n = config.num_atoms
    k = suggest_rebin_interval(SKIN, DT, T_NVT)
    st16, cfg = reconfigure_dense_state(cell_dense_init(pos_eq, vel_eq, np.ones(n), params, config, device=device),
                                        config, cells_multiple_of=2)
    mesh = make_grid_mesh((2, 2, 2), device=device)
    sh = distribute_grid(st16, cfg, mesh)
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)  # noqa: E731
    counts, ms = {}, {}

    def window(label, name, roll, st0, steps, expected, chunk=None, seed=7):
        """`steps` steps from st0 (in chunks of `chunk`, the temperature read
        after each) with every launch counter set to 0 just before; gates
        the flag and the launches; reruns and host waits."""
        roll(st0, num_steps=2 * k, rebin_every=k, rng=gen(1))  # warm-up
        zero_counts()
        g, out, temps = gen(seed), st0, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps // (chunk or steps)):
            out = roll(out, num_steps=chunk or steps, rebin_every=k, rng=g)
            if chunk:
                temps.append(2.0 * kinetic(out) / (3.0 * n - 3.0))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        c = read_counts()
        if bool(out.overflow) or c != expected:
            raise AssertionError(f"{label}: overflow {bool(out.overflow)}, launches {c}, expected {expected}")
        bitwise_rerun(label, roll, st0, 50, k, seed=11)
        no_host_waits(label, lambda: roll(st0, num_steps=2 * k, rebin_every=k, rng=gen(3)))
        counts[name], ms[name] = c, 1e3 * sec / steps
        return out, torch.stack(temps) if temps else None

    def kinetic(s):  # on the device: the rollout's chunks are not synchronised
        return 0.5 * torch.sum(torch.where(s.valid[..., None], s.velocities**2 / s.inv_masses[..., None].clamp(min=1e-30),
                                           0.0))

    # Langevin: 1,000 steps, T* read every 50.
    lang, _ = make_grid_sharded_sim(cfg, model, DT, mesh, uniform_params=uni,
                                    thermostat=LangevinConfig(T_NVT, FRICTION))
    steps, chunk = 1000, 50
    expected = launches(cell_forces=steps + steps // chunk, rebin_window=3 * (steps // chunk) * -(-chunk // k))
    _, temps = window("grid Langevin (2,2,2)", "grid_222_m16_langevin", lang, sh, steps, expected, chunk)
    t_last = float(temps[len(temps) // 2:].double().mean())
    if not abs(t_last / T_NVT - 1.0) <= T_GATE:
        raise AssertionError(f"grid Langevin: mean T* of the last 500 steps {t_last:.4f}, target {T_NVT}")
    log(f"{tag} grid Langevin (2,2,2) M={cfg.cells_per_dim} C={cfg.capacity} (friction {FRICTION}, global noise "
        f"field cut to the shards): {steps} steps, {ms['grid_222_m16_langevin']:.4f} ms/step; mean T* of the last "
        f"500 steps {t_last:.4f} (gate {T_GATE:.0%} of {T_NVT}); launches {counts['grid_222_m16_langevin']}; "
        "reruns from one seed bitwise equal, another seed differs; no host waits")

    # CSVR to the target, then NPT on both energy passes.
    csvr = CSVRConfig(T_NVT, TAU_T)
    nvt, energy = make_grid_sharded_sim(cfg, model, DT, mesh, uniform_params=uni, thermostat=csvr)
    st_nvt = nvt(sh, num_steps=500, rebin_every=k, rng=gen(5))
    p0 = pressure(energy, st_nvt, cfg)
    steps, blocks = 1000, -(-1000 // k)
    baro = BerendsenBarostatConfig(P_NPT, TAU_P, KAPPA)
    for backend in ("auto", "cuda_streaming"):
        npt, _ = make_grid_sharded_sim(cfg, model, DT, mesh, uniform_params=uni, thermostat=csvr, barostat=baro,
                                       backend=backend)
        kernel = "cell_forces" if npt.family == "cuda" else "cell_forces_streaming"
        per = 1 if npt.family == "cuda" else 2
        name = f"grid_222_m16_npt_{npt.family}"
        expected = launches(**{kernel: per * (1 + steps + blocks)}, rebin_window=3 * blocks)
        out, _ = window(f"grid NPT (2,2,2) on {npt.family!r}", name, npt, st_nvt, steps, expected)
        p1 = pressure(energy, out, cfg)
        grew = float(out.box) / cfg.box - 1.0
        if not (grew > 0.01 and abs(p1 - P_NPT) < 0.5 * abs(p0 - P_NPT)):
            raise AssertionError(f"grid NPT on {npt.family!r}: box grew {grew:.4f}, P* {p0:.4f} -> {p1:.4f}")
        log(f"{tag} grid NPT (2,2,2) on {backend!r} -> {npt.family!r} (the pressure from "
            f"{'K2-G' if npt.family == 'cuda' else 'K5s'}'s energy pass): {steps} steps, {ms[name]:.4f} ms/step; "
            f"P* {p0:.4f} -> {p1:.4f} (target {P_NPT}), box {cfg.box:.4f} -> {float(out.box):.4f} "
            f"({100 * grew:+.2f}%); launches {counts[name]}; reruns from one seed bitwise equal, another seed "
            "differs; no host waits")

    # The geometry re-derive on the NPT end state, and a continued run.
    p_a, v_a = gather_grid_atoms(out, cfg, n, mesh)
    st2, cfg2 = reconfigure_grid_state(out, cfg, mesh)
    p_b, v_b = gather_grid_atoms(st2, cfg2, n, mesh)
    box2 = np.float32(cfg2.box)
    wrap = lambda p: p - np.floor(p / box2) * box2  # noqa: E731
    if not (np.array_equal(v_a, v_b) and np.array_equal(wrap(p_a), wrap(p_b))) or bool(st2.overflow):
        raise AssertionError("reconfigure_grid_state: the atoms changed, or the re-init overflowed")
    npt2, _ = make_grid_sharded_sim(cfg2, model, DT, mesh, uniform_params=uni, thermostat=csvr, barostat=baro)
    cont = npt2(st2, num_steps=100, rebin_every=k, rng=gen(9))
    if bool(cont.overflow):
        raise AssertionError("reconfigure_grid_state: the continued NPT run flagged")
    log(f"{tag} reconfigure_grid_state on the NPT end state: M={cfg.cells_per_dim} C={cfg.capacity} -> "
        f"M={cfg2.cells_per_dim} C={cfg2.capacity} at box {cfg2.box:.4f}; every atom's position (up to the wrap) "
        f"and velocity survive exactly; 100 more NPT steps on {npt2.family!r}: no flag, box {float(cont.box):.4f}")
    return counts, ms


def phase_grid_spill(device, tag, st, scfg, model, uni, params, grid_ms, grid_kps):
    """Spill configs on the grid engine, at the melt's spill config (M = 16,
    C = 32, squeezed toward 28) from its spill init.  K7-G's two forms on
    the raw fields (parked and wrapped in the first pass), on the state
    drifted 0.45·skin and on it with the cells at y = 0 moved one cell up
    (the y pass overflows), on (1,1,1), (2,2,2) and (2,4,1): the per-pass
    form (each pass on the shards' own rows with the two-layer halo
    planes) pass by pass vs its plain version, and the one-launch form
    (`spill_grid_rebin`: the three passes in one cooperative launch) vs
    its plain version and vs the three passes, all bit for bit in every
    slot and the flag; how many spills and hold-backs fired, across shard
    faces and the periodic seam; on (1,1,1) both forms vs K7's route of the
    one-card state (the live slots, every slot of the fields but the
    positions, whose fill differs, the mask, the flag); the times of both
    forms (the per-pass form's pass, and its whole rebin with its halo
    planes; the one-launch rebin), on the device and with the host's
    launch cost, their plain versions', one `scatter_` compaction of a
    pass, and their bounds.  Then, measured and
    not gated, whether 1,000 NVE steps at C = 32 on (2,2,2) 'auto' raise the
    flag, and at which rebin, with that rebin's cause (ROADMAP fault R6: on
    this trajectory a cell's true occupancy passes C).  Then the engine at
    C = 40 (the grid's plain-config capacity at M = 16), still squeezed
    toward 28: 1,000 gated NVE steps on (1,1,1) and (2,2,2) on 'auto'
    (K2-G), rebinning every 6 (drift, one K7-G launch a rebin, reruns,
    no host waits), the two end states bitwise equal, and on each mesh
    K7-G's one-launch form vs its plain version and the three per-pass
    launches on the engine's own fields at C = 40 (two 32-slot chunks a
    row), drifted at the start and at the end state; 200 gated steps on
    (2,2,2) 'cuda_streaming' (K5s within 2e-5 of its plain version's
    forces); Langevin on (2,2,2), the mean T* of the last 500 of 1,000
    steps within 2%; the (1,1,1) run through a one-rank NCCL `DistMesh`;
    ms/step and device kernels a step beside the plain-config grid's.
    Returns (the per-pass form's row, the one-launch form's row, {path:
    counts}, {path: ms/step})."""
    from emdee_tpu_torch import LangevinConfig, cell_dense_init, gather_dense_atoms, suggest_rebin_interval
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid, gather_grid_state, make_grid_sharded_sim
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors import rebin_window_kernel as k6
    from emdee_tpu_torch.neighbors.cell_dense import (
        _axis_coords, _roll_cells, _route_windows, _spill_params, state_to_numpy,
    )
    from emdee_tpu_torch.neighbors.compact_kernel import spill_routing
    from emdee_tpu_torch.tools.fixtures import spill_census

    m, c, ns, n = scfg.cells_per_dim, scfg.capacity, scfg.num_slots, scfg.num_atoms
    box = torch.full((), scfg.box, dtype=torch.float32, device=device)
    spill = _spill_params(scfg)
    sd = drifted(st, SKIN)
    crowd = ((torch.arange(m**3, device=device) // m) % m == 0)[:, None, None] & sd.valid[..., None]
    up_y = torch.tensor([0.0, float(scfg.cell_side), 0.0], device=device)
    crowded = sd._replace(positions=sd.positions + torch.where(crowd, up_y, 0.0))
    before = state_to_numpy(sd)

    # One pass's compaction by one scatter_ (the z pass's windows of the
    # one-card fields): the part of the pass that one PyTorch call computes.
    flds = [sd.positions[..., i] for i in range(3)] + [sd.velocities[..., i] for i in range(3)]
    flds += [sd.inv_masses, sd.half_sigma, sd.twice_sqrt_eps]
    wrapped = [torch.where(sd.valid, f - torch.floor(f / box) * box, 0.0) for f in flds[:3]] + flds[3:] + [sd.atom_id]
    ovf0 = torch.zeros((), dtype=torch.bool, device=device)
    nbr = lambda x, d: _roll_cells(x, (0, 0, d), m)  # noqa: E731  the z pass
    s_, keep, win, _, _ = _route_windows(wrapped, sd.valid, ovf0, 2, _axis_coords(m, device)[0], m, c, nbr, box, spill)
    nf_, rows_, k3 = win.shape
    lane = torch.arange(k3, device=device)
    dest = torch.where(keep & (lane - s_ < c), lane - s_.long(), c).expand(nf_, rows_, k3)
    dump = torch.zeros((nf_, rows_, c + 1), dtype=torch.int32, device=device)
    scatter_ms = device_ms(lambda: dump.scatter_(2, dest, win), 200)
    del s_, keep, win, dest, dump

    timing, census = {}, {}
    for shape in ((1, 1, 1), (2, 2, 2), (2, 4, 1)):
        mesh = make_grid_mesh(shape, device=device)
        local = tuple(m // d for d in shape)
        coords = [k6.global_coords(mesh, local, axis) for axis in range(3)]
        for label, s, want in (("drifted", sd, False), ("crowded", crowded, True)):
            sh = distribute_grid(s, scfg, mesh)
            fields = grid_fields(sh, ns)
            x, y, raised = k7g_forms(fields, mesh, coords, box, m, c, ns, spill, f"{shape} {label}")
            if raised != want:
                raise AssertionError(f"K7-G {shape} {label}: flag {raised}, expected {want}")
            if shape == (1, 1, 1):
                one = [s.positions[..., i] for i in range(3)] + [s.velocities[..., i] for i in range(3)]
                one += [s.inv_masses, s.half_sigma, s.twice_sqrt_eps, s.atom_id]
                ref, valid, ovf = spill_routing(tuple(one), box, m, c, ns, spill, s.valid, backend="cuda")
                torch.cuda.synchronize()
                for form, out in (("per-pass", x), ("one-launch", y)):
                    got = out.reshape(len(one), m**3, c)
                    if bool(ovf) != want or not torch.equal(got[-1] < ns, valid):
                        raise AssertionError(f"K7-G {form} (one shard) vs K7, {label}: the flag or the mask differs")
                    for i, r in enumerate(ref):
                        mask = valid if i < 3 else torch.ones_like(valid)
                        if not torch.equal(got[i][mask], r.view(torch.int32)[mask]):
                            raise AssertionError(f"K7-G {form} (one shard) vs K7, {label}: field {i} differs")
            if label == "drifted":
                xf, valid = x[:-1].view(torch.float32), x[-1] < ns
                routed = sh._replace(positions=torch.where(valid, xf[0:3], 0.0).movedim(0, -1), atom_id=x[-1],
                                     valid=valid)
                census[shape] = spill_census(before, state_to_numpy(gather_grid_state(routed, scfg, mesh)), scfg, shape)
        cs = census[shape]
        if cs["spills"] < 1 or cs["holds"] < 1 or cs["seam"] < 1 or (shape != (1, 1, 1) and cs["faces"] < 1):
            raise AssertionError(f"K7-G {shape} fixture: {cs}")
        sh = distribute_grid(sd, scfg, mesh)
        fields = grid_fields(sh, ns)
        z_args = (fields, *k6.halo_planes(fields, mesh, 0, depth=2), coords[0], box, 0, m, c, ns, spill, True)
        z = lambda: k6.spill_halo_pass(*z_args, backend="cuda")  # noqa: E731
        whole = lambda: k7g_passes(fields, mesh, coords, box, m, c, ns, spill, False)  # noqa: E731
        grid = lambda: k6.spill_grid_rebin(fields, mesh, coords, box, m, c, ns, spill, backend="cuda")  # noqa: E731
        t = dict(device_ms=device_ms(z, 50), ms=cuda_ms(z, 50), rebin_device_ms=device_ms(whole, 20),
                 rebin_ms=cuda_ms(whole, 20), plain_ms=cuda_ms(lambda: k6.spill_halo_plain(*z_args), 10),
                 grid_device_ms=device_ms(grid, 50), grid_ms=cuda_ms(grid, 50),
                 grid_plain_ms=cuda_ms(lambda: k6.spill_grid_rebin_plain(fields, box, m, c, ns, spill), 10))
        # Each field read once and written once, the halo planes (two layers
        # each side; none on an axis of one shard) read once, and each row's
        # coordinate; the one-launch rebin moves the fields alone.
        nf, rows = len(fields), m**3
        halo_slots = 0 if shape[0] == 1 else 4 * rows // local[0] * c
        t["bound_ms"], t["bound_by"] = bound(4 * nf * (2 * rows * c + halo_slots) + 4 * rows, 0)
        t["grid_bound_ms"], t["grid_bound_by"] = bound(4 * nf * 2 * rows * c, 0)
        timing[shape] = {**t, "census": cs}
        log(f"{tag} K7-G {shape} at the spill config (M={m} C={c} target {scfg.spill_target}, nf={nf}, strided "
            f"positions and velocities parked and wrapped in the first pass): the per-pass form pass by pass vs "
            f"plain, and the one-launch form vs its plain version and vs the three per-pass launches, bit-exact in "
            f"every slot and the flag, drifted and with the y pass overflowing"
            + (", both forms vs K7's route bit-exact in the live slots, the mask and the flag" if shape == (1, 1, 1)
               else "")
            + f"; the rebin of the drifted state: {cs['spills']} spills, {cs['holds']} hold-backs, {cs['faces']} "
            f"across a shard face, {cs['seam']} across the seam; one-launch rebin {t['grid_device_ms']:.5f} ms on "
            f"the device ({t['grid_ms']:.5f} with the host's launch cost), plain {t['grid_plain_ms']:.4f} ms, bound "
            f"{t['grid_bound_ms']:.5f} ms ({t['grid_bound_by']}, {t['grid_bound_ms'] / t['grid_device_ms']:.1%} of "
            f"it reached); per-pass form: z pass {t['device_ms']:.5f} ms on the device ({t['ms']:.5f} with the "
            f"host's launch cost), the whole rebin with its halo planes {t['rebin_device_ms']:.5f} "
            f"({t['rebin_ms']:.5f}); plain z pass {t['plain_ms']:.4f} ms; one pass's compaction by one scatter_ "
            f"{scatter_ms:.5f} ms; bound {t['bound_ms']:.5f} ms a pass ({t['bound_by']}, "
            f"{t['bound_ms'] / t['device_ms']:.1%} of it reached)")
    grid_resources, warps = k7g_grid_warps()
    log(f"{tag} K7-G one-launch form's cooperative grid: {grid_resources}, {warps} resident warps for {m**3} rows")

    k, steps = 6, 1000
    # C = 32: does one 1,000-step call hold? (a measurement, not a gate)
    mesh = make_grid_mesh((2, 2, 2), device=device)
    roll32, _ = make_grid_sharded_sim(scfg, model, DT, mesh, uniform_params=uni)
    sh32 = distribute_grid(st, scfg, mesh)
    blocks = -(-steps // k)
    if bool(roll32(sh32, num_steps=steps, rebin_every=k).overflow):
        lo, hi = 0, blocks  # the flag is raised after block hi, not after block lo
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if bool(roll32(sh32, num_steps=k * mid, rebin_every=k).overflow) else (mid, hi)
        start = roll32(sh32, num_steps=k * lo, rebin_every=k) if lo else sh32
        held32 = f"the flag trips in rebin block {hi} of {blocks}; that rebin: " \
            f"{flag_cause(gather_grid_state(start, scfg, mesh), scfg)}"
    else:
        held32 = f"no flag in {blocks} rebin blocks"
    log(f"{tag} grid spill (2,2,2) at C={c} (squeezed toward {scfg.spill_target}), one {steps}-step call on 'auto', "
        f"rebin every {k} (measured, not gated): {held32}")
    del sh32

    # The gated runs at C = 40, squeezed toward 28 all the same.
    gcfg = scfg._replace(capacity=40)
    gst = cell_dense_init(*gather_dense_atoms(st, n), np.ones(n), params, gcfg, device=device)
    if bool(gst.overflow):
        raise AssertionError("grid spill: re-init overflow at C = 40")
    st, scfg, c = gst, gcfg, gcfg.capacity
    spill = _spill_params(scfg)
    counts, ms, finals, kps = {}, {}, {}, {}
    for shape in ((1, 1, 1), (2, 2, 2)):
        mesh = make_grid_mesh(shape, device=device)
        name = f"grid_spill_{''.join(map(str, shape))}"
        label = f"grid spill {shape} M={m} C={c}"
        roll, energy = make_grid_sharded_sim(scfg, model, DT, mesh, uniform_params=uni)
        if roll.family != "cuda":
            raise AssertionError(f"{label}: 'auto' resolves to {roll.family!r}")
        sh = distribute_grid(st, scfg, mesh)
        coords = [k6.global_coords(mesh, tuple(m // d for d in shape), axis) for axis in range(3)]
        fields = grid_fields(distribute_grid(drifted(st, SKIN), scfg, mesh), ns)
        if k7g_forms(fields, mesh, coords, box, m, c, ns, spill, f"{label} drifted")[2]:
            raise AssertionError(f"K7-G {label} drifted: the flag is raised")
        roll(sh, num_steps=2 * k, rebin_every=k)  # warm-up
        out, sec, drift, cnt = gate_rollout(label, roll, energy, sh, steps, k,
                                            launches(cell_forces=steps + 4, spill_grid=-(-steps // k)))
        bitwise_rerun(label, roll, sh, 100, k)
        no_host_waits(label, lambda: roll(sh, num_steps=2 * k, rebin_every=k))
        if k7g_forms(grid_fields(out, ns), mesh, coords, box, m, c, ns, spill, f"{label} end state")[2]:
            raise AssertionError(f"K7-G {label} end state: the flag is raised")
        finals[name] = state_to_numpy(gather_grid_state(out, scfg, mesh))
        held = spill_census(finals[name], finals[name], scfg)["holds"]
        kps[name] = kernels_per_step(lambda: roll(sh, num_steps=60, rebin_every=k), 60)
        counts[name], ms[name] = cnt, 1e3 * sec / steps
        log(f"{tag} {label} ('auto' -> K2-G, K7-G's one launch a rebin every {k}): {steps} steps in {sec:.3f} s = "
            f"{ms[name]:.4f} ms/step; NVE drift {drift:.3e}; launches {cnt}; {held} atoms stored one cell above "
            "their true cell at the end; reruns bitwise equal; no host waits; K7-G's one-launch form vs its plain "
            "version and the three per-pass launches bit-exact on the drifted start and the end state")
    a, b = finals.values()
    if not all(np.array_equal(np.atleast_1d(b[f]).view(np.uint8), np.atleast_1d(v).view(np.uint8))
               for f, v in a.items()):
        raise AssertionError("grid spill: the (1,1,1) and (2,2,2) end states differ")

    mesh = make_grid_mesh((2, 2, 2), device=device)
    sh = distribute_grid(st, scfg, mesh)
    roll_s, energy_s = make_grid_sharded_sim(scfg, model, DT, mesh, uniform_params=uni, backend="cuda_streaming")
    roll_p, _ = make_grid_sharded_sim(scfg, model, DT, mesh, uniform_params=uni, backend="torch_streaming")
    sdd = distribute_grid(drifted(st, SKIN), scfg, mesh)
    fk, fp = roll_s.forces(sdd)[0], roll_p.forces(sdd)[0]
    torch.cuda.synchronize()
    scale = float(fp.abs().max())
    k5s_err = close("grid spill (2,2,2): K5s vs plain", fk, fp, atol=2e-5 * scale)
    del fk, fp, sdd
    name, steps_s = "grid_spill_222_streaming", 200
    roll_s(sh, num_steps=2 * k, rebin_every=k)  # warm-up
    _, sec, drift, cnt = gate_rollout("grid spill (2,2,2) cuda_streaming", roll_s, energy_s, sh, steps_s, k,
                                      launches(cell_forces_streaming=2 * (steps_s + 4),
                                               spill_grid=-(-steps_s // k)))
    bitwise_rerun("grid spill (2,2,2) cuda_streaming", roll_s, sh, 50, k)
    counts[name], ms[name] = cnt, 1e3 * sec / steps_s
    kps[name] = kernels_per_step(lambda: roll_s(sh, num_steps=60, rebin_every=k), 60)
    log(f"{tag} grid spill (2,2,2) on 'cuda_streaming' (K5s, K7-G): K5s vs plain max |dF| {k5s_err:.3e} (scale "
        f"{scale:.3f}); {steps_s} steps, {ms[name]:.4f} ms/step; NVE drift {drift:.3e}; launches {cnt}; reruns "
        "bitwise equal")

    k_t = suggest_rebin_interval(SKIN, DT, T_NVT)
    lang, _ = make_grid_sharded_sim(scfg, model, DT, mesh, uniform_params=uni, thermostat=LangevinConfig(T_NVT, FRICTION))
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)  # noqa: E731
    lang(sh, num_steps=2 * k_t, rebin_every=k_t, rng=gen(1))  # warm-up
    steps_l, chunk = 1000, 50
    zero_counts()
    g, out, temps = gen(7), sh, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps_l // chunk):
        out = lang(out, num_steps=chunk, rebin_every=k_t, rng=g)
        ke = 0.5 * torch.sum(torch.where(out.valid[..., None], out.velocities**2, 0.0) / out.inv_masses[..., None]
                             .clamp(min=1e-30))
        temps.append(2.0 * ke / (3.0 * n - 3.0))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    cnt = read_counts()
    expected = launches(cell_forces=steps_l + steps_l // chunk,
                        spill_grid=(steps_l // chunk) * -(-chunk // k_t))
    if bool(out.overflow) or cnt != expected:
        raise AssertionError(f"grid spill Langevin: overflow {bool(out.overflow)}, launches {cnt}, "
                             f"expected {expected}")
    t_last = float(torch.stack(temps[len(temps) // 2:]).double().mean())
    if not abs(t_last / T_NVT - 1.0) <= T_GATE:
        raise AssertionError(f"grid spill Langevin: mean T* of the last 500 steps {t_last:.4f}, target {T_NVT}")
    bitwise_rerun("grid spill Langevin", lang, sh, 50, k_t, seed=11)
    name = "grid_spill_222_langevin"
    counts[name], ms[name] = cnt, 1e3 * sec / steps_l
    log(f"{tag} grid spill Langevin (2,2,2) (friction {FRICTION}, rebin every {k_t}): {steps_l} steps, "
        f"{ms[name]:.4f} ms/step; mean T* of the last 500 steps {t_last:.4f} (gate {T_GATE:.0%} of {T_NVT}); "
        f"launches {cnt}; reruns from one seed bitwise equal, another seed differs")

    nccl_vs_local_mesh("grid spill (1,1,1)", scfg, model, DT, st, {"uniform_params": uni}, 100, k, device)
    log(f"{tag} grid spill (1,1,1) through a one-rank NCCL DistMesh: 100 steps and the energies bitwise equal to "
        "LocalMesh")
    fmt = lambda v: "not measured" if v is None else f"{v:.1f}"  # noqa: E731
    log(f"{tag}: grid spill (M={m} C={c} target {scfg.spill_target}) ms/step and device kernels a step "
        + ", ".join(f"{p} {ms[p]:.4f} ({fmt(kps.get(p))})" for p in ms)
        + "; the plain-config grid (M=16 C=40) " + ", ".join(f"{p} {grid_ms[p]:.4f} ({fmt(grid_kps.get(p))})"
                                                          for p in ("grid_111_m16", "grid_222_m16")))
    one = timing[(1, 1, 1)]
    grid_keys = ("grid_device_ms", "grid_ms", "grid_plain_ms", "grid_bound_ms", "grid_bound_by")
    pass_row = {"max_abs_err": 0.0, **{key: v for key, v in one.items() if key not in grid_keys + ("census",)},
                "library_ms": scatter_ms, "census": one["census"],
                **{f"grid_{''.join(map(str, sh))}": {key: v for key, v in t.items() if key not in grid_keys}
                   for sh, t in timing.items() if sh != (1, 1, 1)},
                "k5s_max_abs_err": k5s_err, "kernels_per_step": kps}
    form = lambda t: {key[len("grid_"):]: t[key] for key in grid_keys}  # noqa: E731
    grid_row = {"max_abs_err": 0.0, **form(one), "library_ms": None, "scatter_ms": scatter_ms,
                **{f"grid_{''.join(map(str, sh))}": form(t) for sh, t in timing.items() if sh != (1, 1, 1)},
                "resources": grid_resources, "kernels_per_step": kps}
    return pass_row, grid_row, counts, ms


def phase_grid_spill_1m(device, tag, eq):
    """K7-G's one-launch form at the 1M melt's spill config (`spill_config`
    of its wide config: M = 35, C = 32, squeezed toward 28; 42,875 rows, so
    every warp of the cooperative grid routes several rows a pass), on the
    equilibrated melt's spill init drifted 0.45·skin and on it with the
    cells at y = 0 moved one cell up (the y pass overflows), on (1,1,1)
    and (5,7,1) (7, 5 and 35 layers a shard): vs its plain version and vs
    the per-pass form's three launches, bit for bit in every slot and the
    flag; on (1,1,1) its time on both clocks, the per-pass rebin's, and
    its bound.  Returns the row fields."""
    from emdee_tpu_torch import cell_dense_init
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors import rebin_window_kernel as k6
    from emdee_tpu_torch.neighbors.cell_dense import _spill_params

    n = eq["config"].num_atoms
    scfg = spill_config(eq["config"])
    st = cell_dense_init(eq["pos"], eq["vel"], np.ones(n), eq["params"], scfg, device=device)
    m, c, ns = scfg.cells_per_dim, scfg.capacity, scfg.num_slots
    rows = m**3
    resources, warps = k7g_grid_warps()
    if (m, c) != (35, 32) or bool(st.overflow) or rows <= 2 * warps:
        raise AssertionError(f"1M spill init: M={m} C={c}, overflow {bool(st.overflow)}, {rows} rows for {warps} "
                             "resident warps")
    box = torch.full((), scfg.box, dtype=torch.float32, device=device)
    spill = _spill_params(scfg)
    sd = drifted(st, SKIN)
    crowd = ((torch.arange(rows, device=device) // m) % m == 0)[:, None, None] & sd.valid[..., None]
    up_y = torch.tensor([0.0, float(scfg.cell_side), 0.0], device=device)
    crowded = sd._replace(positions=sd.positions + torch.where(crowd, up_y, 0.0))
    flags, row = {}, {}
    for shape in ((1, 1, 1), (5, 7, 1)):
        mesh = make_grid_mesh(shape, device=device)
        coords = [k6.global_coords(mesh, tuple(m // d for d in shape), axis) for axis in range(3)]
        for label, s in (("drifted", sd), ("crowded", crowded)):
            fields = grid_fields(distribute_grid(s, scfg, mesh), ns)
            flags[shape, label] = k7g_forms(fields, mesh, coords, box, m, c, ns, spill, f"1M {shape} {label}")[2]
        if not flags[shape, "crowded"]:
            raise AssertionError(f"K7-G one launch 1M {shape} crowded: the y pass's overflow did not raise the flag")
        if shape == (1, 1, 1):
            fields = grid_fields(distribute_grid(sd, scfg, mesh), ns)
            grid = lambda: k6.spill_grid_rebin(fields, mesh, coords, box, m, c, ns, spill, backend="cuda")  # noqa: E731
            whole = lambda: k7g_passes(fields, mesh, coords, box, m, c, ns, spill, False)  # noqa: E731
            row = dict(device_ms=device_ms(grid, 20), ms=cuda_ms(grid, 20), per_pass_device_ms=device_ms(whole, 10))
            row["bound_ms"], row["bound_by"] = bound(4 * len(fields) * 2 * rows * c, 0)
    log(f"{tag} K7-G one launch at the 1M spill config (M={m} C={c} target {scfg.spill_target}, {n} atoms, {rows} "
        f"rows for {warps} resident warps: every warp routes {rows // warps}-{-(-rows // warps)} rows a pass): vs "
        f"its plain version and the three per-pass launches bit-exact in every slot and the flag on (1,1,1) and "
        f"(5,7,1), drifted (flag {flags[(1, 1, 1), 'drifted']}) and crowded (flag raised); (1,1,1) one-launch rebin "
        f"{row['device_ms']:.5f} ms on the device ({row['ms']:.5f} with the host's launch cost), per-pass rebin "
        f"{row['per_pass_device_ms']:.5f}, bound {row['bound_ms']:.5f} ms ({row['bound_by']}, "
        f"{row['bound_ms'] / row['device_ms']:.1%} of it reached)")
    return {"n1m": {"cells_per_dim": m, "capacity": c, "rows": rows, "resident_warps": warps,
                    "drifted_flag": flags[(1, 1, 1), "drifted"], **row}}

def phase_grid_water(device, tag, w, dense_drift):
    """The water box on the grid-sharded engine (K2c-G), every shard on the
    card, at the plain config (M = 12, C = 80): on (1,1,1) and (2,2,2) the
    molecular pair forces, energies and virials bit for bit the one-card
    K2c-q's (no bond tags) on the equilibrated state drifted 0.45·skin, the
    total forces (pairs and term rows) bitwise equal between the two, the
    energy within rel 1e-5 of the one-card engine's closure; K2c-G vs the
    ghost pass's plain version and its times; K2c-G's variants' resources
    as the card reports them (no local bytes); the gated 600-step NVE window
    on (2,2,2) (drift ≤ 1e-4, no flag, one K2c-G launch a force evaluation
    and three K6 a rebin, bitwise reruns, no host waits); the triatomic
    fixture on (2,2,2) against the one-card 'torch' engine after 20 steps
    within 2e-4.  Returns (K2c-G row fields, counts, ms/step)."""
    from emdee_tpu_torch import build_exclusion_tables, gather_dense_atoms, make_exclusion_aux_fn
    from emdee_tpu_torch.distributed.grid_sharded import (
        distribute_grid, gather_grid_atoms, gather_grid_state, make_grid_sharded_sim,
    )
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces, ghost_forces, k2c_resources
    from emdee_tpu_torch.tools import fixtures, water

    box, cfg, model, coul, params = w["box"], w["cfg"], w["model"], w["coul"], w["params"]
    n = len(box["masses"])
    st = w["init"](w["pos_eq"], w["vel_eq"], cfg)
    tabs = build_exclusion_tables(n, box["exclusion_pairs"], box["exclusion_scales"], None)
    kw = dict(coulomb=coul, excl_tables=tabs, bonded=water.bonded_system(box, device))
    sd = drifted(st, water.SKIN)
    aux = make_exclusion_aux_fn(n, *tabs)
    ref = cell_forces(sd, model, cfg, compute_energy=True, backend="cuda", coulomb=coul, excl=aux(sd))
    pe1 = float(w["energy"](st)[0])
    totals, timing = {}, {}
    for shape in ((1, 1, 1), (2, 2, 2)):
        mesh = make_grid_mesh(shape, device=device)
        sh = distribute_grid(sd, cfg, mesh)
        roll, energy = make_grid_sharded_sim(cfg, model, water.DT, mesh, **kw)
        whole = lambda f, e=None, w_=None: gather_grid_state(  # noqa: E731
            sh._replace(positions=f, half_sigma=sh.half_sigma if e is None else e,
                        twice_sqrt_eps=sh.twice_sqrt_eps if w_ is None else w_), cfg, mesh)
        pair = whole(*roll.forces(sh, compute_energy=True, with_terms=False))
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip((pair.positions, pair.half_sigma, pair.twice_sqrt_eps), ref)):
            raise AssertionError(f"grid water {shape}: K2c-G pair terms differ from the one-card K2c-q's")
        totals[shape] = whole(roll.forces(sh)[0]).positions
        pe = float(energy(distribute_grid(st, cfg, mesh))[0])
        if not abs(pe - pe1) <= 1e-5 * abs(pe1):
            raise AssertionError(f"grid water {shape}: PE {pe:.3f} vs the one-card closure's {pe1:.3f}")
        gh, tags = ghost_stack(sh, mesh), aux(sh)[:3]
        gk = dict(coulomb=coul, excl=tags)
        call = lambda be, e=False: ghost_forces(gh, mesh.local_shape, mesh.base, cfg, model, backend=be,  # noqa: E731
                                                compute_energy=e, **gk)
        fk, ek, wk = call("cuda", True)
        fp, ep, wp = call("torch", True)
        torch.cuda.synchronize()
        v = sh.valid
        scale = max(float(fp.movedim(0, -1)[v].abs().max()), 1.0)
        err = close(f"grid water {shape} K2c-G vs plain forces", fk.movedim(0, -1)[v], fp.movedim(0, -1)[v],
                    atol=MOL_FORCE_GATE * scale)
        err_e = max(close(f"grid water {shape} K2c-G vs plain energies", ek[v], ep[v], atol=MOL_E_GATE),
                    close(f"grid water {shape} K2c-G vs plain virials", wk[v], wp[v], atol=MOL_E_GATE))
        timing[shape] = dict(ms=cuda_ms(lambda: call("cuda"), 20), energy_ms=cuda_ms(lambda: call("cuda", True), 10),
                             plain_ms=cuda_ms(lambda: call("torch"), 2), pass_ms=cuda_ms(lambda: roll.forces(sh), 10),
                             err=err, err_e=err_e, scale=scale, ghost_slots=int(gh[0].numel()))
        before = K2CG_BEFORE["n111_ms" if shape == (1, 1, 1) else "ms"]
        log(f"{tag} grid water {shape} (M={cfg.cells_per_dim} C={cfg.capacity}, LocalMesh): K2c-G pair forces, "
            f"energies and virials bit for bit the one-card K2c-q's; PE {pe:.3f} vs one-card {pe1:.3f} kJ/mol; "
            f"K2c-G vs plain max |dF| {err:.3e} (scale {scale:.1f}), |dE|, |dW| {err_e:.3e}; K2c-G launch "
            f"{timing[shape]['ms']:.4f} ms (before its redesign {before}), energy launch "
            f"{timing[shape]['energy_ms']:.4f} ms (before {K2CG_BEFORE['energy_ms']}), plain "
            f"{timing[shape]['plain_ms']:.3f} ms, the force pass with halo and term rows "
            f"{timing[shape]['pass_ms']:.4f} ms")
    if not torch.equal(totals[(1, 1, 1)].view(torch.int32), totals[(2, 2, 2)].view(torch.int32)):
        raise AssertionError("grid water: total forces (pairs + term rows) differ between (1,1,1) and (2,2,2)")
    res = {"step": k2c_resources(cfg, coul, tags, False, ghost=True),
           "energy": k2c_resources(cfg, coul, tags, True, ghost=True)}
    if any(r["local_bytes"] for r in res.values()):
        raise AssertionError(f"grid water: a K2c-G variant keeps local bytes: {res}")
    log(f"{tag} K2c-G resources at M={cfg.cells_per_dim} C={cfg.capacity}: {resources_line(res)}")

    mesh = make_grid_mesh((2, 2, 2), device=device)
    roll, energy = make_grid_sharded_sim(cfg, model, water.DT, mesh, **kw)
    sh = distribute_grid(st, cfg, mesh)
    roll(sh, num_steps=2 * WATER_REBIN, rebin_every=WATER_REBIN)  # warm-up
    _, sec, drift, counts = gate_rollout(
        "grid water (2,2,2)", roll, energy, sh, WATER_STEPS, WATER_REBIN,
        launches(cell_forces=WATER_STEPS + 4, rebin_window=3 * -(-WATER_STEPS // WATER_REBIN)),
        drift_gate=WATER_DRIFT_GATE,
    )
    bitwise_rerun("grid water (2,2,2)", roll, sh, 100, WATER_REBIN)
    no_host_waits("grid water (2,2,2)", lambda: roll(sh, num_steps=2 * WATER_REBIN, rebin_every=WATER_REBIN))
    ms = 1e3 * sec / WATER_STEPS
    log(f"{tag} grid water (2,2,2) (DSF + tags in K2c-G, bonds and angles as term rows): {WATER_STEPS} steps in "
        f"{sec:.3f} s = {ms:.4f} ms/step; NVE drift {drift:.3e} (gate {WATER_DRIFT_GATE}; no Kahan compensation on "
        f"the grid, the dense path's {dense_drift:.3e}); launches {counts}; reruns bitwise equal; no host waits; "
        "total forces of (1,1,1) and (2,2,2) bitwise equal")

    st_t, (roll_t, _) = fixtures.triatomic_sim(device, "torch")
    st_g, tcfg, tmodel = fixtures.triatomic_state(device)
    tmesh = make_grid_mesh((2, 2, 2), device=device)
    groll, _ = make_grid_sharded_sim(tcfg, tmodel, 1e-3, tmesh, **fixtures.triatomic_grid_kwargs(device))
    a = groll(distribute_grid(st_g, tcfg, tmesh), num_steps=20, rebin_every=5)
    b = roll_t(st_t, num_steps=20, rebin_every=5)
    nt = tcfg.num_atoms
    (pa, va), (pb, vb) = gather_grid_atoms(a, tcfg, nt, tmesh), gather_dense_atoms(b, nt)
    gap = (float(np.abs(pa - pb).max()), float(np.abs(va - vb).max()))
    if not max(gap) <= 2e-4 or bool(a.overflow) or bool(b.overflow):
        raise AssertionError(f"grid triatomic (2,2,2) vs the one-card 'torch' engine after 20 steps: {gap}")
    log(f"{tag} grid triatomic fixture (2,2,2) (bonded rows and leftover pairs, band 1) vs the one-card 'torch' "
        f"engine after 20 steps: max |dx| {gap[0]:.3e}, max |dv| {gap[1]:.3e} (gate 2e-4)")
    nccl_vs_local_mesh("grid triatomic (1,1,1)", tcfg, tmodel, 1e-3, st_g, fixtures.triatomic_grid_kwargs(device),
                       20, 5, device)
    log(f"{tag} grid triatomic (1,1,1) through a one-rank NCCL DistMesh (the term bindings' int32 psum through "
        "NCCL's all_reduce): 20 steps and the energies bitwise equal to LocalMesh")

    t = timing[(2, 2, 2)]
    e_tags = int(tabs[0].shape[-1])
    ns = cfg.num_slots
    pairs = mol_pairs(st, cfg, box["bonds"], box["box"])[0]
    # Bytes: the ghost grids (7 fields) in, the own slots' tags (12E) in, forces out.
    b_ms, b_by = bound(4 * 7 * t["ghost_slots"] + 12 * e_tags * ns + 12 * ns, mol_ops(pairs, 0, e_tags, False))
    row = {"max_abs_err": max(timing[s]["err"] for s in timing), "ms": t["ms"], "plain_ms": t["plain_ms"],
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "force_scale": t["scale"],
           "energy_err": max(timing[s]["err_e"] for s in timing), "energy_ms": t["energy_ms"],
           "n111_ms": timing[(1, 1, 1)]["ms"], "n111_energy_ms": timing[(1, 1, 1)]["energy_ms"],
           "force_pass_ms": t["pass_ms"], "grid_water_ms_per_step": ms, "grid_water_drift": drift,
           "triatomic_gap": max(gap), "pairs": pairs, "resources": res}
    return row, {"grid_water_222": counts}, ms


SLAB_FORCE_GATE = 2e-5  # full shell vs K2a's half shell, of the force scale (the kernels' gate)
DOMAIN_DRIFT_GATE = 1e-4  # relative NVE drift of the atom-table engine over 500 steps
DOMAIN_ROLLOUT_ATOL = 5e-4  # 40 steps vs all-pairs Verlet (tests/test_distributed.py:104)


def energy_f64(pos, box: float) -> float:
    """Total LJ energy (unit parameters, rc 2.5σ, switch 2.0σ) of `pos`
    (N, 3) in float64 on the card, all pairs, with the float64 oracle's
    minimum image and pair math (tests/oracle.py)."""
    x = pos.double() / box
    n = x.shape[0]
    rc2, rs2 = CUTOFF**2, SWITCH**2
    inv_d2 = 1.0 / (rc2 - rs2)
    total = torch.zeros((), dtype=torch.float64, device=pos.device)
    idx = torch.arange(n, device=pos.device)
    for lo in range(0, n, 2048):
        ds = x[lo : lo + 2048, None, :] - x[None, :, :]
        rv = box * (ds - torch.round(ds))
        r2 = (rv * rv).sum(-1)
        own = idx[lo : lo + 2048, None] == idx[None, :]
        r2 = torch.where(own, 1.0, r2)
        s6 = (1.0 / r2) ** 3
        e = 4.0 * s6 * (s6 - 1.0)
        t = torch.clamp((r2 - rs2) * inv_d2, 0.0, 1.0)
        g = 1.0 + t * t * t * (15.0 * t - 6.0 * t * t - 10.0)
        total = total + 0.5 * torch.where(own, 0.0, e * g).sum()
    return float(total)


def k2a_drift_f64(device, tag, cells: int = 14):
    """tests/test_fidelity.py's 1e-6 drift measurement on the card's K2a
    path (the dense component carry, uniform parameters): FCC 14³ = 10,976
    atoms at T* 0.7, skin 0.3, 300 settling steps at dt = 0.004 rebinning
    every 3, then 500 at dt = 0.002 rebinning every 4; energies in float64
    on the card (`energy_f64`).  A measurement: its gate is the `full`
    CPU tests'.  The window runs once in one call (the reference test's
    reading, one sample at each end), and then, from the same settled
    state, 2,000 steps in calls of 20, sampled after each: the statistic of
    tests/test_torch_cell_dense_sim.py::test_nve_drift_line_1e6_f64
    (`tools.drift.drift_line`: the least-squares line's rise over 500
    steps, the end-tenth means' difference, the std about the line).
    Returns (one-sample drift, end-tenth means, line rise, std), each a
    fraction of the settled state's KE."""
    from emdee_tpu_torch import (
        LennardJonesModel, cell_dense_init, detect_uniform_params, gather_dense_atoms, lennard_jones_atom,
        make_cell_dense_sim, suggest_cell_dense_config,
    )
    from emdee_tpu_torch.tools.drift import drift_line
    from emdee_tpu_torch.utils.lattice import fcc_lattice, maxwell_boltzmann

    pos, box = fcc_lattice(cells, density=DENSITY)
    n = len(pos)
    config = suggest_cell_dense_config(n, box, cutoff=CUTOFF, switch=SWITCH, skin=0.3)
    model = LennardJonesModel.create(CUTOFF, SWITCH, device=device)
    params = lennard_jones_atom(np.ones(n), np.ones(n), device=device)
    uni = detect_uniform_params(params)
    st = cell_dense_init(pos, maxwell_boltzmann(n, 0.7, seed=0), np.ones(n), params, config, device=device)
    settle, _ = make_cell_dense_sim(config, model, dt=0.004, uniform_params=uni, uniform_mass=1.0)
    st = settle(st, num_steps=300, rebin_every=3)
    run, _ = make_cell_dense_sim(config, model, dt=0.002, uniform_params=uni, uniform_mass=1.0)
    out = run(st, num_steps=500, rebin_every=4)
    if bool(st.overflow) or bool(out.overflow):
        raise AssertionError("K2a drift run: overflow")

    def e_f64(s):
        p, v = gather_dense_atoms(s, n)
        ke = 0.5 * float((torch.from_numpy(v).to(device).double() ** 2).sum())
        return energy_f64(torch.from_numpy(p).to(device), float(box)) + ke, ke

    (e0, ke0), (e1, _) = e_f64(st), e_f64(out)
    drift = abs(e1 - e0) / ke0
    window, every = 2000, 20
    series, s = [e0], st
    for _ in range(window // every):
        s = run(s, num_steps=every, rebin_every=4)
        series.append(e_f64(s)[0])
    if bool(s.overflow):
        raise AssertionError("K2a drift series: overflow")
    rise, ends, swing = drift_line(every * np.arange(len(series)), series, ke0)
    log(f"{tag} K2a path at {n} atoms (tests/test_fidelity.py:73): 500 NVE steps at dt=0.002 after 300 settling, "
        f"float64 energies on the card: drift {drift:.3e} of KE (one sample at each end); {window} steps in calls "
        f"of {every}, sampled after each: least-squares line's rise over 500 steps {rise:.3e}, end-tenth means "
        f"{ends:.3e}, std about the line {swing:.3e} (the CPU full-tier gate: |rise| <= 1e-6; here measured)")
    return drift, ends, rise, swing


def slab_dense_check(label, cfg, model, uni, mesh, st):
    """The slab dense engine's start on `st` over `mesh`: PE and virial
    within rtol 1e-5 of the dense energy closure on the same slots; the
    full-shell forces of the state drifted 0.45·skin within 2e-5 of the
    force scale of K2a's; the pass's time beside K2a's.  Returns (max
    |dF|, scale, pass ms, K2a ms)."""
    from emdee_tpu_torch import make_cell_dense_sim
    from emdee_tpu_torch.distributed.cell_dense_sharded import distribute_cell_dense, make_sharded_cell_dense_sim
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces_split

    roll, energy = make_sharded_cell_dense_sim(cfg, model, DT, mesh)
    _, d_energy = make_cell_dense_sim(cfg, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    for a, b, what in zip(energy(distribute_cell_dense(st, mesh)), d_energy(st), ("pe", "virial", "ke")):
        close(f"{label} {what} vs the dense energy closure", a, b, atol=0.0, rtol=1e-5)
    sd = drifted(st, SKIN)
    sh = distribute_cell_dense(sd, mesh)
    f = roll.forces(sh)[0]
    px, py, pz = (sd.positions[..., i].contiguous() for i in range(3))
    k2a = lambda: cell_forces_split(px, py, pz, sd.valid, cfg, uniform_params=uni, backend="cuda")  # noqa: E731
    ref = torch.stack(k2a(), dim=-1)
    v = sd.valid
    scale = max(float(ref[v].abs().max()), 1.0)
    err = close(f"{label} full-shell forces vs K2a", f[v], ref[v], atol=SLAB_FORCE_GATE * scale)
    return err, scale, cuda_ms(lambda: roll.forces(sh), 5), cuda_ms(k2a, 20)


def phase_slab_dense(device, tag, config, model, uni, pos_eq, vel_eq, params, k, shapes=(2, 4), steps=1000):
    """The slab dense engine (`distributed/cell_dense_sharded.py`, plain
    torch, every slab on this card) on the equilibrated melt at the grid's
    config (`reconfigure_dense_state(cells_multiple_of=2)`: M = 16, C = 40)
    on (D,1,1) for D in `shapes`: `slab_dense_check`, `steps` gated NVE
    steps rebinning every k (no flag, drift ≤ 3e-5, no kernel launched but
    the sort rebin's, once a rebin), bitwise reruns, no host waits.
    Returns ({path: ms/step}, {path: kernels a step}, the largest |dF| vs
    K2a over the force scale, {path: launch counts})."""
    from emdee_tpu_torch import cell_dense_init, reconfigure_dense_state
    from emdee_tpu_torch.distributed.cell_dense_sharded import distribute_cell_dense, make_sharded_cell_dense_sim
    from emdee_tpu_torch.distributed.mesh import make_mesh

    ms, kps, err, counts = {}, {}, 0.0, {}
    n = config.num_atoms
    st0 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, config, device=device)
    st, cfg = reconfigure_dense_state(st0, config, cells_multiple_of=2)
    if bool(st.overflow):
        raise AssertionError(f"slab config M={cfg.cells_per_dim}: overflow")
    for d in shapes:
        name, label = f"slab_dense_d{d}", f"slab dense ({d},1,1) M={cfg.cells_per_dim} C={cfg.capacity}"
        mesh = make_mesh(d, device=device)
        e, scale, pass_ms, k2a_ms = slab_dense_check(label, cfg, model, uni, mesh, st)
        err = max(err, e / scale)
        roll, energy = make_sharded_cell_dense_sim(cfg, model, DT, mesh)
        sh = distribute_cell_dense(st, mesh)
        roll(sh, num_steps=k, rebin_every=k)  # warm-up
        _, sec, drift, counts[name] = gate_rollout(label, roll, energy, sh, steps, k,
                                                   launches(sort_rebin=-(-steps // k)))
        bitwise_rerun(label, roll, sh, 2 * k, k)
        no_host_waits(label, lambda: roll(sh, num_steps=k, rebin_every=k))
        ms[name] = 1e3 * sec / steps
        kps[name] = kernels_per_step(lambda: roll(sh, num_steps=2 * k, rebin_every=k), 2 * k)
        log(f"{tag} {label} (LocalMesh, plain torch): {steps} steps in {sec:.3f} s = {ms[name]:.4f} ms/step, "
            f"{kps[name]} device kernels a step; NVE drift {drift:.3e}; no kernel launched but the sort rebin's, "
            f"one a rebin; full-shell pass {pass_ms:.3f} ms vs K2a {k2a_ms:.4f} ms, forces vs K2a max |dF| {e:.3e} (scale {scale:.3f}, gate "
            f"{SLAB_FORCE_GATE} of it); PE and virial vs the dense closure in rtol 1e-5; reruns bitwise equal; "
            "no host waits")
    return ms, kps, err, counts


def phase_domain(device, tag, model, cells=14, shapes=(2, 3), steps=500):
    """The atom-table slab engine (`distributed/domain.py`, plain torch,
    every slab on this card) on a jittered FCC `cells`³ (14³: 10,976
    atoms, box 23.5σ, T* 1.44) on (D,1,1) for D in `shapes`: energy and
    virial vs `compute_nonbonded_allpairs` (rtol 1e-5), 40 steps at dt =
    0.002 vs the portable `nve_rollout` on all-pairs (5e-4), then `steps`
    gated steps at dt = 0.005 resorting every 10 (no flag, drift ≤ 1e-4, no
    kernel launched), bitwise reruns, no host waits.  Returns ({path:
    ms/step}, {path: kernels a step})."""
    from emdee_tpu_torch import (
        NonbondedConfig, compute_nonbonded_allpairs, lennard_jones_atom, make_force_fn, make_state, nve_rollout,
    )
    from emdee_tpu_torch.distributed import domain
    from emdee_tpu_torch.distributed.mesh import make_mesh
    from emdee_tpu_torch.utils.lattice import fcc_lattice, maxwell_boltzmann

    ms, kps = {}, {}
    pos, box = fcc_lattice(cells, density=DENSITY)
    n = len(pos)
    pos = pos + np.random.default_rng(SEED_PORTABLE).uniform(-0.05, 0.05, pos.shape)
    vel = maxwell_boltzmann(n, 1.44, seed=SEED_PORTABLE)
    params = lennard_jones_atom(np.ones(n), np.ones(n), device=device)
    ap_out = compute_nonbonded_allpairs(torch.from_numpy(pos.astype(np.float32)).to(device), box, model, params)
    ap = make_force_fn(NonbondedConfig(cutoff=CUTOFF, switch=SWITCH, method="allpairs"), params, box, n,
                       device=device)
    ref, _, _ = nve_rollout(make_state(pos, vel, box=box, device=device), (), ap.force_fn, 0.002, 40)
    box_t = torch.full((), box, dtype=torch.float32, device=device)
    for d in shapes:
        name, label = f"domain_d{d}", f"domain ({d},1,1) N={n}"
        mesh = make_mesh(d, device=device)
        cfg = domain.suggest_domain_config(n, box, CUTOFF, d, resort_every=10)
        st = domain.distribute(pos, vel, np.ones(n), params, cfg, mesh)
        roll40, energy = domain_nve(domain, cfg, mesh, model, 0.002)
        pe, vir, _ = energy(st)
        close(f"{label} energy vs all-pairs", pe, ap_out.energies.sum(), atol=0.0, rtol=1e-5)
        close(f"{label} virial vs all-pairs", vir, ap_out.virials.sum(), atol=0.0, rtol=1e-5)
        out40 = roll40(st, num_steps=40, rebin_every=10)
        if bool(out40.overflow) or int(out40.step) != 40:
            raise AssertionError(f"{label}: 40 steps: overflow {bool(out40.overflow)}, step {int(out40.step)}")
        p40, v40 = domain.gather_dense(out40, n)
        dp = torch.from_numpy(p40).to(device) - ref.positions
        dp = dp - torch.round(dp / box_t) * box_t
        gap = max(float(dp.abs().max()), float((torch.from_numpy(v40).to(device) - ref.velocities).abs().max()))
        if not gap <= DOMAIN_ROLLOUT_ATOL:
            raise AssertionError(f"{label}: 40 steps differ from all-pairs Verlet by {gap:.3e}")
        roll, energy = domain_nve(domain, cfg, mesh, model, DT)
        roll(st, num_steps=10, rebin_every=10)  # warm-up
        _, sec, drift, _ = gate_rollout(label, roll, energy, st, steps, 10, launches(), drift_gate=DOMAIN_DRIFT_GATE)
        bitwise_rerun(label, roll, st, 20, 10)
        no_host_waits(label, lambda: roll(st, num_steps=10, rebin_every=10))
        ms[name] = 1e3 * sec / steps
        kps[name] = kernels_per_step(lambda: roll(st, num_steps=10, rebin_every=10), 10)
        log(f"{tag} {label} (LocalMesh, plain torch; S={cfg.slot_capacity}, H={cfg.halo_capacity}): {steps} steps "
            f"at dt={DT} in {sec:.3f} s = {ms[name]:.4f} ms/step, {kps[name]} device kernels a step; NVE drift "
            f"{drift:.3e}; no kernel launched; E and W vs all-pairs in rtol 1e-5; 40 steps at dt=0.002 vs all-pairs "
            f"Verlet max |d| {gap:.3e} (gate {DOMAIN_ROLLOUT_ATOL}); reruns bitwise equal; no host waits")
    return ms, kps


def domain_nve(domain, config, mesh, model, dt):
    """The atom-table engine's (rollout, energy) in the dense engine's
    shape for `gate_rollout` and `bitwise_rerun`: rollout(state, num_steps,
    rebin_every) runs num_steps / resort_every blocks (rebin_every must be
    the config's resort_every); energy(state) → (pe, virial, ke)."""
    roll, energy_fn = domain.make_sharded_step(config, mesh, model, dt)

    def rollout(state, num_steps, rebin_every):
        if rebin_every != config.resort_every or num_steps % rebin_every:
            raise ValueError(f"{num_steps} steps in blocks of {config.resort_every}")
        return roll(state, num_blocks=num_steps // rebin_every)

    def energy(state):
        ke = 0.5 * torch.sum(torch.where(state.valid[:, None], state.masses[:, None] * state.velocities**2, 0.0))
        return (*energy_fn(state), ke)

    return rollout, energy


def phase_molecular_fixtures(device, tag):
    """K2c vs plain on the 864-atom charged fixture; the triatomic fixture
    of tests/test_grid_sharded_pallas.py:36-104 (375 atoms, band 1: leftover
    pairs, shared and exclusive terms) on 'cuda', rerun bitwise and held
    against 'torch' (both fixtures from `tools/fixtures.py`).  Returns the
    fixture's K2c row fields: its max |dF|, force scale, relative error and
    max energy or virial error."""
    from emdee_tpu_torch import gather_dense_atoms
    from emdee_tpu_torch.tools import fixtures

    st, config, model, coul, tags = fixtures.charged_fixture(device)
    err, scale, err_e, err_w = check_mol_kernel(st, config, model, coul, tags, "864 fixture")
    log(f"{tag} K2c vs plain, 864-atom charged fixture (drifted): max |dF| {err:.3e} (rel {err / scale:.3e}, "
        f"scale {scale:.1f}), max |dE| {err_e:.3e}, max |dW| {err_w:.3e}; empty slots exactly 0")
    row = {"mol_fixture_max_abs_err": err, "mol_fixture_force_scale": scale, "mol_fixture_rel_err": err / scale,
           "mol_fixture_energy_err": max(err_e, err_w)}

    st, (roll_k, _) = fixtures.triatomic_sim(device, "cuda")
    _, (roll_t, _) = fixtures.triatomic_sim(device, "torch")
    sims = {"cuda": roll_k, "torch": roll_t}
    n = int(st.valid.sum())
    bitwise_rerun("triatomic fixture", roll_k, st, 20, 5)
    outs = {b: sims[b](st, num_steps=20, rebin_every=5) for b in sims}
    (pk, vk), (pt, vt) = (gather_dense_atoms(outs[b], n) for b in ("cuda", "torch"))
    dp, dv = float(np.abs(pk - pt).max()), float(np.abs(vk - vt).max())
    if not (dp <= 2e-3 and dv <= 5e-2) or any(bool(o.overflow) for o in outs.values()):
        raise AssertionError(f"triatomic 'cuda' vs 'torch': positions {dp:.3e}, velocities {dv:.3e}")
    log(f"{tag} triatomic fixture ({n} atoms, band 1: leftover pairs, shared terms by the fixed-order add, "
        f"exclusive angles by scatter-set) on 'cuda': two 20-step rollouts bitwise equal; vs 'torch' max |dx| "
        f"{dp:.3e}, max |dv| {dv:.3e}")
    return row


def phase_gather_pass(device, tag, sconfig, model, uni, pos_eq, vel_eq, params, k):
    """The straggler engine's gather pass (strag_pass="xla") on the card:
    its reactions go through the fixed-order add, so two rollouts are
    bitwise equal."""
    from emdee_tpu_torch import make_straggler_sim, straggler_init

    n = sconfig.grid.num_atoms
    roll, _ = make_straggler_sim(sconfig, model, dt=DT, uniform_params=uni, uniform_mass=1.0, strag_pass="xla")
    s0 = straggler_init(pos_eq, vel_eq, np.ones(n), params, sconfig, device=device)
    t0 = time.perf_counter()
    bitwise_rerun("straggler gather pass", roll, s0, 100, k)
    log(f"{tag} straggler gather pass (strag_pass='xla', reactions by the fixed-order add): two 100-step rollouts "
        f"bitwise equal ({time.perf_counter() - t0:.2f} s for both)")


# ---------------------------------------------------------------------------
# The portable engine: State, all-pairs, the neighbor list, make_force_fn
# and the dynamics of emdee_tpu_torch/dynamics (plain torch ops, no kernel)
# ---------------------------------------------------------------------------

PORTABLE_DRIFT_GATE = 1e-4  # relative NVE drift, the bound of tests/test_verlet.py:39
PORTABLE_FORCE_RTOL, PORTABLE_FORCE_ATOL = 1e-4, 5e-4  # vs K2b (tests/test_cell_dense.py:55-57)
ALLPAIRS_ATOL = 2e-4  # all-pairs vs the list (tests/test_coulomb.py:96-99)
PORTABLE_SKIN = 0.3  # README's portable example: NonbondedConfig(cutoff=2.5, switch=2.0, skin=0.3)
SEED_PORTABLE = 13  # thermostat generators and the 10,976-atom lattice's jitter


def host_syncs(fn):
    """(fn's result, the host waits it made): every call that waits for the
    device warns under `set_sync_debug_mode("warn")`, and the warnings are
    counted."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, sum(str(w.message).startswith("called a synchronizing CUDA operation") for w in caught)


def box_following_force_fn(nbc, model, params, cells_per_dim, cell_capacity, max_neighbors):
    """A neighbor-list force function for a moving box, from the port's
    primitives: the rebuild check, the rebuild and the pair pass each at
    the box it is given.  The cell grid keeps the first box's M, which
    covers the list cutoff while the box grows."""
    from emdee_tpu_torch.core.types import FORCES
    from emdee_tpu_torch.neighbors import api
    from emdee_tpu_torch.neighbors.neighbor_force import compute_nonbonded_neighborlist
    from emdee_tpu_torch.neighbors.neighbor_list import build_neighbor_list, needs_rebuild

    list_cutoff, skin = nbc.cutoff + nbc.effective_skin, nbc.effective_skin

    def force_fn(p, box_, nbrs):
        if bool(needs_rebuild(nbrs, p, box_, skin)):
            api.REBUILDS += 1
            new = build_neighbor_list(p, box_, list_cutoff, cells_per_dim=cells_per_dim, cell_capacity=cell_capacity,
                                      max_neighbors=max_neighbors)
            nbrs = new._replace(overflow=new.overflow | nbrs.overflow)
        return compute_nonbonded_neighborlist(p, box_, model, params, nbrs, outputs=FORCES).forces, nbrs

    return force_fn


def thermostat_blocks(label, block, st, aux, blocks=10):
    """Run `blocks` blocks of `block(st, aux) → (st, aux)`; gate the mean
    T* of the last half within T_GATE of T_NVT.  Returns (st, aux, T* per
    block, seconds)."""
    from emdee_tpu_torch.dynamics.observables import temperature

    temps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(blocks):
        st, aux = block(st, aux)
        temps.append(float(temperature(st)))
    seconds = time.perf_counter() - t0
    t_last = float(np.mean(temps[blocks // 2:]))
    if not abs(t_last / T_NVT - 1.0) <= T_GATE:
        raise AssertionError(f"{label}: mean T* of the last {blocks // 2} blocks {t_last:.4f}, target {T_NVT}")
    if bool(aux.overflow):
        raise AssertionError(f"{label}: neighbor-list overflow")
    return st, aux, temps, seconds


def phase_portable(device, tag, pos_eq, vel_eq, st0, config, model):
    """The portable engine on the card, after the main path's equilibration
    and from its positions and velocities (97,556 atoms):
    1. `make_force_fn` at the README example's config ('auto' must resolve to
       the neighbor list): forces, energies and virials against the dense
       engine's K2b per-atom pass at the same positions, by atom id;
    2. `nve_rollout`, 1,000 steps with a record every 100: drift and
       overflow gates, one host read a step (the rebuild flag: `update`'s
       counter and the card's sync warnings agree), no kernel launched,
       bitwise reruns;
    3. CSVR and Langevin, ten blocks of 100 (mean T* of the last five
       within 2%), then Berendsen NPT on the CSVR step, 200 steps, on a
       list that follows the box (`make_force_fn` binds its box: fault
       R10, measured at the end box): the pressure gap shrinks, the box
       moves the way the pressure says, the list's virial at the end box
       matches all-pairs';
    4. on a jittered FCC 14³ (10,976 atoms): all-pairs against the list, LJ
       and DSF, and FIRE's 1,000 steps;
    5. `apply_exclusion_corrections` on the 864-atom charged fixture: reruns
       bitwise, and the CPU's result within the force tolerance.
    Returns the numbers it prints."""
    from emdee_tpu_torch import (
        FireConfig, NonbondedConfig, csvr_rollout, fire_minimize, lennard_jones_atom, make_force_fn, make_state,
        npt_rollout, nve_rollout, nvt_rollout,
    )
    from emdee_tpu_torch.core.types import ENERGIES, VIRIALS, NonbondedOutput
    from emdee_tpu_torch.dynamics.bussi import bussi_step
    from emdee_tpu_torch.dynamics.npt import instantaneous_pressure
    from emdee_tpu_torch.dynamics.observables import energy_drift, kinetic_energy
    from emdee_tpu_torch.neighbors import api
    from emdee_tpu_torch.neighbors.allpairs import compute_nonbonded_allpairs
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces
    from emdee_tpu_torch.neighbors.neighbor_force import apply_exclusion_corrections, compute_nonbonded_neighborlist
    from emdee_tpu_torch.potentials.coulomb import DSFCoulomb
    from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel
    from emdee_tpu_torch.tools.fixtures import charged_arrays
    from emdee_tpu_torch.utils.lattice import fcc_lattice

    t_phase = time.perf_counter()
    facts = {}
    n, box = len(pos_eq), config.box
    nbc = NonbondedConfig(cutoff=CUTOFF, switch=SWITCH, skin=PORTABLE_SKIN)
    if api.resolve_method(nbc, box, n) != "neighbor_list":
        raise AssertionError(f"portable: 'auto' does not resolve to the neighbor list at {n} atoms")
    params = lennard_jones_atom(np.ones(n), np.ones(n), device=device)
    nb = make_force_fn(nbc, params, box, n, device=device)
    state = make_state(pos_eq, vel_eq, box=box, device=device)

    # ---- 1. forces at full width against K2b ----
    torch.cuda.reset_peak_memory_stats(device)
    aux = nb.init(state.positions)
    out = nb.compute(state.positions, aux)
    torch.cuda.synchronize()
    facts["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    fk, ek, wk = cell_forces(st0, model, config, compute_energy=True, backend="cuda")
    errs = [close(f"portable {name} vs K2b", got, by_atom(st0, want, n), atol=PORTABLE_FORCE_ATOL,
                  rtol=PORTABLE_FORCE_RTOL)
            for name, got, want in (("forces", out.forces, fk), ("energies", out.energies, ek),
                                    ("virials", out.virials, wk))]
    m = nbc.list_geometry(box)[1]
    facts.update(k=aux.max_neighbors, cell_capacity=aux.cell_capacity, m=m, vs_k2b=errs)
    log(f"{tag} portable: make_force_fn('auto') -> neighbor_list at {n} atoms: K={aux.max_neighbors}, cell "
        f"capacity {aux.cell_capacity}, M={m}; forces/energies/virials vs K2b by atom max |d| "
        + ", ".join(f"{e:.3e}" for e in errs) + f" (rtol {PORTABLE_FORCE_RTOL}, atol {PORTABLE_FORCE_ATOL}); "
        f"peak allocation {facts['peak_gb']:.3f} GB over init + compute")

    # ---- 2. NVE ----
    def energy_fn(p, a):
        o = nb.compute(p, a, outputs=ENERGIES | VIRIALS)
        return torch.sum(o.energies), torch.sum(o.virials)

    steps = 1000
    e0 = energy_fn(state.positions, aux)[0] + kinetic_energy(state)
    zero_counts()
    api.HOST_READS = api.REBUILDS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, aux1, traj = nve_rollout(state, aux, nb.force_fn, DT, steps, record_every=100, energy_fn=energy_fn)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    reads, rebuilds = api.HOST_READS, api.REBUILDS
    launched = read_counts()
    drift = float(energy_drift(torch.cat([e0[None], traj.potential_energy + traj.kinetic_energy])))
    if bool(aux1.overflow):
        raise AssertionError("portable NVE: neighbor-list overflow")
    if not drift <= PORTABLE_DRIFT_GATE:
        raise AssertionError(f"portable NVE: drift {drift:.3e} > {PORTABLE_DRIFT_GATE}")
    if reads != steps + 1 or rebuilds < 1:
        raise AssertionError(f"portable NVE: {reads} host reads, {rebuilds} rebuilds in {steps} steps")
    if launched != launches():
        raise AssertionError(f"portable NVE launched port kernels: {launched}")
    facts.update(nve_ms=1e3 * sec / steps, rebuilds=rebuilds, reads_per_step=reads / steps, drift=drift)
    log(f"{tag} portable NVE ({steps} steps, dt {DT}, records every 100): {sec:.3f} s = {facts['nve_ms']:.4f} "
        f"ms/step, {n * steps / sec:,.0f} atom-steps/s; drift {drift:.3e}; {rebuilds} rebuilds; {reads} host reads "
        f"({reads / steps:.3f} a step); overflow False; no port kernel launched")

    rerun = lambda: nve_rollout(state, aux, nb.force_fn, DT, 100)  # noqa: E731
    api.HOST_READS = 0
    (a, a_aux, _), syncs = host_syncs(rerun)
    if syncs != api.HOST_READS or syncs != 101:
        raise AssertionError(f"portable NVE rerun: {syncs} host waits on the card, {api.HOST_READS} rebuild-flag "
                             "reads, expected 101 each")
    b, b_aux, _ = rerun()
    same_fields("portable NVE rerun", [a.positions, a.velocities, a.box, a.step, a_aux.idx, a_aux.overflow],
                [b.positions, b.velocities, b.box, b.step, b_aux.idx, b_aux.overflow])
    log(f"{tag} portable NVE: two 100-step reruns bitwise equal; the card's sync warnings count {syncs} host "
        "waits, all of them the rebuild flag's reads")

    # ---- 3. thermostats and the barostat ----
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)  # noqa: E731
    csvr, aux_c, temps_c, sec_c = thermostat_blocks(
        "portable CSVR", lambda s, x: csvr_rollout(s, x, nb.force_fn, DT, TAU_T, T_NVT, 100),
        final._replace(rng=gen(SEED_PORTABLE)), aux1)
    _, _, temps_l, sec_l = thermostat_blocks(
        "portable Langevin", lambda s, x: nvt_rollout(s, x, nb.force_fn, DT, FRICTION, T_NVT, 100)[:2],
        final._replace(rng=gen(SEED_PORTABLE + 1)), aux1)
    facts.update(csvr_ms=sec_c, langevin_ms=sec_l, csvr_t=temps_c, langevin_t=temps_l)  # 1,000 steps: s = ms/step
    log(f"{tag} portable CSVR (T*={T_NVT}, tau={TAU_T}): 1,000 steps in {sec_c:.3f} s, T* by block "
        f"{', '.join(f'{t:.4f}' for t in temps_c)}; Langevin (friction {FRICTION}): 1,000 steps in {sec_l:.3f} s, T* "
        + ", ".join(f"{t:.4f}" for t in temps_l))

    # The bundle binds its box when made (ROADMAP fault R10): under NPT its
    # list stays on the first box's geometry.  The barostat runs on a list
    # force function that takes the box it is given everywhere.
    moving = box_following_force_fn(nbc, nb.model, params, m, aux.cell_capacity, aux.max_neighbors)

    def virial_fn(p, b_, a_):
        return torch.sum(compute_nonbonded_neighborlist(p, b_, nb.model, params, a_, outputs=VIRIALS).virials)

    thermo = lambda s, f, a_, ffn, dt: bussi_step(s, f, a_, ffn, dt, TAU_T, T_NVT)  # noqa: E731
    p0 = float(instantaneous_pressure(csvr, virial_fn(csvr.positions, csvr.box, aux_c)))
    api.REBUILDS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    npt, aux_p, boxes = npt_rollout(csvr, aux_c, moving, virial_fn, DT, TAU_P, P_NPT, 200, kappa=KAPPA,
                                    thermostat_step=thermo)
    torch.cuda.synchronize()
    sec_p = time.perf_counter() - t0
    p1 = float(instantaneous_pressure(npt, virial_fn(npt.positions, npt.box, aux_p)))
    box0, box1 = float(csvr.box), float(npt.box)
    if not abs(p1 - P_NPT) < abs(p0 - P_NPT):
        raise AssertionError(f"portable NPT: P* {p0:.4f} -> {p1:.4f}, target {P_NPT}")
    if np.sign(box1 - box0) != np.sign(p0 - P_NPT) or not float(boxes.min()) >= box0:
        raise AssertionError(f"portable NPT: box {box0:.4f} -> {box1:.4f} at P* {p0:.4f}, target {P_NPT}")
    if not bool(torch.isfinite(boxes).all()) or bool(aux_p.overflow):
        raise AssertionError("portable NPT: non-finite box or neighbor-list overflow")
    w_list = float(virial_fn(npt.positions, npt.box, aux_p))
    w_all = float(torch.sum(compute_nonbonded_allpairs(npt.positions, npt.box, nb.model, params, outputs=VIRIALS,
                                                       row_chunk=1024).virials))
    if not abs(w_list / w_all - 1) <= PORTABLE_FORCE_RTOL:
        raise AssertionError(f"portable NPT: the list's virial {w_list:.3f} vs all-pairs' {w_all:.3f} at the final box")
    # Fault R10, measured: the bundle's own force_fn at the final box, its
    # list rebuilt on the first box's geometry.
    f_r10, nbrs_r10 = nb.force_fn(npt.positions, npt.box, aux_c)
    r10_err = float((f_r10 - moving(npt.positions, npt.box, aux_p)[0]).abs().max())
    facts.update(npt_ms=1e3 * sec_p / 200, p0=p0, p1=p1, box0=box0, box1=box1, npt_virial_rel=abs(w_list / w_all - 1),
                 r10_overflow=bool(nbrs_r10.overflow), r10_max_abs_err=r10_err)
    log(f"{tag} portable NPT (P*={P_NPT}, tau_P={TAU_P}, kappa {KAPPA}, CSVR step; the list at the box it is given): "
        f"200 steps {facts['npt_ms']:.4f} ms/step, {api.REBUILDS} rebuilds; P* {p0:.4f} -> {p1:.4f}; box {box0:.4f} -> "
        f"{box1:.4f} ({100 * (box1 / box0 - 1):+.2f}%); virial at the final box vs all-pairs' rel "
        f"{facts['npt_virial_rel']:.3e}. Fault R10 (make_force_fn's force_fn, its list on the first box's geometry) at "
        f"the final box: overflow {facts['r10_overflow']}, max |dF| {r10_err:.3e} against the list above")

    # ---- 4. all-pairs and FIRE at 10,976 atoms ----
    pos, box_s = fcc_lattice(14, density=DENSITY)
    n_s = len(pos)
    pos = pos + np.random.default_rng(SEED_PORTABLE).uniform(-0.05, 0.05, pos.shape)
    q = np.where(np.arange(n_s) % 2 == 0, 0.4, -0.4)
    params_s = lennard_jones_atom(np.ones(n_s), np.ones(n_s), device=device)
    x = torch.from_numpy(pos.astype(np.float32)).to(device)
    ap_ms = {}
    for label, charges in (("LJ", None), ("LJ+DSF", q)):
        kw = dict(cutoff=CUTOFF, switch=SWITCH, coulomb_alpha=0.25, coulomb_constant=1.0)
        ap = make_force_fn(NonbondedConfig(method="allpairs", **kw), params_s, box_s, n_s, charges=charges,
                           device=device)
        nl = make_force_fn(NonbondedConfig(method="neighbor_list", skin=PORTABLE_SKIN, **kw), params_s, box_s, n_s,
                           charges=charges, device=device)
        ref, got = ap.compute(x, ()), nl.compute(x, nl.init(x))
        for name in ("forces", "energies", "virials"):
            close(f"portable all-pairs vs list {label} {name}", getattr(ref, name), getattr(got, name),
                  atol=ALLPAIRS_ATOL, rtol=1e-4)
        ap_ms[label] = cuda_ms(lambda: ap.compute(x, ()), 5)
    facts["allpairs_ms"] = ap_ms
    nb_s = make_force_fn(NonbondedConfig(cutoff=CUTOFF, switch=SWITCH, skin=PORTABLE_SKIN), params_s, box_s, n_s,
                         device=device)
    st_s = make_state(pos, box=box_s, device=device)
    aux_s = nb_s.init(st_s.positions)
    f0 = float(nb_s.force_fn(st_s.positions, st_s.box, aux_s)[0].abs().max())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    relaxed, aux_s, hist = fire_minimize(st_s, aux_s, nb_s.force_fn, 1000, FireConfig(dt_start=0.001, dt_max=0.008))
    torch.cuda.synchronize()
    sec_f = time.perf_counter() - t0
    f1 = float(nb_s.force_fn(relaxed.positions, relaxed.box, aux_s)[0].abs().max())
    if not f1 < 0.02 * f0:
        raise AssertionError(f"portable FIRE: max |F| {f0:.4f} -> {f1:.4f}, not below 2% of the start")
    facts.update(fire_ms=1e3 * sec_f / 1000, fire_f0=f0, fire_f1=f1)
    log(f"{tag} portable at {n_s} atoms (jittered FCC 14^3): all-pairs vs the list within rtol 1e-4, atol "
        f"{ALLPAIRS_ATOL} (LJ and DSF alpha 0.25, q = +-0.4); all-pairs {ap_ms['LJ']:.3f} ms a call (LJ), "
        f"{ap_ms['LJ+DSF']:.3f} (LJ+DSF); FIRE 1,000 steps {facts['fire_ms']:.4f} ms/step, max |F| {f0:.4f} -> "
        f"{f1:.3e}")

    # ---- 5. exclusion corrections on the 864-atom charged fixture ----
    fx = charged_arrays()
    n_c = fx["n"]

    def corrections(dev):
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        zero = NonbondedOutput(t(np.zeros((n_c, 3), np.float32)), t(np.zeros(n_c, np.float32)),
                               t(np.zeros(n_c, np.float32)))
        return apply_exclusion_corrections(
            zero, t(fx["pos"].astype(np.float32)), fx["box"], LennardJonesModel.create(CUTOFF, SWITCH, device=dev),
            lennard_jones_atom(np.ones(n_c), np.ones(n_c), device=dev), t(fx["pairs"]), t(fx["ljs"]), t(fx["q"]),
            DSFCoulomb.create(CUTOFF, alpha=0.25, coulomb_constant=1.0, device=dev), t(fx["cs"]))

    a, b, on_cpu = corrections(device), corrections(device), corrections(torch.device("cpu"))
    same_fields("portable exclusion corrections rerun", list(a), list(b))
    err_c = max(close(f"portable exclusion corrections {name} vs the CPU", getattr(a, name).cpu(),
                      getattr(on_cpu, name), atol=PORTABLE_FORCE_ATOL, rtol=PORTABLE_FORCE_RTOL)
                for name in ("forces", "energies", "virials"))
    facts["corrections_vs_cpu"] = err_c
    log(f"{tag} portable apply_exclusion_corrections ({n_c}-atom charged fixture, {len(fx['pairs'])} pairs): reruns "
        f"bitwise equal on the card; vs the CPU max |d| {err_c:.3e}")
    log(f"{tag} portable phase: {time.perf_counter() - t_phase:.1f} s")
    return facts


def main() -> None:
    parser = argparse.ArgumentParser(description="Smoke test of emdee_tpu_torch on one CUDA card.")
    parser.add_argument("--save-spill-flag", metavar="FILE",
                        help="save the spill state whose next rebin raises the flag at the suggested capacity")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA device")
    t_start = time.perf_counter()
    smi = card()
    tag = f"[{smi}]"
    log(smi)
    log(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    from emdee_tpu_torch.csrc import build

    t0 = time.perf_counter()
    build.load()
    log(f"{tag} build: kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({build.library_path().name})")

    force = phase_forces(device, tag)
    rebin = phase_rebin(device, tag)
    k6 = phase_rebin_window(device, tag)
    k5_97k, k2_97k = phase_streaming(device, tag)

    # ---- main path: bench.py's wide config, component carry ----
    from emdee_tpu_torch import cell_dense_init, make_cell_dense_sim, resolve_dense_backend

    state, config, model, params, uni, n = melt(device)
    if resolve_dense_backend(config, "auto", device=device) != "cuda":
        raise AssertionError("the 97,556-atom melt no longer resolves to the resident kernel family")
    rollout, energy = make_cell_dense_sim(config, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    pos_eq, vel_eq, t_eq, k = equilibrate(rollout, state, config, n)
    st0 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, config, device=device)
    if bool(st0.overflow):
        raise AssertionError("re-init overflow at wide capacity")
    log(f"equilibrated 200 steps: T* = {t_eq:.4f}, rebin every {k} steps, M={config.cells_per_dim} C={config.capacity}")

    steps = 1000
    n_rebins = -(-steps // k)
    out, sec, drift, main_counts = gate_rollout(
        "main path", rollout, energy, st0, steps, k,
        launches(cell_forces=steps + 2 + 2, rebin_routing=n_rebins),
    )
    main_ms = 1e3 * sec / steps
    log(f"{tag} main path (component carry, uniform params): {steps} steps in {sec:.3f} s = "
        f"{main_ms:.4f} ms/step, {n * steps / sec:,.0f} atom-steps/s; NVE drift {drift:.3e}; "
        f"launches {main_counts}")
    bitwise_rerun("main path", rollout, st0, 100, k)
    log("main path: two 100-step rollouts bitwise equal")

    # ---- the README path: stacked per-atom leapfrog ----
    roll_s, energy_s = make_cell_dense_sim(config, model, dt=DT)
    steps_s = 200
    _, sec_s, drift_s, counts_s = gate_rollout(
        "README path", roll_s, energy_s, st0, steps_s, k,
        launches(cell_forces=steps_s + 2 + 2, rebin_routing=-(-steps_s // k)),
    )
    bitwise_rerun("README path", roll_s, st0, 100, k)
    log(f"{tag} README path (stacked, per-atom params): {steps_s} steps, "
        f"{1e3 * sec_s / steps_s:.4f} ms/step; NVE drift {drift_s:.3e}; launches {counts_s}; "
        "reruns bitwise equal")

    # ---- the plain path at the same size ----
    roll_p, _ = make_cell_dense_sim(config, model, dt=DT, backend="torch", uniform_params=uni, uniform_mass=1.0)
    roll_p(st0, num_steps=k, rebin_every=k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = roll_p(st0, num_steps=50, rebin_every=k)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0) / 50
    if bool(out_p.overflow):
        raise AssertionError("plain path: overflow")
    log(f"{tag} timings at {n} atoms: kernel path {main_ms:.4f} ms/step "
        f"({n * 1e3 / main_ms:,.0f} atom-steps/s); plain path {plain_ms:.3f} ms/step "
        f"({n * 1e3 / plain_ms:,.0f} atom-steps/s)")

    # ---- the portable engine from the equilibrated melt ----
    portable = phase_portable(device, tag, pos_eq, vel_eq, st0, config, model)
    log(f"{smi}: portable neighbor-list NVE at {n} atoms {portable['nve_ms']:.4f} ms/step, drift "
        f"{portable['drift']:.3e}, {portable['rebuilds']} rebuilds, {portable['reads_per_step']:.3f} host reads a "
        f"step; all-pairs at 10,976 atoms {portable['allpairs_ms']['LJ']:.3f} ms a call; peak allocation "
        f"{portable['peak_gb']:.3f} GB")

    # ---- the spill mode (K7), NVT and NPT on the same melt ----
    seam_err = phase_seam(device, tag, model, uni)
    spill_st, scfg, spill_err = phase_spill_init(device, tag, pos_eq, vel_eq, params, model, uni, config)
    force["max_abs_err"] = max(force["max_abs_err"], seam_err, spill_err)
    k7 = phase_compact(device, tag, spill_st, scfg)
    counts_spill, spill_ms = phase_spill_path(tag, spill_st, scfg, model, uni, k, main_ms,
                                              args.save_spill_flag)
    counts_thermo, thermo_ms = phase_nvt_npt(device, tag, config, spill_st, scfg, model, pos_eq, vel_eq,
                                             params, main_ms)
    log(f"{smi}: ms/step at {n} atoms — dense main path {main_ms:.4f}, spill {spill_ms:.4f}, "
        + ", ".join(f"{p} {v:.4f}" for p, v in thermo_ms.items()))

    # ---- K3: bench.py's production straggler config, and a stressed one ----
    production = straggler_config(config, 4, 64, 16)
    k3 = phase_straggler_kernel(device, tag, "production", production, pos_eq, vel_eq, params, model, uni, n)
    k3s = phase_straggler_kernel(device, tag, "stressed", straggler_config(config, 6, 256, 32),
                                 pos_eq, vel_eq, params, model, uni, n)
    force["max_abs_err"] = max(force["max_abs_err"], k3["wide_force_err"], k3s["wide_force_err"])

    # ---- the straggler path: bench.py's production engine ----
    from emdee_tpu_torch import make_straggler_sim, straggler_init

    s_roll, s_energy = make_straggler_sim(production, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    s0 = straggler_init(pos_eq, vel_eq, np.ones(n), params, production, device=device)
    nc = production.grid.num_cells
    parked0 = int((s0.aux_cell < nc).sum())
    if bool(s0.grid.overflow):
        raise AssertionError("straggler init overflow")
    s_roll(s0, num_steps=2 * k, rebin_every=k)  # warm-up
    s_out, s_sec, s_drift, s_counts = gate_rollout(
        "straggler path", s_roll, s_energy, s0, steps, k,
        launches(cell_forces=steps + 2 + 2, rebin_routing=n_rebins, straggler_aux=steps + 2),
    )
    parked1 = int((s_out.aux_cell < nc).sum())
    if parked1 < 1:
        raise AssertionError("straggler path: no parked aux atom at the end")
    bitwise_rerun("straggler path", s_roll, s0, 100, k)
    s_ms = 1e3 * s_sec / steps
    log(f"{tag} straggler path (C_t={production.grid.capacity} C_w={production.wide_capacity} "
        f"A={production.aux_capacity} Kn={production.kn}): {steps} steps in {s_sec:.3f} s = {s_ms:.4f} ms/step, "
        f"{n * steps / s_sec:,.0f} atom-steps/s; NVE drift {s_drift:.3e}; parked {parked0} -> {parked1}; "
        f"launches {s_counts}; two 100-step rollouts bitwise equal")
    log(f"{smi}: straggler path {s_ms:.4f} ms/step ({n * 1e3 / s_ms:,.0f} atom-steps/s) vs "
        f"dense main path {main_ms:.4f} ms/step ({n * 1e3 / main_ms:,.0f} atom-steps/s)")
    phase_gather_pass(device, tag, production, model, uni, pos_eq, vel_eq, params, k)

    # ---- F1: the melt at M = 12, C = 104 on the streaming family ----
    c104_row, counts_c104, c104_ms = phase_streaming_c104(device, tag, config, model, params, uni, pos_eq, vel_eq, k)

    # ---- the molecular dense engine: K2c, the triatomic fixture, the water box ----
    mol_fixture_row = phase_molecular_fixtures(device, tag)
    k5c_row = phase_k5c_fixture(device, tag)
    mol_row, counts_water, water_ms, water_facts, w = phase_water(device, tag)
    log(f"{smi}: water path {water_ms:.4f} ms/step ({98_304 * 1e3 / water_ms:,.0f} atom-steps/s) on "
        f"{water_facts['config']}, NVE drift {water_facts['drift']:.3e}, T {water_facts['t_eq']:.1f} K; "
        f"spill config holds: {water_facts['spill_holds']}")
    counts_modelling, modelling = phase_modelling(device, tag)
    water_auto_row, counts_auto, auto_ms, auto_drift = phase_water_auto(device, tag, w)
    k5c_row.update(water_auto_row)
    k5c_row.update(phase_water_c104(device, tag, w))
    ghost_mol_row, counts_grid_water, grid_water_ms = phase_grid_water(device, tag, w, auto_drift)
    del w
    log(f"{smi}: water ms/step at 98,304 atoms — 'cuda' (K2c) {water_ms:.4f}, 'auto' (K5c) {auto_ms:.4f}, "
        f"grid (2,2,2) (K2c-G) {grid_water_ms:.4f}")

    # ---- the grid-sharded engine (virtual shards on this card) ----
    counts_grid, grid_ms, grid_err, k2g_rows, grid_kps = phase_grid(device, tag, config, model, uni, pos_eq, vel_eq,
                                                                    params, k, main_ms)
    force["max_abs_err"] = max(force["max_abs_err"], grid_err)
    counts_ens, ens_ms = phase_grid_ensembles(device, tag, config, model, uni, pos_eq, vel_eq, params)
    log(f"{smi}: grid ensembles ms/step at {n} atoms, (2,2,2) M=16: "
        + ", ".join(f"{p} {v:.4f}" for p, v in ens_ms.items()))
    k7g, k7g_grid, counts_grid_spill, grid_spill_ms = phase_grid_spill(device, tag, spill_st, scfg, model, uni, params,
                                                                       grid_ms, grid_kps)
    log(f"{smi}: grid spill ms/step at {n} atoms (M={scfg.cells_per_dim} C=40 target {scfg.spill_target}): "
        + ", ".join(f"{p} {v:.4f}" for p, v in grid_spill_ms.items()))
    del spill_st

    # ---- the 1-D slab engines (plain torch) and the K2a path's 1e-6 drift measurement ----
    t0 = time.perf_counter()
    slab_ms, slab_kps, slab_err, counts_slab = phase_slab_dense(device, tag, config, model, uni, pos_eq, vel_eq,
                                                                 params, k)
    domain_ms, domain_kps = phase_domain(device, tag, model)
    slab_ms, slab_kps = {**slab_ms, **domain_ms}, {**slab_kps, **domain_kps}
    k2a_drift, k2a_ends, k2a_line, k2a_swing = k2a_drift_f64(device, tag)
    log(f"{tag} slab phases and the drift measurement: {time.perf_counter() - t0:.1f} s")
    log(f"{smi}: slab engines ms/step " + ", ".join(f"{p} {v:.4f} ({slab_kps[p]} kernels a step)"
                                                   for p, v in slab_ms.items())
        + f"; K2a path's NVE drift at 10,976 atoms {k2a_drift:.3e} of KE (float64 energies, one sample at "
        f"each end; over 2,000 steps: line's rise over 500 {k2a_line:.3e}, end-tenth means {k2a_ends:.3e}, "
        f"std about the line {k2a_swing:.3e})")

    # ---- parts 1 to 6 of the multi-device dry run on one NCCL rank ----
    from emdee_tpu_torch.distributed import dryrun

    t0 = time.perf_counter()
    dryrun.dryrun_multichip(1)
    log(f"{tag} dry run parts 1-6 on one NCCL rank (a spawned process) in {time.perf_counter() - t0:.1f} s")

    # ---- bench_all.py's 1M melt: the streaming kernel family ----
    rebin.update({f"n1m_{key}": value for key, value in phase_rebin(device, tag, N_CELLS_1M).items()})
    sort_rebin = phase_sort_rebin(device, tag)
    k5, k2_1m = phase_streaming(device, tag, N_CELLS_1M)
    counts_1m, ms_1m, eq_1m = phase_1m(device, tag)
    log(f"{smi}: 1M path {ms_1m:.4f} ms/step ({1_000_188 * 1e3 / ms_1m:,.0f} atom-steps/s); K5 vs K2 split "
        f"{k5['ms']:.4f} vs {k2_1m['k2_split_ms']:.4f} ms at 1M, {k5_97k['ms']:.4f} vs "
        f"{k2_97k['k2_split_ms']:.4f} ms at 97,556 atoms")
    counts_strag_1m, strag_1m_ms, strag_1m_err = phase_straggler_1m(device, tag, eq_1m)
    log(f"{smi}: 1M straggler path ('cuda_streaming') {strag_1m_ms:.4f} ms/step vs the dense 1M path {ms_1m:.4f}")
    k5s, counts_grid_1m, grid_1m_ms, k2g_1m = phase_grid_1m(device, tag, eq_1m)
    k7g_grid.update(phase_grid_spill_1m(device, tag, eq_1m))
    del eq_1m
    log(f"{smi}: 1M grid ms/step " + ", ".join(f"{p} {v:.4f}" for p, v in grid_1m_ms.items())
        + f" vs the dense 1M path {ms_1m:.4f}")
    water_1m_row, counts_water_1m, water_1m_ms, w1m = phase_water_1m(device, tag)
    k5c_row.update(water_1m_row)
    log(f"{smi}: 1M water path ('auto', K5c) {water_1m_ms:.4f} ms/step ({985_527 * 1e3 / water_1m_ms:,.0f} "
        f"atom-steps/s); K5c step launch {water_1m_row['n1m_water_ms']:.4f} ms vs K2c "
        f"{water_1m_row['n1m_water_k2c_ms']:.4f} ms")
    k5s_mol, counts_grid_water_1m, grid_water_1m_ms = phase_grid_water_1m(device, tag, w1m)
    del w1m
    log(f"{smi}: 1M water grid (2,2,2) ('auto', K5s-mol) {grid_water_1m_ms:.4f} ms/step vs the one-card 'auto' "
        f"(K5c) {water_1m_ms:.4f}")

    p1, p2 = phase_probes(device, tag)

    paths = {"dense": main_counts, "straggler": s_counts, **counts_spill, **counts_thermo, **counts_grid,
             **counts_1m, **counts_water, **counts_auto, **counts_water_1m, **counts_grid_water, **counts_ens,
             **counts_grid_1m, **counts_grid_water_1m, **counts_c104, **counts_modelling, **counts_grid_spill,
             **counts_strag_1m, **counts_slab}
    # The K5s paths (LJ) and the K5s-mol path: the streaming kernel's GHOST
    # modes, counted in streaming_kernel.LAUNCHES.
    k5s_paths = {p: c["cell_forces_streaming"] for p, c in {**counts_ens, **counts_grid_1m, **counts_grid_spill}.items()
                 if c["cell_forces_streaming"]}
    k5s_mol_paths = {p: c["cell_forces_streaming"] for p, c in counts_grid_water_1m.items()}
    # The grid's LJ paths on the resident family: K2-G, counted in cell_kernel.LAUNCHES.
    k2g_paths = {p: c["cell_forces"] for p, c in {**counts_grid, **counts_ens, **counts_grid_1m,
                                                   **counts_grid_spill}.items() if c["cell_forces"]}
    # The molecular paths' K5c, K2c-G and K5s-mol launches, and the K5s and K2-G paths', count in their own rows.
    mol_paths = {"cell_forces": set(counts_grid_water) | set(k2g_paths),
                 "cell_forces_streaming": set(counts_auto) | set(counts_water_1m) | set(k5s_paths)
                 | set(k5s_mol_paths) | {"modelling_auto"}}
    by_path = lambda name: {p: c[name] for p, c in paths.items()  # noqa: E731
                            if c[name] and p not in mol_paths.get(name, ())}
    kernels = [
        dict(name="cell_forces", route="cuda", source="emdee_tpu_torch/csrc/cell_forces.cu",
             replaces="emdee_tpu/neighbors/pallas_cell_kernel.py:597",
             strag_replaces="emdee_tpu/neighbors/pallas_cell_kernel.py:807",
             launches=sum(by_path("cell_forces").values()),
             launches_by_path=by_path("cell_forces"), **force, n1m_split_ms=k2_1m["k2_split_ms"],
             n1m_energy_ms=k2_1m["k2_energy_ms"],
             **{f"strag_{key}": value for key, value in k3["strag"].items()},
             mol_replaces="emdee_tpu/neighbors/pallas_cell_kernel.py:383",
             slab_full_shell_vs_k2a_rel_err=slab_err, k2a_drift_f64_10976=k2a_drift,
             k2a_drift_f64_10976_end_means=k2a_ends, k2a_drift_f64_10976_line=k2a_line,
             k2a_drift_f64_10976_swing=k2a_swing,
             mol_launches=counts_water["water"]["cell_forces"],
             mol_launches_by_path={"water": counts_water["water"]["cell_forces"],
                                   "modelling_cuda": counts_modelling["modelling_cuda"]["cell_forces"]},
             **mol_fixture_row, **mol_row, **modelling["k2c"]),
        dict(name="cell_forces_streaming", route="cuda", source="emdee_tpu_torch/csrc/cell_forces_streaming.cu",
             replaces="emdee_tpu/neighbors/pallas_cell_kernel.py:1158",
             launches=sum(by_path("cell_forces_streaming").values()),
             launches_by_path=by_path("cell_forces_streaming"), **k5,
             **{f"n97556_{key}": value for key, value in k5_97k.items()}, **c104_row,
             n1m_straggler_max_abs_err=strag_1m_err),
        dict(name="cell_forces_streaming_mol", route="cuda", source="emdee_tpu_torch/csrc/cell_forces_streaming.cu",
             replaces="emdee_tpu/neighbors/pallas_cell_kernel.py:1417",
             launches=counts_auto["water_auto"]["cell_forces_streaming"],
             launches_by_path={p: c["cell_forces_streaming"]
                               for p, c in {**counts_auto, **counts_water_1m, **counts_modelling}.items()
                               if c["cell_forces_streaming"]},
             **k5c_row, **modelling["k5c"], modelling_host_seconds=modelling["host_seconds"]),
        dict(name="cell_forces_ghost", route="cuda", source="emdee_tpu_torch/csrc/cell_forces.cu",
             replaces="emdee_tpu/distributed/grid_sharded.py:629",
             kernel_replaces="emdee_tpu/neighbors/pallas_cell_kernel.py:597",
             launches=sum(k2g_paths.values()), launches_by_path=k2g_paths,
             max_abs_err=max(k2g_1m["max_abs_err"], *(r["max_abs_err"] for p, r in k2g_rows.items()
                                                        if p != "resources")),
             ms=k2g_1m["ms"], plain_ms=k2g_1m["plain_ms"], bound_ms=k2g_1m["bound_ms"], bound_by=k2g_1m["bound_by"],
             library_ms=None, grid_1m_222_m36_auto=k2g_1m, **k2g_rows),
        dict(name="cell_forces_ghost_mol", route="cuda", source="emdee_tpu_torch/csrc/cell_forces.cu",
             replaces="emdee_tpu/distributed/grid_sharded.py:629",
             launches=counts_grid_water["grid_water_222"]["cell_forces"],
             launches_by_path={p: c["cell_forces"] for p, c in counts_grid_water.items()}, **ghost_mol_row),
        dict(name="cell_forces_streaming_ghost", route="cuda", source="emdee_tpu_torch/csrc/cell_forces_streaming.cu",
             replaces="emdee_tpu/distributed/grid_sharded.py:658",
             kernel_replaces="emdee_tpu/neighbors/pallas_cell_kernel.py:1158",
             launches=sum(k5s_paths.values()), launches_by_path=k5s_paths, max_abs_err=k5s["max_abs_err"],
             ms=k5s["runs"]["grid_1m_111_m37"]["ms"], plain_ms=k5s["runs"]["grid_1m_111_m37"]["plain_ms"],
             bound_ms=k5s["runs"]["grid_1m_111_m37"]["bound_ms"], bound_by=k5s["runs"]["grid_1m_111_m37"]["bound_by"],
             library_ms=None, vs_one_card_max_abs_err=k5s["vs_one_card"], energy_max_abs_err=k5s["energy_err"],
             decomposition_max_abs_err=k5s["decomp_err"], resources=k5s["resources"], runs=k5s["runs"]),
        dict(name="cell_forces_streaming_ghost_mol", route="cuda",
             source="emdee_tpu_torch/csrc/cell_forces_streaming.cu",
             replaces="emdee_tpu/distributed/grid_sharded.py:658",
             kernel_replaces="emdee_tpu/neighbors/pallas_cell_kernel.py:1158",
             launches=sum(k5s_mol_paths.values()), launches_by_path=k5s_mol_paths,
             max_abs_err=k5s_mol["max_abs_err"], ms=k5s_mol["ms"], plain_ms=k5s_mol["plain_ms"],
             bound_ms=k5s_mol["bound_ms"], bound_by=k5s_mol["bound_by"], library_ms=None,
             vs_one_card_max_abs_err=k5s_mol["vs_one_card"], energy_max_abs_err=k5s_mol["energy_err"],
             **{key: value for key, value in k5s_mol.items()
                if key not in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "vs_one_card", "energy_err")}),
        dict(name="rebin_routing", route="cuda", source="emdee_tpu_torch/csrc/rebin_routing.cu",
             replaces="emdee_tpu/neighbors/pallas_rebin.py:60",
             launches=sum(by_path("rebin_routing").values()),
             launches_by_path=by_path("rebin_routing"), **rebin),
        dict(name="sort_rebin", route="cuda", source="emdee_tpu_torch/csrc/sort_rebin.cu",
             replaces="none: emdee_tpu/neighbors/cell_dense.py _rebin is jnp.argsort and gathers",
             launches=sum(by_path("sort_rebin").values()), launches_by_path=by_path("sort_rebin"),
             **sort_rebin),
        dict(name="straggler_aux", route="cuda", source="emdee_tpu_torch/csrc/straggler_forces.cu",
             replaces="emdee_tpu/neighbors/pallas_cell_kernel.py:807",
             launches=s_counts["straggler_aux"], launches_by_path=by_path("straggler_aux"), **k3["aux"]),
        dict(name="compact_window", route="cuda", source="emdee_tpu_torch/csrc/spill_routing.cu",
             replaces="emdee_tpu/neighbors/pallas_compact.py:34", witness="emdee_tpu_torch/csrc/compact_window.cu",
             launches=sum(by_path("compact_window").values()),
             launches_by_path=by_path("compact_window"), **k7),
        dict(name="rebin_window", route="cuda", source="emdee_tpu_torch/csrc/rebin_window.cu",
             replaces="emdee_tpu/neighbors/pallas_rebin.py:291", kernel="rebin_halo_kernel",
             witness="rebin_window_kernel (the same source)",
             launches=sum(by_path("rebin_window").values()),
             launches_by_path=by_path("rebin_window"), **k6),
        dict(name="spill_grid", route="cuda", source="emdee_tpu_torch/csrc/spill_window.cu",
             replaces="emdee_tpu/neighbors/pallas_compact.py:101", kernel="spill_grid_kernel",
             witness="spill_halo_kernel (the same source: the per-pass form)",
             launches=sum(by_path("spill_grid").values()), launches_by_path=by_path("spill_grid"), **k7g_grid),
        dict(name="spill_window", route="cuda", source="emdee_tpu_torch/csrc/spill_window.cu",
             replaces="emdee_tpu/neighbors/pallas_compact.py:101", kernel="spill_halo_kernel",
             runs_on="a DistMesh of several ranks (one card holds every shard: the one-launch form runs)",
             launches=sum(by_path("spill_window").values()), launches_by_path=by_path("spill_window"), **k7g),
        dict(name="probe_fma", route="cuda", source="emdee_tpu_torch/csrc/probes.cu",
             replaces="tools/perf_probe3.py:29", launches=0, launches_by_path={}, **p1),
        dict(name="probe_cen_layout", route="cuda", source="emdee_tpu_torch/csrc/probes.cu",
             replaces="tools/perf_probe_cen_layout.py:95", dgt_replaces="tools/perf_probe_cen_layout.py:103",
             launches=0, launches_by_path={}, **p2),
    ]
    log(f"{smi}: every phase passed in {time.perf_counter() - t_start:.1f} s, the kernels' build included")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
