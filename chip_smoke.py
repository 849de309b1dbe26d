#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`emdee_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from `emdee_tpu_torch/csrc/`, holds each kernel
against its plain PyTorch version on the card, then drives three paths of
the LJ melt (FCC at ρ* = 0.8442, T* = 1.44, rc = 2.5σ, switch 2.0σ, skin
0.35, dt = 0.005) in NVE:

- the dense-cell engine on the 97,556-atom melt (FCC 29³) at bench.py's
  wide config, through `cell_dense_init` and `make_cell_dense_sim`
  (equilibrates the melt 200 steps first), where `backend="auto"` resolves
  to the resident kernel family;
- the C-tight straggler engine at bench.py's production config (C_t =
  wide−4, C_w = wide+4, A = 64, Kn = 16), through `straggler_init` and
  `make_straggler_sim`, from the equilibrated melt;
- the dense-cell engine on bench_all.py's 1,000,188-atom melt (FCC 63³,
  M = 37, C = 32), where `backend="auto"` resolves to the streaming kernel
  family (equilibrated 200 steps at rebin every 2; bench_all.py settles
  100), and a short stacked per-atom rollout at the same size.

Each path is gated: no overflow (capacity, staleness, Kn, A), NVE drift ≤
3e-5 over 1,000 steps, launch counts that show every force evaluation,
straggler pass and rebin pass went through the kernels (counts set to 0
just before the path and read just after), and bitwise equal reruns.
Every phase prints its own line; any failure raises and the exit code is
non-zero.  The last two lines are one JSON object describing the kernels
(times, launches, bounds) and one describing the device.  Without a CUDA
device it exits non-zero and prints no result.

Bounds: the least time the card could take for a kernel's work, the larger
of its bytes (each input read once, each output written once) at 3.35 TB/s
and its float32 operations at 67 TFLOP/s (H100 SXM data sheet), with the
pairs inside the cutoff counted from this run's data.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from emdee_tpu_torch.tools.melt import (
    CUTOFF, DT, N_CELLS_1M, SKIN, SWITCH, equilibrate, melt, straggler_config,
)

DRIFT_GATE = 3e-5
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
    log(f"{tag} force kernel time at {n} atoms: split {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by}); per-atom+energies {ms_e:.4f} ms/launch, plain "
        f"{plain_ms_e:.3f} ms, bound {bound_e[0]:.5f} ms ({bound_e[1]}); {pairs:,} pairs inside the cutoff")
    return {"max_abs_err": max(err, err_s), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_rebin(device, tag):
    """Rebin kernel vs plain on the drifted melt: bit-exact in every field."""
    from emdee_tpu_torch.neighbors.cell_dense import _rebin_shift
    from emdee_tpu_torch.neighbors.rebin_kernel import SENTINEL_BITS, rebin_routing

    st, config, _, _, _, n = melt(device)
    st = drifted(st, SKIN)
    a = _rebin_shift(st, config, backend="cuda")
    b = _rebin_shift(st, config, backend="torch")
    torch.cuda.synchronize()
    same_fields("rebin kernel vs plain", a, b)
    moved = int(((a.atom_id != st.atom_id) & a.valid).sum())
    if bool(a.overflow) or moved < 1000:
        raise AssertionError(f"rebin fixture: overflow {bool(a.overflow)}, {moved} slots moved")

    box = torch.tensor(config.box, dtype=torch.float32, device=device)
    sent = torch.tensor(SENTINEL_BITS, dtype=torch.int32, device=device).view(torch.float32)
    pos = st.positions - torch.floor(st.positions / box) * box
    fields = tuple(torch.where(st.valid, pos[..., i], sent) for i in range(3))
    fields += tuple(st.velocities[..., i].contiguous() for i in range(3)) + (st.atom_id,)
    m, c, ns = config.cells_per_dim, config.capacity, config.num_slots
    ms = cuda_ms(lambda: rebin_routing(fields, config.box, m, c, ns, backend="cuda"), 50)
    plain_ms = cuda_ms(lambda: rebin_routing(fields, config.box, m, c, ns, backend="torch"), 10)
    bound_ms, bound_by = bound(2 * 4 * len(fields) * ns, 0)
    log(f"{tag} rebin kernel vs plain, {n} atoms, M={m} C={c}: bit-exact in every field, "
        f"{moved} slots moved; 3 passes {ms:.4f} ms per rebin (plain {plain_ms:.3f} ms), "
        f"bound {bound_ms:.5f} ms ({bound_by})")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_streaming(device, tag, cells=None):
    """The streaming kernel (K5) on the melt of `cells`³ FCC cells, drifted
    across the seam: both entries vs the plain version (forces within 2e-5
    of the force scale, energies and virials, exact zeros on empty slots),
    vs the resident kernel (K2) on the same state, and the times of K5, K2
    and the plain version, each entry.  Returns (K5 row, K2 times)."""
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces, cell_forces_split
    from emdee_tpu_torch.neighbors.streaming_kernel import cell_forces_streaming, cell_forces_streaming_split

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
    # The design's own traffic: four reaction row groups written and read back.
    rows_ms = 1e3 * 2 * 4 * 3 * 4 * ns / HBM_BYTES_PER_S
    log(f"{tag} K5 at {n} atoms (M={config.cells_per_dim} C={config.capacity}), drifted across the seam: "
        f"vs plain max |dF| per-atom+energies {err_e:.3e}, split {err_s:.3e} (rel {err / scale:.3e}); "
        f"vs K2 max |dF| {vs_k2:.3e} (rel {vs_k2 / scale:.3e}); energies, virials in tolerance, "
        "empty slots exactly 0")
    log(f"{tag} K5 vs K2 times at {n} atoms: split K5 {ms:.4f} ms (2 launches) vs K2 {k2_ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}; reaction rows alone "
        f"{rows_ms:.5f} ms); per-atom+energies K5 {ms_e:.4f} ms vs K2 {k2_ms_e:.4f} ms, plain "
        f"{plain_ms_e:.3f} ms, bound {bound_e[0]:.5f} ms ({bound_e[1]}); {pairs:,} pairs inside the cutoff")
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None, "energy_ms": ms_e, "energy_plain_ms": plain_ms_e,
           "energy_bound_ms": bound_e[0], "vs_k2_max_abs_err": vs_k2}
    return row, {"k2_split_ms": k2_ms, "k2_energy_ms": k2_ms_e}


def phase_1m(device, tag):
    """bench_all.py's 1M melt on the dense engine through `backend="auto"`,
    which must resolve to the streaming family: equilibrate, then the gated
    1,000-step component-carry rollout (overflow, drift, K5 and K4 launch
    counts), bitwise reruns, and a short stacked per-atom rollout.  Returns
    {path: launch counts} and the rollout's ms/step."""
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
    zero = {"cell_forces": 0, "straggler_aux": 0}
    _, sec, drift, counts = gate_rollout(
        "1M path", rollout, energy, st0, steps, k,
        {**zero, "cell_forces_streaming": 2 * (steps + 2 + 2), "rebin_routing": 3 * -(-steps // k)},
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
        {**zero, "cell_forces_streaming": 2 * (steps_s + 2 + 2), "rebin_routing": 3 * -(-steps_s // k)},
    )
    bitwise_rerun("1M stacked path", roll_s, st0, 50, k)
    log(f"{tag} 1M stacked path (per-atom params, K5): {steps_s} steps, {1e3 * sec_s / steps_s:.4f} ms/step; "
        f"NVE drift {drift_s:.3e}; launches {counts_s}; two 50-step rollouts bitwise equal")
    return {"dense_1m": counts, "stacked_1m": counts_s}, ms


def counters():
    from emdee_tpu_torch.neighbors import cell_kernel, rebin_kernel, straggler_kernel, streaming_kernel

    return {"cell_forces": cell_kernel, "cell_forces_streaming": streaming_kernel,
            "rebin_routing": rebin_kernel, "straggler_aux": straggler_kernel}


def gate_rollout(label, rollout, energy, st0, steps, rebin_every, expected):
    """Run one measured rollout with every launch counter set to 0 just
    before it; gate overflow, NVE drift and the launch counts (`expected`,
    by kernel, the two energy calls included).  Returns (final state,
    seconds, drift, counts)."""
    mods = counters()
    for mod in mods.values():
        mod.LAUNCHES = 0
    pe0, _, ke0 = energy(st0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = rollout(st0, num_steps=steps, rebin_every=rebin_every)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    pe1, _, ke1 = energy(out)
    counts = {name: mod.LAUNCHES for name, mod in mods.items()}
    e0, e1 = float(pe0 + ke0), float(pe1 + ke1)
    drift = abs(e1 - e0) / max(abs(e0), 1.0)
    if bool(getattr(out, "grid", out).overflow):
        raise AssertionError(f"{label}: overflow")
    if not drift <= DRIFT_GATE:
        raise AssertionError(f"{label}: NVE drift {drift:.3e} > {DRIFT_GATE}")
    if counts != expected:
        raise AssertionError(f"{label}: kernel launches {counts}, expected {expected}")
    return out, seconds, drift, counts


def bitwise_rerun(label, rollout, st0, steps, rebin_every):
    a = rollout(st0, num_steps=steps, rebin_every=rebin_every)
    b = rollout(st0, num_steps=steps, rebin_every=rebin_every)
    for (name, x), (_, y) in zip(tensors(a), tensors(b)):
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: reruns differ in {name}")


def phase_straggler_kernel(device, tag, label, sconfig, pos_eq, vel_eq, params, model, uni, n):
    """K3 on the equilibrated melt, its atoms then drifted 0.45·skin along
    their velocities: both CUDA sides vs the plain version, exact zeros on
    empty slots and lanes, the forces vs the wide state's, the gather pass
    vs the kernel pass, and the times of each launch and plain side.  Also
    K2b and K4 vs their plain versions at the wide capacity C_w, on the
    wide state and the widened fields that the path's energy closure and
    rebin hand them."""
    from emdee_tpu_torch import make_straggler_sim, straggler_init
    from emdee_tpu_torch.neighbors import cell_kernel
    from emdee_tpu_torch.neighbors import straggler_kernel as sk
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

    out_g = torch.empty_like(fg)
    out_a = torch.empty_like(fa)
    strag_ms = cuda_ms(lambda: cell_kernel.launch_strag(*args[:7], table, out_g, cfg, uni), 50)
    aux_ms = cuda_ms(lambda: sk.launch_aux(*args[:8], out_a, sconfig, uni), 200)
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
        f"(rel {err_w / wscale:.3e}); gather pass vs kernel {err_x:.3e}; empty slots and lanes exactly 0")
    log(f"{tag} K3 {label} at C_w={cfg_w.capacity}: K2b kernel vs plain max |dF| {err_e:.3e} (energies, "
        f"virials in tolerance, empty slots exactly 0); K4 kernel vs plain bit-exact in every field and "
        f"the flag, {moved_w} slots moved, {tail_w} atoms in the pad slots after the rebin")
    log(f"{tag} K3 {label} times: grid launch (STRAG) {strag_ms:.4f} ms (plain {strag_plain_ms:.3f} ms, "
        f"bound {strag_bound[0]:.5f} ms {strag_bound[1]}); aux launch {aux_ms:.4f} ms (plain "
        f"{aux_plain_ms:.3f} ms, bound {aux_bound[0]:.6f} ms {aux_bound[1]}); pairs: grid {gg:,}, "
        f"aux-grid {ag:,}, aux-aux {aa}")
    return {
        "strag": {"max_abs_err": err_g, "ms": strag_ms, "plain_ms": strag_plain_ms,
                  "bound_ms": strag_bound[0], "bound_by": strag_bound[1]},
        "aux": {"max_abs_err": err_a, "ms": aux_ms, "plain_ms": aux_plain_ms,
                "bound_ms": aux_bound[0], "bound_by": aux_bound[1], "library_ms": None},
        "wide_force_err": err_e,
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA device")
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
        {"cell_forces": steps + 2 + 2, "cell_forces_streaming": 0, "rebin_routing": 3 * n_rebins,
         "straggler_aux": 0},
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
        {"cell_forces": steps_s + 2 + 2, "cell_forces_streaming": 0, "rebin_routing": 3 * -(-steps_s // k),
         "straggler_aux": 0},
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
        {"cell_forces": steps + 2 + 2, "cell_forces_streaming": 0, "rebin_routing": 3 * n_rebins,
         "straggler_aux": steps + 2},
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

    # ---- bench_all.py's 1M melt: the streaming kernel family ----
    k5, k2_1m = phase_streaming(device, tag, N_CELLS_1M)
    counts_1m, ms_1m = phase_1m(device, tag)
    log(f"{smi}: 1M path {ms_1m:.4f} ms/step ({1_000_188 * 1e3 / ms_1m:,.0f} atom-steps/s); K5 vs K2 split "
        f"{k5['ms']:.4f} vs {k2_1m['k2_split_ms']:.4f} ms at 1M, {k5_97k['ms']:.4f} vs "
        f"{k2_97k['k2_split_ms']:.4f} ms at 97,556 atoms")

    paths = {"dense": main_counts, "straggler": s_counts, **counts_1m}
    by_path = lambda name: {p: c[name] for p, c in paths.items() if c[name]}  # noqa: E731
    kernels = [
        dict(name="cell_forces", route="cuda", source="emdee_tpu_torch/csrc/cell_forces.cu",
             replaces="emdee_tpu/neighbors/pallas_cell_kernel.py:597",
             strag_replaces="emdee_tpu/neighbors/pallas_cell_kernel.py:807",
             launches=sum(by_path("cell_forces").values()),
             launches_by_path=by_path("cell_forces"), **force, n1m_split_ms=k2_1m["k2_split_ms"],
             n1m_energy_ms=k2_1m["k2_energy_ms"],
             **{f"strag_{key}": value for key, value in k3["strag"].items()}),
        dict(name="cell_forces_streaming", route="cuda", source="emdee_tpu_torch/csrc/cell_forces_streaming.cu",
             replaces="emdee_tpu/neighbors/pallas_cell_kernel.py:1158",
             launches=sum(by_path("cell_forces_streaming").values()),
             launches_by_path=by_path("cell_forces_streaming"), **k5,
             **{f"n97556_{key}": value for key, value in k5_97k.items()}),
        dict(name="rebin_routing", route="cuda", source="emdee_tpu_torch/csrc/rebin_routing.cu",
             replaces="emdee_tpu/neighbors/pallas_rebin.py:60",
             launches=sum(by_path("rebin_routing").values()),
             launches_by_path=by_path("rebin_routing"), **rebin),
        dict(name="straggler_aux", route="cuda", source="emdee_tpu_torch/csrc/straggler_forces.cu",
             replaces="emdee_tpu/neighbors/pallas_cell_kernel.py:807",
             launches=s_counts["straggler_aux"], launches_by_path=by_path("straggler_aux"), **k3["aux"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
