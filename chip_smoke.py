#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`emdee_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from `emdee_tpu_torch/csrc/`, holds each kernel
against its plain PyTorch version on the card, then drives the main path —
the 97,556-atom LJ melt (FCC 29³ at ρ* = 0.8442, T* = 1.44, rc = 2.5σ,
switch 2.0σ, skin 0.35, dt = 0.005) in NVE on the dense-cell engine —
through `cell_dense_init` and `make_cell_dense_sim`, and gates it: no
overflow, NVE drift ≤ 3e-5 over 1,000 steps, launch counts that show every
force evaluation and every rebin pass went through the kernels, and bitwise
equal reruns.  Every phase prints its own line; any failure raises and the
exit code is non-zero.  The last two lines are one JSON object describing
the kernels and one describing the device.  Without a CUDA device it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

SEED = 0
N_CELLS = 29  # FCC 29³ → 97,556 atoms
DENSITY, T0, CUTOFF, SWITCH, SKIN, DT = 0.8442, 1.44, 2.5, 2.0, 0.35, 0.005
DRIFT_GATE = 3e-5
FORCE_REL_GATE = 5e-4


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


def drifted(state, skin):
    """Move every atom 0.45·skin along its velocity, without wrapping, so a
    real fraction crosses its cell faces and the periodic seam."""
    v = state.velocities
    vmax = float(v.abs().max())
    pos = torch.where(state.valid[..., None], state.positions + (0.45 * skin / vmax) * v, 0.0)
    return state._replace(positions=pos)


def melt(device):
    from emdee_tpu_torch import (
        LennardJonesModel, cell_dense_init, detect_uniform_params,
        lennard_jones_atom, suggest_cell_dense_config,
    )
    from emdee_tpu_torch.utils.lattice import fcc_lattice, maxwell_boltzmann

    pos, box = fcc_lattice(N_CELLS, density=DENSITY)
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

    def check(st, config, model, label):
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

    err, scale = check(st, config, model, "2048 per-atom")
    log(f"{tag} force kernel vs plain, 2,048 atoms, per-atom params + energies: "
        f"max |dF| {err:.3e} (rel {err / scale:.3e}), empty slots exactly 0")

    st, config, model, _, uni, n = melt(device)
    st = drifted(st, SKIN)
    err_s, scale_s = check(st, config, model, f"{n} per-atom")
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
    log(f"{tag} force kernel time at {n} atoms: split {ms:.4f} ms/launch, plain {plain_ms:.3f} ms; "
        f"per-atom+energies {ms_e:.4f} ms/launch, plain {plain_ms_e:.3f} ms")
    return {"max_abs_err": max(err, err_s), "ms": ms, "plain_ms": plain_ms}


def phase_rebin(device, tag):
    """Rebin kernel vs plain on the drifted melt: bit-exact in every field."""
    from emdee_tpu_torch.neighbors.cell_dense import _rebin_shift
    from emdee_tpu_torch.neighbors.rebin_kernel import SENTINEL_BITS, rebin_routing

    st, config, _, _, _, n = melt(device)
    st = drifted(st, SKIN)
    a = _rebin_shift(st, config, backend="cuda")
    b = _rebin_shift(st, config, backend="torch")
    torch.cuda.synchronize()
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            raise AssertionError(f"rebin kernel vs plain: field {name} differs")
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
    log(f"{tag} rebin kernel vs plain, {n} atoms, M={m} C={c}: bit-exact in every field, "
        f"{moved} slots moved; 3 passes {ms:.4f} ms per rebin (plain {plain_ms:.3f} ms)")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms}


def gate_rollout(label, rollout, energy, st0, steps, rebin_every, cell_launches, rebin_launches):
    """Run one measured rollout with the launch counters reset; gate overflow,
    NVE drift and the launch counts.  Returns (final state, seconds, counts)."""
    from emdee_tpu_torch.neighbors import cell_kernel, rebin_kernel

    cell_kernel.LAUNCHES = 0
    rebin_kernel.LAUNCHES = 0
    pe0, _, ke0 = energy(st0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = rollout(st0, num_steps=steps, rebin_every=rebin_every)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    pe1, _, ke1 = energy(out)
    counts = (cell_kernel.LAUNCHES, rebin_kernel.LAUNCHES)
    e0, e1 = float(pe0 + ke0), float(pe1 + ke1)
    drift = abs(e1 - e0) / max(abs(e0), 1.0)
    if bool(out.overflow):
        raise AssertionError(f"{label}: overflow")
    if not drift <= DRIFT_GATE:
        raise AssertionError(f"{label}: NVE drift {drift:.3e} > {DRIFT_GATE}")
    if counts != (cell_launches, rebin_launches):
        raise AssertionError(
            f"{label}: kernel launches {counts}, expected {(cell_launches, rebin_launches)}"
        )
    return out, seconds, drift, counts


def bitwise_rerun(label, rollout, st0, steps, rebin_every):
    a = rollout(st0, num_steps=steps, rebin_every=rebin_every)
    b = rollout(st0, num_steps=steps, rebin_every=rebin_every)
    for name in a._fields:
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"{label}: reruns differ in {name}")


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

    # ---- main path: bench.py's wide config, component carry ----
    from emdee_tpu_torch import (
        cell_dense_init, gather_dense_atoms, make_cell_dense_sim, suggest_rebin_interval,
    )

    state, config, model, params, uni, n = melt(device)
    rollout, energy = make_cell_dense_sim(config, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    state = rollout(state, num_steps=200, rebin_every=2)
    if bool(state.overflow):
        raise AssertionError("equilibration overflow at wide capacity")
    pos_eq, vel_eq = gather_dense_atoms(state, n)
    t_eq = float((vel_eq.astype(np.float64) ** 2).sum() / (3.0 * n - 3.0))
    k = suggest_rebin_interval(config.skin, DT, temperature=t_eq)
    st0 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, config, device=device)
    if bool(st0.overflow):
        raise AssertionError("re-init overflow at wide capacity")
    log(f"equilibrated 200 steps: T* = {t_eq:.4f}, rebin every {k} steps, M={config.cells_per_dim} C={config.capacity}")

    steps = 1000
    n_rebins = -(-steps // k)
    out, sec, drift, main_counts = gate_rollout(
        "main path", rollout, energy, st0, steps, k, steps + 2 + 2, 3 * n_rebins
    )
    main_ms = 1e3 * sec / steps
    log(f"{tag} main path (component carry, uniform params): {steps} steps in {sec:.3f} s = "
        f"{main_ms:.4f} ms/step, {n * steps / sec:,.0f} atom-steps/s; NVE drift {drift:.3e}; "
        f"launches cell_forces {main_counts[0]}, rebin passes {main_counts[1]}")
    bitwise_rerun("main path", rollout, st0, 100, k)
    log("main path: two 100-step rollouts bitwise equal")

    # ---- the README path: stacked per-atom leapfrog ----
    roll_s, energy_s = make_cell_dense_sim(config, model, dt=DT)
    steps_s = 200
    _, sec_s, drift_s, counts_s = gate_rollout(
        "README path", roll_s, energy_s, st0, steps_s, k, steps_s + 2 + 2, 3 * -(-steps_s // k)
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

    kernels = [
        dict(name="cell_forces", route="cuda", source="emdee_tpu_torch/csrc/cell_forces.cu",
             replaces="emdee_tpu/neighbors/pallas_cell_kernel.py:597",
             launches=main_counts[0], **force),
        dict(name="rebin_routing", route="cuda", source="emdee_tpu_torch/csrc/rebin_routing.cu",
             replaces="emdee_tpu/neighbors/pallas_rebin.py:60",
             launches=main_counts[1], **rebin),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
