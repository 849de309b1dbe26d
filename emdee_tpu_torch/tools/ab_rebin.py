"""A/B the shift rebin's routing (K4) and the straggler pass's aux side
(K3 aux) against other versions of their sources on the card, in one
process:

- A: the checkout's, through the package (`rebin_kernel.rebin_routing`,
  one cooperative launch a rebin; `straggler_kernel.launch_aux`);
- B, C, …: each DIR's `rebin_routing.cu` and `straggler_forces.cu` (an
  unpacked parent commit's `csrc/` or a kept working copy, with its own
  `rebin_row.cuh` and `lj_pair.cuh`, else the checkout's), built together
  into `build/emdee_tpu_torch/ab_rebin_<i>.so`: its one-launch rebin where
  the source has `emdee_rebin_routing`, else its three `emdee_rebin_pass`
  launches on the stacked fields, parked by torch ops as
  `_rebin_shift_core` parked them; its `emdee_straggler_aux`;
- W: the checkout's witnesses of the former designs, `emdee_rebin_pass`
  three times and `emdee_straggler_aux_warp`.

Run from the repository root on a machine with a CUDA card, with DIR an
unpacked parent's `csrc/` (e.g. `git archive HEAD~1 emdee_tpu_torch/csrc`
unpacked under `build/`):

    python3 -m emdee_tpu_torch.tools.ab_rebin DIR [DIR ...]

K4 cases, each drifted 0.45·skin along the velocities: the 97,556-atom
melt of `tools/melt.py` (M = 17, C = 32) with the component-carry path's
seven fields (positions and velocities as strided views of their (M³, C,
3) tensors, atom id) and with the per-atom path's ten (plus 1/m, σ/2,
2√ε); the same with the box as a dynamic 0-d tensor; the same with every
atom of the cells at y = 0 moved one cell up y, so that the y pass, between
the other two, overflows; the same with one atom moved two cells along x;
and the 1,000,188-atom melt (M = 37, C = 32).  For each it prints whether
every version equals A bit for bit in every field and the flag, then the
ms of every version in turns, forwards and back, on both clocks: CUDA
events around back-to-back calls (the host in the loop) and around calls
queued behind a device spin (the device clock) — first for the rebin as
the path calls it (raw positions, the valid mask, the wrap; a three-pass
version parks and wraps with torch ops first), then for the routing alone
on parked fields.  K3 aux: the smoke's production straggler state (the
melt after its 200-step equilibration, C_t = 28, A = 64, Kn = 16, drifted
alike): bit for bit A in every output, the empty lanes' zeros included,
and ms in turns on both clocks.  First the card's name and power limit and
A's cooperative grid (resident blocks an SM, SMs, threads a block, rows a
block at a time).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from emdee_tpu_torch.csrc import build

ENTRIES = ("emdee_rebin_routing", "emdee_rebin_pass", "emdee_straggler_aux")


def _load_all(dirs) -> list:
    """Build every DIR's two sources at once, each DIR into its own library,
    and load them."""
    paths = [build.BUILD_DIR / f"ab_rebin_{i}.so" for i in range(len(dirs))]
    build._run([[build._nvcc(), *build.NVCC_FLAGS, "-I", str(Path(d)), "-I", str(build.CSRC), "-shared", "-o",
                 str(path), str(Path(d) / "rebin_routing.cu"), str(Path(d) / "straggler_forces.cu")]
                for d, path in zip(dirs, paths)])
    libs = []
    for path in paths:
        lib = ctypes.CDLL(str(path))
        for name in ENTRIES:
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = build._SIGNATURES[name]
                fn.restype = ctypes.c_int
        libs.append(lib)
    return libs


def three_pass(lib, fields, box, m: int, c: int, num_slots: int):
    """The former K4: the fields (parked) stacked as (nf, M³, C) int32, the
    flag zeroed, `lib`'s `emdee_rebin_pass` launched once a pass,
    ping-ponging two buffers.  Returns (fields, overflow) as
    `rebin_kernel.rebin_routing` does."""
    from emdee_tpu_torch.neighbors.cell_dense import _PASSES, box_ptr

    nf = len(fields)
    dev = fields[0].device
    x = torch.stack([f.view(torch.int32) for f in fields])
    y = torch.empty_like(x)
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    box_p = box_ptr(box, fields[0])
    for axis, _, cf in _PASSES:
        build.check(lib.emdee_rebin_pass(x.data_ptr(), y.data_ptr(), flag.data_ptr(), nf, m, c, axis, cf,
                                         num_slots, box_p, stream), "rebin_pass (A/B version)")
        x, y = y, x
    return tuple(x[i].view(torch.float32) for i in range(nf - 1)) + (x[nf - 1],), flag != 0


def rebin_core(lib, fields, valid, box, m: int, c: int, num_slots: int, three: bool = False):
    """The rebin as `_rebin_shift_core` runs it without spill (raw
    positions, the valid mask, the wrap) on a version: `lib` None is the
    checkout's one launch; a library with `emdee_rebin_routing` is called
    as the checkout calls it, unless `three`; else the positions are parked
    and wrapped by torch ops and routed by `three_pass`."""
    from emdee_tpu_torch.neighbors import rebin_kernel
    from emdee_tpu_torch.neighbors.cell_dense import _box

    if lib is None:
        return rebin_kernel.rebin_routing(fields, box, m, c, num_slots, backend="cuda", valid=valid, wrap=True)
    if hasattr(lib, "emdee_rebin_routing") and not three:
        return _routing(lib, fields, valid, True, box, m, c, num_slots)
    parked = rebin_kernel._parked(fields, valid, _box(box, fields[0]), True)
    return three_pass(lib, parked, box, m, c, num_slots)


def _routing(lib, fields, valid, wrap, box, m, c, num_slots):
    """One `emdee_rebin_routing` launch of `lib` (a one-launch version)."""
    from emdee_tpu_torch.neighbors.cell_dense import box_ptr

    nf, dev = len(fields), fields[0].device
    out = torch.empty((nf, m**3, c), dtype=torch.int32, device=dev)
    mid = torch.empty_like(out)
    flag = torch.empty((), dtype=torch.int32, device=dev)
    build.check(lib.emdee_rebin_routing(
        (ctypes.c_void_p * nf)(*(f.data_ptr() for f in fields)), (ctypes.c_long * nf)(*(f.stride(1) for f in fields)),
        nf, None if valid is None else valid.data_ptr(), int(wrap), out.data_ptr(), mid.data_ptr(), flag.data_ptr(),
        m, c, num_slots, box_ptr(box, fields[0]), torch.cuda.current_stream(dev).cuda_stream),
        "rebin_routing (A/B version)")
    return tuple(out[i].view(torch.float32) for i in range(nf - 1)) + (out[nf - 1],), flag != 0


def routing_parked(lib, fields, box, m, c, num_slots, three: bool = False):
    """The routing alone on parked fields on a version (`lib` None: the
    checkout's one launch without a mask; `three` as `rebin_core`)."""
    from emdee_tpu_torch.neighbors import rebin_kernel

    if lib is None:
        return rebin_kernel.rebin_routing(fields, box, m, c, num_slots, backend="cuda")
    if hasattr(lib, "emdee_rebin_routing") and not three:
        return _routing(lib, fields, None, False, box, m, c, num_slots)
    return three_pass(lib, fields, box, m, c, num_slots)


def aux_call(lib, entry, args, out, sconfig, uni) -> None:
    """K3's aux side through `lib`'s C entry `entry` (the signature of
    `emdee_straggler_aux`) on `straggler_forces`' first eight operands,
    writing out (3, A)."""
    from emdee_tpu_torch.neighbors.cell_kernel import _pair_consts

    cfg = sconfig.grid
    build.check(getattr(lib, entry)(
        *(t.data_ptr() for t in args[:8]), out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        cfg.cells_per_dim, cfg.capacity, sconfig.aux_capacity, float(cfg.box), *_pair_consts(cfg, uni),
        torch.cuda.current_stream(args[0].device).cuda_stream), f"{entry} (A/B version)")


def host_ms(fn, reps: int) -> float:
    """CUDA-event ms a call over `reps` back-to-back calls: the host's
    launch cost included where it exceeds the device's time."""
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
    """CUDA-event ms a call over `reps` calls queued behind a device-side
    spin, so that the host has queued every call before the first starts:
    the device clock."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _same(a, b) -> bool:
    (fa, oa), (fb, ob) = a, b
    return bool(oa) == bool(ob) and all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(fa, fb))


def _times(smi, what, runs, reps):
    """ms of every version in turns, forwards and back, on both clocks."""
    for clock, timer in (("host in the loop", host_ms), ("device clock", device_ms)):
        times = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:
            times[k].append(timer(runs[k], reps))
        print(f"{smi}: {what}, ms ({clock}): " + "; ".join(f"{k} " + ", ".join(f"{t:.5f}" for t in v)
                                                          for k, v in times.items()), flush=True)


def rebin_cases(device):
    """(label, fields, valid, box) of the K4 cases: the drifted melts, the
    box as a tensor, the crowded y pass, the two-cell jump."""
    from emdee_tpu_torch.tools.melt import N_CELLS_1M, SKIN, melt

    def fields_of(st, per_atom):
        pos = st.positions
        f = [pos[..., i] for i in range(3)] + [st.velocities[..., i] for i in range(3)]
        if per_atom:
            f += [st.inv_masses, st.half_sigma, st.twice_sqrt_eps]
        return f + [st.atom_id]

    def drift(st):
        v = st.velocities
        return st._replace(positions=torch.where(
            st.valid[..., None], st.positions + (0.45 * SKIN / float(v.abs().max())) * v, 0.0))

    st, config, *_, n = melt(device)
    st = drift(st)
    m, h = config.cells_per_dim, float(config.cell_side)
    crowd = ((torch.arange(m**3, device=device) // m) % m == 0)[:, None] & st.valid
    crowded = st.positions.clone()
    crowded[..., 1] += torch.where(crowd, h, 0.0)
    jump = st.positions.clone()
    first = int(torch.nonzero(st.valid.reshape(-1))[0])
    jump[first // config.capacity, first % config.capacity, 0] += 2.0 * h
    box_t = torch.full((), config.box, dtype=torch.float32, device=device)
    label = f"{n} atoms M={m} C={config.capacity}"
    cases = [(f"{label}, nf=7", fields_of(st, False), st.valid, config),
             (f"{label}, nf=10", fields_of(st, True), st.valid, config),
             (f"{label}, nf=7, box a 0-d tensor", fields_of(st, False), st.valid, config._replace(box=box_t)),
             (f"{label}, nf=7, y pass overflows", fields_of(st._replace(positions=crowded), False), st.valid,
              config),
             (f"{label}, nf=7, a two-cell jump", fields_of(st._replace(positions=jump), False), st.valid, config)]
    st1, config1, *_, n1 = melt(device, N_CELLS_1M)
    cases.append((f"{n1} atoms M={config1.cells_per_dim} C={config1.capacity}, nf=7",
                  fields_of(drift(st1), False), st1.valid, config1))
    return cases


def aux_case(device):
    """(operands of `straggler_forces`' aux side, StragglerConfig, uniform
    params, label) on the smoke's production straggler state."""
    from emdee_tpu_torch import make_cell_dense_sim, straggler_init
    from emdee_tpu_torch.tools.melt import DT, SKIN, equilibrate, melt, straggler_config

    st, config, model, params, uni, n = melt(device)
    rollout, _ = make_cell_dense_sim(config, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    pos_eq, vel_eq, _, _ = equilibrate(rollout, st, config, n)
    del st
    sconfig = straggler_config(config, 4, 64, 16)
    ss = straggler_init(pos_eq, vel_eq, np.ones(n), params, sconfig, device=device)
    av = ss.aux_cell < sconfig.grid.num_cells
    vmax = max(float(ss.grid.velocities.abs().max()), float(ss.aux_velocities.abs().max()))
    step = 0.45 * SKIN / vmax
    p = torch.where(ss.grid.valid[..., None], ss.grid.positions + step * ss.grid.velocities, 0.0)
    a = torch.where(av[:, None], ss.aux_positions + step * ss.aux_velocities, 0.0)
    p, a = p.permute(2, 0, 1).contiguous(), a.t().contiguous()
    args = (p[0], p[1], p[2], ss.grid.valid, a[0], a[1], a[2], ss.aux_cell)
    label = (f"{n} atoms C_t={sconfig.grid.capacity} A={sconfig.aux_capacity} Kn={sconfig.kn}, "
             f"{int(av.sum())} parked")
    return args, sconfig, uni, label


def main(argv) -> None:
    from emdee_tpu_torch.neighbors import rebin_kernel, straggler_kernel
    from emdee_tpu_torch.neighbors.cell_dense import _box

    if not torch.cuda.is_available() or not argv:
        raise SystemExit("ab_rebin: needs a CUDA device and at least one DIR")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda", 0)
    a_lib = build.load()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {"A": None, **{chr(ord("B") + i): lib for i, lib in enumerate(_load_all(argv))}, "W": a_lib}
    print(f"{smi}: K4 and K3 aux A/B; A = the checkout, " + ", ".join(
        f"{k} = {d}" for k, d in zip(list(libs)[1:], argv)) + ", W = the checkout's witnesses", flush=True)
    grid = (ctypes.c_int * 4)()
    build.check(a_lib.emdee_rebin_routing_attrs(grid), "rebin_routing attrs")
    print(f"{smi}: A's cooperative grid: {grid[0]} blocks an SM, {grid[1]} SMs, {grid[2]} threads a block, "
          f"{grid[3]} rows a block at a time", flush=True)
    bits = []

    for label, fields, valid, config in rebin_cases(device):
        m, c, ns, box = config.cells_per_dim, config.capacity, config.num_slots, config.box
        core = {k: (lambda lib=lib, w=k == "W": rebin_core(lib, fields, valid, box, m, c, ns, w))
                for k, lib in libs.items()}
        ref = core["A"]()
        same = {k: _same(ref, run()) for k, run in list(core.items())[1:]}
        parked = rebin_kernel._parked(fields, valid, _box(box, fields[0]), True)
        alone = {k: (lambda lib=lib, w=k == "W": routing_parked(lib, parked, box, m, c, ns, w))
                 for k, lib in libs.items()}
        same_alone = {k: _same(ref, run()) for k, run in alone.items()}
        torch.cuda.synchronize()
        bits.append(all(same.values()) and all(same_alone.values()))
        live = int((ref[0][-1] < ns).sum())
        print(f"{smi}: K4 at {label}: flag {bool(ref[1])}, {live} live slots after ({int(valid.sum())} before); "
              "bit for bit A in every field and the flag: " + ", ".join(f"{k} {v}" for k, v in same.items())
              + "; on parked fields: " + ", ".join(f"{k} {v}" for k, v in same_alone.items()), flush=True)
        reps = 20 if m > 30 else 50
        _times(smi, f"K4 at {label}, the path's call", core, reps)
        _times(smi, f"K4 at {label}, routing parked fields", alone, reps)
        del parked
        torch.cuda.empty_cache()

    args, sconfig, uni, label = aux_case(device)
    out = {k: torch.empty((3, sconfig.aux_capacity), dtype=torch.float32, device=device) for k in libs}

    def aux_run(k):
        if k == "A":
            return lambda: straggler_kernel.launch_aux(*args, out[k], sconfig, uni)
        entry = "emdee_straggler_aux_warp" if k == "W" else "emdee_straggler_aux"
        return lambda: aux_call(libs[k], entry, args, out[k], sconfig, uni)

    runs = {k: aux_run(k) for k in libs}
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    same = {k: torch.equal(out["A"].view(torch.int32), out[k].view(torch.int32)) for k in list(libs)[1:]}
    bits.append(all(same.values()))
    empty = ~(args[7] < sconfig.grid.num_cells)
    print(f"{smi}: K3 aux at {label}: bit for bit A in every output: "
          + ", ".join(f"{k} {v}" for k, v in same.items())
          + f"; empty lanes exactly 0: {bool((out['A'][:, empty] == 0).all())}; largest |F| "
          f"{float(out['A'].abs().max()):.4f}", flush=True)
    _times(smi, f"K3 aux at {label}", runs, 200)
    print(f"{smi}: every version bit for bit A in every K4 and K3 aux case: {all(bits)}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
