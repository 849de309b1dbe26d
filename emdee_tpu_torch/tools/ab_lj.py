"""A/B the LJ resident force pass (K2a, K2b and K3's grid side) against
other versions of its source on the card, in one process: the checkout's
`csrc/cell_forces.cu` (A, through `cell_kernel`) and the one in each `DIR`
(B, C, …, each built alone into `build/emdee_tpu_torch/ab_lj_<i>.so`, with
the checkout's `lj_pair.cuh` unless `DIR` has one).  The inputs are the
smoke's: the 97,556-atom melt of `tools/melt.py` after its 200-step
equilibration, every atom then moved 0.45·skin along its velocity (M =
17, C = 32), and its straggler state at bench.py's production config (C_t
= 28, A = 64, Kn = 16) moved alike; with `--1m`, also the 1,000,188-atom
melt (M = 37, C = 32) drifted from the lattice.

Run from the repository root on a machine with a CUDA card, with the other
versions from an unpacked parent commit or a kept working copy:

    python3 -m emdee_tpu_torch.tools.ab_lj [--1m] DIR [DIR ...]

It prints, with `nvidia-smi`'s card name and power limit, the checkout's
registers, spills, shared bytes and resident blocks an SM for each
variant, then for each launch (K2a: uniform, forces, component arrays;
K2b: per-atom with energies, and forces only; K3's grid side) whether each
version's outputs equal A's bit for bit, and the CUDA-event ms of every
version in turns, forwards and back.  Each version must keep the C entries
`emdee_cell_forces` and `emdee_cell_forces_strag` with A's signatures.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from emdee_tpu_torch.csrc import build

ENTRIES = ("emdee_cell_forces", "emdee_cell_forces_strag")


def _load_all(dirs) -> list:
    """Build every DIR's `cell_forces.cu` at once, each into its own
    library, and load them."""
    paths = [build.BUILD_DIR / f"ab_lj_{i}.so" for i in range(len(dirs))]
    build._run([[build._nvcc(), *build.NVCC_FLAGS, "-I",
                 str(Path(d) if (Path(d) / "lj_pair.cuh").exists() else build.CSRC), "-shared", "-o", str(path),
                 str(Path(d) / "cell_forces.cu")] for d, path in zip(dirs, paths)])
    libs = []
    for path in paths:
        lib = ctypes.CDLL(str(path))
        for name in ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes = build._SIGNATURES[name]
            fn.restype = ctypes.c_int
        libs.append(lib)
    return libs


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _drift(pos, vel, valid, skin):
    """Every atom moved 0.45·skin along its velocity, unwrapped."""
    return torch.where(valid[..., None], pos + (0.45 * skin / float(vel.abs().max())) * vel, 0.0)


def _dense_runs(lib, st, config, uni):
    """{launch: callable} of one version on a dense state: K2a (the split
    entry), K2b with energies and K2b forces only."""
    from emdee_tpu_torch.neighbors import cell_kernel as ck
    from emdee_tpu_torch.neighbors.cell_dense import box_ptr

    comps = [st.positions[..., i].contiguous() for i in range(3)]
    stream = lambda: torch.cuda.current_stream(st.positions.device).cuda_stream  # noqa: E731
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

    def call(operands, outputs, params, energy):
        if lib is None:
            ck._launch(*operands, config, config.box, params, energy)
            return outputs
        build.check(lib.emdee_cell_forces(
            *(ptr(t) if isinstance(t, torch.Tensor) or t is None else t for t in operands[:13]),
            config.cells_per_dim, config.capacity, box_ptr(config.box, st.positions), *ck._pair_consts(config, params),
            int(params is not None), int(energy), stream()), "cell_forces (A/B version)")
        return outputs

    def split():
        return call(*ck.split_operands(*comps, st.valid, config), uni, False)

    def stacked(energy):
        return lambda: call(*ck.stacked_operands(st, config, None, energy), None, energy)

    return {"K2a (uniform, forces)": split, "K2b (per-atom, energies)": stacked(True),
            "K2b (per-atom, forces)": stacked(False)}


def _strag_run(lib, args, sconfig, uni):
    """K3's grid side of one version on the straggler state's operands."""
    from emdee_tpu_torch.neighbors import cell_kernel as ck
    from emdee_tpu_torch.neighbors.cell_dense import box_ptr

    cfg = sconfig.grid
    px, py, pz, valid, ax, ay, az, table = args

    def run():
        out = torch.empty((3,) + tuple(px.shape), dtype=torch.float32, device=px.device)
        if lib is None:
            ck.launch_strag(px, py, pz, valid, ax, ay, az, table, out, cfg, uni)
            return tuple(out)
        build.check(lib.emdee_cell_forces_strag(
            px.data_ptr(), py.data_ptr(), pz.data_ptr(), valid.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), ax.data_ptr(), ay.data_ptr(), az.data_ptr(), table.data_ptr(), table.shape[1],
            cfg.cells_per_dim, cfg.capacity, box_ptr(cfg.box, px), *ck._pair_consts(cfg, uni),
            torch.cuda.current_stream(px.device).cuda_stream), "cell_forces strag (A/B version)")
        return tuple(out)

    return run


def _compare(smi, what, runs, reps):
    """Bit for bit against A, then ms of every version in turns."""
    ref = runs["A"]()
    same = {}
    for k in list(runs)[1:]:
        got = runs[k]()
        torch.cuda.synchronize()
        same[k] = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(ref, got)
                      if a is not None)
    times = {k: [] for k in runs}
    for k in list(runs) + list(runs)[::-1]:
        times[k].append(_ms(runs[k], reps))
    print(f"{smi}: {what}: bit for bit A " + ", ".join(f"{k} {v}" for k, v in same.items()) + "; ms "
          + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v) for k, v in times.items()), flush=True)
    return same


def main(argv) -> None:
    from emdee_tpu_torch import cell_dense_init, make_cell_dense_sim, straggler_init
    from emdee_tpu_torch.neighbors.cell_dense_straggler import _bindings, _hood_matrix
    from emdee_tpu_torch.neighbors.cell_kernel import lj_resources
    from emdee_tpu_torch.tools.melt import DT, N_CELLS_1M, SKIN, equilibrate, melt, straggler_config

    big = "--1m" in argv
    dirs = [a for a in argv if a != "--1m"]
    if not torch.cuda.is_available() or not dirs:
        raise SystemExit("ab_lj: needs a CUDA device and at least one DIR")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda", 0)
    build.load()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {"A": None, **{chr(ord("B") + i): lib for i, lib in enumerate(_load_all(dirs))}}
    print(f"{smi}: K2a/K2b/K3 A/B; A = the checkout, " + ", ".join(f"{k} = {d}" for k, d in zip(list(libs)[1:], dirs)),
          flush=True)
    for name, flags in (("K2a", (True, False, False)), ("K2b energies", (False, True, False)),
                        ("K2b forces", (False, False, False)), ("K3 grid side", (True, False, True))):
        print(f"{smi}: A's {name} variant: {lj_resources(*flags)}", flush=True)

    st, config, model, params, uni, n = melt(device)
    rollout, _ = make_cell_dense_sim(config, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    pos_eq, vel_eq, _, _ = equilibrate(rollout, st, config, n)
    st = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, config, device=device)
    st = st._replace(positions=_drift(st.positions, st.velocities, st.valid, SKIN))
    bits = []
    for what in _dense_runs(None, st, config, uni):
        runs = {k: _dense_runs(lib, st, config, uni)[what] for k, lib in libs.items()}
        bits.append(_compare(smi, f"{what} at {n} atoms, M={config.cells_per_dim} C={config.capacity}", runs, 50))

    sconfig = straggler_config(config, 4, 64, 16)
    ss = straggler_init(pos_eq, vel_eq, np.ones(n), params, sconfig, device=device)
    nc = sconfig.grid.num_cells
    av = ss.aux_cell < nc
    vmax = max(float(ss.grid.velocities.abs().max()), float(ss.aux_velocities.abs().max()))
    step = 0.45 * SKIN / vmax
    gpos = torch.where(ss.grid.valid[..., None], ss.grid.positions + step * ss.grid.velocities, 0.0)
    apos = torch.where(av[:, None], ss.aux_positions + step * ss.aux_velocities, 0.0)
    table, _ = _bindings(ss.aux_cell, av, sconfig, _hood_matrix(sconfig.grid.cells_per_dim, device))
    p = gpos.permute(2, 0, 1).contiguous()
    a = apos.t().contiguous()
    args = (p[0], p[1], p[2], ss.grid.valid, a[0], a[1], a[2], table)
    runs = {k: _strag_run(lib, args, sconfig, uni) for k, lib in libs.items()}
    bits.append(_compare(smi, f"K3 grid side at {n} atoms, C_t={sconfig.grid.capacity} Kn={sconfig.kn}, "
                         f"{int(av.sum())} parked, {int((table >= 0).sum())} list entries", runs, 50))

    if big:
        st, config, _, _, uni, n = melt(device, N_CELLS_1M)
        st = st._replace(positions=_drift(st.positions, st.velocities, st.valid, SKIN))
        for what in _dense_runs(None, st, config, uni):
            runs = {k: _dense_runs(lib, st, config, uni)[what] for k, lib in libs.items()}
            bits.append(_compare(smi, f"{what} at {n} atoms, M={config.cells_per_dim} C={config.capacity}", runs, 20))
    print(f"{smi}: every version bit for bit A in every launch: {all(all(b.values()) for b in bits)}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
