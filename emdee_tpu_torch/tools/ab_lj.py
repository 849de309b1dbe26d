"""A/B the LJ resident force pass (K2a, K2b and K3's grid side; with
`--ghost` its GHOST mode K2-G, the grid's per-shard pass) against other
versions of its source on the card, in one process: the checkout's
`csrc/cell_forces.cu` (A, through `cell_kernel`) and the one in each `DIR`
(B, C, …, each built alone into `build/emdee_tpu_torch/ab_lj_<i>.so`, with
the checkout's `lj_pair.cuh` unless `DIR` has one).  The inputs are the
smoke's: the 97,556-atom melt of `tools/melt.py` after its 200-step
equilibration, every atom then moved 0.45·skin along its velocity (M =
17, C = 32), and its straggler state at bench.py's production config (C_t
= 28, A = 64, Kn = 16) moved alike; with `--1m`, also the 1,000,188-atom
melt (M = 37, C = 32) drifted from the lattice.  With `--ghost`, K2-G in
place of those launches, on the smoke's grid states: the equilibrated
97,556-atom melt on (1,1,1) at M = 17 and, at
`reconfigure_dense_state(cells_multiple_of=2)`'s M = 16, C = 40, on
(2,2,2); with `--1m` also the 1M melt at `melt.even_config`'s M = 36, C =
40 on (2,2,2); each drifted 0.45·skin, its shards' ghost grids built as
the grid engine builds them (`LocalMesh`, every shard on the card).

Run from the repository root on a machine with a CUDA card, with the other
versions from an unpacked parent commit or a kept working copy:

    python3 -m emdee_tpu_torch.tools.ab_lj [--1m] [--ghost] DIR [DIR ...]

It prints, with `nvidia-smi`'s card name and power limit, the checkout's
registers, spills, shared bytes and resident blocks an SM for each
variant, then for each launch (K2a: uniform, forces, component arrays;
K2b: per-atom with energies, and forces only; K3's grid side) whether each
version's outputs equal A's bit for bit, and the CUDA-event ms of every
version in turns, forwards and back (`--ghost`: K2-G uniform forces,
per-atom with energies and per-atom forces).  Each version must keep the
C entries `emdee_cell_forces`, `emdee_cell_forces_strag` and
`emdee_cell_forces_ghost` with A's signatures.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from emdee_tpu_torch.csrc import build

ENTRIES = ("emdee_cell_forces", "emdee_cell_forces_strag", "emdee_cell_forces_ghost")


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


def _ghost_runs(lib, gh, mesh, config, uni):
    """{launch: callable} of one version's GHOST mode (K2-G) on the ghost
    grids `gh` (x, y, z with NaN in empty slots, σ/2, 2√ε) of `mesh`'s
    shards: uniform forces, per-atom with energies, per-atom forces."""
    from emdee_tpu_torch.neighbors import cell_kernel as ck
    from emdee_tpu_torch.neighbors.cell_dense import box_ptr

    sz, sy, sx = mesh.local_shape
    gz, gy, gx, c = gh.shape[-4:]
    local = (sz, sy, sx, gz - 2, gy - 2, gx - 2, c)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

    def call(params, energy):
        ghost = gh[:3] if params is not None else gh

        def run():
            if lib is None:
                return ck.ghost_forces(ghost, mesh.local_shape, mesh.base, config, None, uniform_params=params,
                                       compute_energy=energy, backend="cuda")
            f = torch.empty((3,) + local, dtype=torch.float32, device=gh.device)
            e = torch.empty(local, dtype=torch.float32, device=gh.device) if energy else None
            w = torch.empty(local, dtype=torch.float32, device=gh.device) if energy else None
            hs, tse = (None, None) if params is not None else (gh[3], gh[4])
            build.check(lib.emdee_cell_forces_ghost(
                gh[0].data_ptr(), gh[1].data_ptr(), gh[2].data_ptr(), ptr(hs), ptr(tse), f[0].data_ptr(),
                f[1].data_ptr(), f[2].data_ptr(), ptr(e), ptr(w), gz - 2, gy - 2, gx - 2, sz * sy * sx, sy, sx,
                *mesh.base, config.cells_per_dim, c, box_ptr(config.box, gh), *ck._pair_consts(config, params),
                int(params is not None), int(energy), torch.cuda.current_stream(gh.device).cuda_stream),
                "cell_forces ghost (A/B version)")
            return f, e, w
        return run

    return {"K2-G (uniform, forces)": call(uni, False), "K2-G (per-atom, energies)": call(None, True),
            "K2-G (per-atom, forces)": call(None, False)}


def _ghost_states(device, big):
    """(label, state, config, mesh shape) of the smoke's grid states, each
    drifted 0.45·skin: the equilibrated 97,556-atom melt at M = 17 on
    (1,1,1) and at M = 16, C = 40 on (2,2,2); with `big` the 1M melt at
    M = 36, C = 40 on (2,2,2).  Also the uniform parameters."""
    from emdee_tpu_torch import cell_dense_init, gather_dense_atoms, make_cell_dense_sim, reconfigure_dense_state
    from emdee_tpu_torch.tools.melt import DT, N_CELLS_1M, SKIN, equilibrate, even_config, melt

    st, config, model, params, uni, n = melt(device)
    rollout, _ = make_cell_dense_sim(config, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    pos_eq, vel_eq, _, _ = equilibrate(rollout, st, config, n)
    st17 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, config, device=device)
    st16, cfg16 = reconfigure_dense_state(st17, config, cells_multiple_of=2)
    drift = lambda s: s._replace(positions=_drift(s.positions, s.velocities, s.valid, SKIN))  # noqa: E731
    states = [(f"{n} atoms (1,1,1) M=17 C={config.capacity}", drift(st17), config, (1, 1, 1)),
              (f"{n} atoms (2,2,2) M=16 C={cfg16.capacity}", drift(st16), cfg16, (2, 2, 2))]
    if big:
        st37, config37, _, params37, _, n37 = melt(device, N_CELLS_1M)
        cfg36 = even_config(st37, config37)
        pos, vel = gather_dense_atoms(st37, n37)
        st36 = cell_dense_init(pos, vel, np.ones(n37), params37, cfg36, device=device)
        states.append((f"{n37} atoms (2,2,2) M=36 C={cfg36.capacity}", drift(st36), cfg36, (2, 2, 2)))
    return states, uni


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

    big, ghost = "--1m" in argv, "--ghost" in argv
    dirs = [a for a in argv if a not in ("--1m", "--ghost")]
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
                        ("K2b forces", (False, False, False)), ("K3 grid side", (True, False, True)),
                        ("K2-G uniform", (True, False, False, True)), ("K2-G energies", (False, True, False, True)),
                        ("K2-G forces", (False, False, False, True))):
        print(f"{smi}: A's {name} variant: {lj_resources(*flags)}", flush=True)
    if ghost:
        _ghost_main(smi, device, libs, big)
        return

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


def _ghost_main(smi, device, libs, big) -> None:
    """K2-G of every version on the smoke's grid states: bit for bit A, ms
    in turns."""
    from emdee_tpu_torch.distributed.grid_sharded import _ghost3, distribute_grid
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh

    states, uni = _ghost_states(device, big)
    bits = []
    for label, st, config, shape in states:
        mesh = make_grid_mesh(shape, device=device)
        sh = distribute_grid(st, config, mesh)
        gh = _ghost3(torch.cat([torch.where(sh.valid, sh.positions.movedim(-1, 0), float("nan")),
                                sh.half_sigma[None], sh.twice_sqrt_eps[None]]), mesh)
        for what in _ghost_runs(None, gh, mesh, config, uni):
            runs = {k: _ghost_runs(lib, gh, mesh, config, uni)[what] for k, lib in libs.items()}
            bits.append(_compare(smi, f"{what} at {label}", runs, 20 if config.num_atoms > 500_000 else 50))
        del sh, gh
        torch.cuda.empty_cache()
    print(f"{smi}: every version bit for bit A in every K2-G launch: {all(all(b.values()) for b in bits)}",
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
