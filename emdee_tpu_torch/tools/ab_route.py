"""A/B the spill route (K7) and the grid's rebin pass (K6) against other
versions of their sources on the card, in one process:

- A: the checkout's, through the package — K7 as the spill configs' rebin
  calls it (`compact_kernel.spill_routing`, one cooperative launch a
  rebin), K6 as the grid's rebin calls it (`halo_planes` and
  `rebin_halo_pass` three times);
- B, C, …: each DIR's `spill_routing.cu` (where it has one),
  `compact_window.cu` and `rebin_window.cu` (an unpacked parent commit's
  `csrc/` or a kept working copy, with its own `rebin_row.cuh`, else the
  checkout's), built together into `build/emdee_tpu_torch/ab_route_<i>.so`:
  its spill routing kernel where the source has `emdee_spill_routing`,
  else the torch masks and ranks with its `emdee_compact_window` three
  times a rebin; its halo kernel where the source has `emdee_rebin_halo`,
  else the torch park and stack and, each pass, whole windows built by
  `torch.cat` and its `emdee_rebin_window`;
- W: the checkout's witnesses of the former designs: the torch masks with
  `compact_window.cu` (`compact_kernel.spill_route_plain(compact='cuda')`)
  and `rebin_window_kernel.grid_rebin_witness`.

Run from the repository root on a machine with a CUDA card, with DIR an
unpacked parent's `csrc/` (e.g. `git archive HEAD~1 emdee_tpu_torch/csrc`
unpacked under `build/`):

    python3 -m emdee_tpu_torch.tools.ab_route DIR [DIR ...]

K7 cases: the 97,556-atom melt of `tools/melt.py` after its 200-step
equilibration, re-initialised on its spill config (M = 16, C = 32, squeezed
toward 28) and drifted 0.45·skin along the velocities, with the component
carry's seven fields (positions and velocities as strided views of their
(M³, C, 3) tensors, atom id), the valid mask and the wrap; and the state
before the rebin that raises the unsqueezed config's flag (found by running
that config's component carry block by block); the 1,000,188-atom melt's
lattice start on its spill config (M = 35, C = 32, squeezed toward 28),
drifted alike.  K6 cases, each drifted
0.45·skin with the grid's ten fields: the 97,556-atom melt as one shard (M
= 17, C = 32), on (2,2,2) at M = 16, C = 40, and the 1,000,188-atom melt on
(2,2,2) at M = 36, C = 40 (`melt.even_config`), every shard on the card
(`LocalMesh`).  For each case it prints whether every version equals A bit
for bit in every field, the valid mask (K7) and the flag, then the ms of
every version in turns, forwards and back, on both clocks — CUDA events
around back-to-back calls (the host in the loop) and around calls queued
behind a device spin (the device clock) — of the whole rebin as the path
calls it, and for K6 of the z and y passes' kernel alone (the z pass on
the raw fields) beside the former kernel on pre-built windows.  First the
card's name and power limit and A's K7 cooperative grid.
"""

from __future__ import annotations

import contextlib
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from emdee_tpu_torch.csrc import build
from emdee_tpu_torch.tools.ab_rebin import _times

SOURCES = ("spill_routing.cu", "compact_window.cu", "rebin_window.cu")
ENTRIES = ("emdee_spill_routing", "emdee_compact_window", "emdee_rebin_halo", "emdee_rebin_window")


def _load_all(dirs) -> list:
    """Build every DIR's sources at once, each DIR into its own library, and
    load them."""
    paths = [build.BUILD_DIR / f"ab_route_{i}.so" for i in range(len(dirs))]
    build._run([[build._nvcc(), *build.NVCC_FLAGS, "-I", str(Path(d)), "-I", str(build.CSRC), "-shared", "-o",
                 str(path), *(str(Path(d) / s) for s in SOURCES if (Path(d) / s).exists())]
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


@contextlib.contextmanager
def _kernels_of(lib):
    """The package's kernel wrappers launch `lib`'s entries meanwhile."""
    saved = build.load
    build.load = lambda: lib
    try:
        yield
    finally:
        build.load = saved


def spill_version(lib, args):
    """The spill route as the rebin calls it on a version: `lib` None is the
    checkout's kernel; a library with
    `emdee_spill_routing` is called as the checkout calls it; else the torch
    masks with its compaction kernel.  Returns (fields, valid, flag)."""
    from emdee_tpu_torch.neighbors.compact_kernel import spill_route_plain, spill_routing

    if lib is None:
        return spill_routing(*args, backend="cuda")
    with _kernels_of(lib):
        if hasattr(lib, "emdee_spill_routing"):
            return spill_routing(*args, backend="cuda")
        return spill_route_plain(*args, compact="cuda")


def grid_version(lib, fields, mesh, local, box, m, c, ns):
    """The grid's rebin on a version: `lib` None is the checkout's halo
    kernel as the engine calls it; a library with `emdee_rebin_halo` the
    same through it; else the former rebin (`grid_rebin_witness`) through
    its window kernel.  Returns (out, flag)."""
    from emdee_tpu_torch.neighbors import rebin_window_kernel as k6

    def halo():
        x, flag = fields, None
        for axis in range(3):
            lo, hi = k6.halo_planes(x, mesh, axis)
            x, flag = k6.rebin_halo_pass(x, lo, hi, k6.global_coords(mesh, local, axis), box, axis, m, c, ns,
                                         raw=axis == 0, flag=flag, backend="cuda")
        return x, flag != 0

    if lib is None:
        return halo()
    with _kernels_of(lib):
        return halo() if hasattr(lib, "emdee_rebin_halo") else k6.grid_rebin_witness(fields, mesh, local, box, m,
                                                                                      c, ns)


def _flat(r) -> list:
    return [t.view(torch.int32) if t.dtype == torch.float32 else t for t in list(r[0]) + list(r[1:])]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b), strict=True))


def spill_cases(device):
    """(label, spill_routing's arguments) of the K7 cases."""
    from emdee_tpu_torch import cell_dense_init, gather_dense_atoms, make_cell_dense_sim
    from emdee_tpu_torch.neighbors.cell_dense import _spill_params
    from emdee_tpu_torch.tools.melt import DT, N_CELLS_1M, SKIN, equilibrate, melt, spill_config

    st, config, model, params, uni, n = melt(device)
    rollout, _ = make_cell_dense_sim(config, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    pos_eq, vel_eq, _, k = equilibrate(rollout, st, config, n)
    del st
    scfg = spill_config(config)

    def args_of(s, cfg):
        f = [s.positions[..., i] for i in range(3)] + [s.velocities[..., i] for i in range(3)] + [s.atom_id]
        return (f, cfg.box, cfg.cells_per_dim, cfg.capacity, cfg.num_slots, _spill_params(cfg), s.valid)

    ss = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, scfg, device=device)
    v = ss.velocities
    sd = ss._replace(positions=torch.where(ss.valid[..., None], ss.positions + (0.45 * SKIN / float(v.abs().max())) * v,
                                           0.0))
    label = f"{n} atoms M={scfg.cells_per_dim} C={scfg.capacity} squeeze target {scfg.spill_target}, nf=7"
    cases = [(f"{label}, drifted", args_of(sd, scfg))]
    plain_cfg = scfg._replace(spill_target=0)
    roll0, _ = make_cell_dense_sim(plain_cfg, model, dt=DT, uniform_params=uni, uniform_mass=1.0)
    prev = s0 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, plain_cfg, device=device)
    blocks, cur = 0, s0
    while blocks < 200 and not bool(cur.overflow):
        prev, cur, blocks = cur, roll0(cur, num_steps=k, rebin_every=k), blocks + 1
    if bool(cur.overflow):
        cases.append((f"{n} atoms M={plain_cfg.cells_per_dim} C={plain_cfg.capacity} without squeeze, the state "
                      f"before the rebin that raises the flag (block {blocks} of {k} steps), nf=7",
                      args_of(prev, plain_cfg)))
    else:
        print(f"no flag in {blocks} rebin blocks of the unsqueezed spill config", flush=True)
    del ss, sd, prev, cur, s0
    st, config, _, params, _, n = melt(device, N_CELLS_1M)
    cfg = spill_config(config)
    pos, vel = gather_dense_atoms(st, n)
    del st
    s1 = cell_dense_init(pos, vel, np.ones(n), params, cfg, device=device)
    if bool(s1.overflow):
        print(f"the {n}-atom spill init overflows at M={cfg.cells_per_dim} C={cfg.capacity}: no 1M case", flush=True)
    else:
        v = s1.velocities
        s1 = s1._replace(positions=torch.where(s1.valid[..., None],
                                               s1.positions + (0.45 * SKIN / float(v.abs().max())) * v, 0.0))
        cases.append((f"{n} atoms M={cfg.cells_per_dim} C={cfg.capacity} squeeze target {cfg.spill_target} from the "
                      "lattice, nf=7, drifted", args_of(s1, cfg)))
    return cases


def grid_cases(device):
    """(label, fields, mesh, local, config) of the K6 cases."""
    from emdee_tpu_torch import cell_dense_init, gather_dense_atoms
    from emdee_tpu_torch.distributed.grid_sharded import distribute_grid
    from emdee_tpu_torch.distributed.mesh import LocalMesh
    from emdee_tpu_torch.tools.melt import N_CELLS, N_CELLS_1M, SKIN, even_config, melt

    def drift(s):
        v = s.velocities
        return s._replace(positions=torch.where(s.valid[..., None], s.positions + (0.45 * SKIN / float(v.abs().max()))
                                                * v, 0.0))

    def fields_of(sh, ns):
        pos3, vel3 = sh.positions.movedim(-1, 0), sh.velocities.movedim(-1, 0)
        return ([pos3[i] for i in range(3)] + [vel3[i] for i in range(3)]
                + [sh.inv_masses, sh.half_sigma, sh.twice_sqrt_eps, torch.where(sh.valid, sh.atom_id, ns)])

    for cells, shapes in ((N_CELLS, ((1, 1, 1), (2, 2, 2))), (N_CELLS_1M, ((2, 2, 2),))):
        st, config, _, params, _, n = melt(device, cells)
        for shape in shapes:
            cfg, s = config, st
            if shape != (1, 1, 1):
                cfg = even_config(st, config)
                pos, vel = gather_dense_atoms(st, n)
                s = cell_dense_init(pos, vel, np.ones(n), params, cfg, device=device)
            m = cfg.cells_per_dim
            mesh = LocalMesh(shape, device)
            sh = distribute_grid(drift(s), cfg, mesh)
            yield (f"{n} atoms {shape} M={m} C={cfg.capacity}, nf=10", fields_of(sh, cfg.num_slots), mesh,
                   tuple(m // d for d in shape), cfg)
            del sh
        del st
        torch.cuda.empty_cache()


def main(argv) -> None:
    from emdee_tpu_torch.neighbors import rebin_window_kernel as k6

    if not torch.cuda.is_available() or not argv:
        raise SystemExit("ab_route: needs a CUDA device and at least one DIR")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda", 0)
    a_lib = build.load()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    dirs = {chr(ord("B") + i): lib for i, lib in enumerate(_load_all(argv))}
    print(f"{smi}: K7 and K6 A/B; A = the checkout, " + ", ".join(f"{k} = {d}" for k, d in zip(dirs, argv))
          + ", W = the checkout's witnesses", flush=True)
    grid = (ctypes.c_int * 4)()
    build.check(a_lib.emdee_spill_routing_attrs(grid), "spill_routing attrs")
    print(f"{smi}: A's K7 cooperative grid: {grid[0]} blocks an SM, {grid[1]} SMs, {grid[2]} threads a block, "
          f"{grid[3]} rows a block at a time", flush=True)
    bits = []

    for label, args in spill_cases(device):
        from emdee_tpu_torch.neighbors.compact_kernel import spill_route_plain

        runs = {"A": lambda: spill_version(None, args),                 **{k: (lambda lib=lib: spill_version(lib, args)) for k, lib in dirs.items()},
                "W": lambda: spill_route_plain(*args, compact="cuda")}
        ref = runs["A"]()
        same = {k: _same(ref, run()) for k, run in list(runs.items())[1:]}
        torch.cuda.synchronize()
        bits.append(all(same.values()))
        print(f"{smi}: K7 at {label}: flag {bool(ref[2])}, {int(ref[1].sum())} live slots after "
              f"({int(args[6].sum())} before); bit for bit A in every field, the mask and the flag: "
              + ", ".join(f"{k} {v}" for k, v in same.items()), flush=True)
        _times(smi, f"K7 at {label}, the rebin as the path calls it", runs, 50)

    for label, fields, mesh, local, cfg in grid_cases(device):
        m, c, ns = cfg.cells_per_dim, cfg.capacity, cfg.num_slots
        box = torch.full((), cfg.box, dtype=torch.float32, device=device)
        runs = {"A": lambda: grid_version(None, fields, mesh, local, box, m, c, ns),
                **{k: (lambda lib=lib: grid_version(lib, fields, mesh, local, box, m, c, ns))
                   for k, lib in dirs.items()},
                "W": lambda: k6.grid_rebin_witness(fields, mesh, local, box, m, c, ns)}
        ref = runs["A"]()
        same = {k: _same(ref, run()) for k, run in list(runs.items())[1:]}
        torch.cuda.synchronize()
        bits.append(all(same.values()))
        moved = int(((ref[0][-1] != fields[-1]) & (ref[0][-1] < ns)).sum())
        print(f"{smi}: K6 at {label}: flag {bool(ref[1])}, {moved} slots moved; bit for bit A in every field and "
              "the flag: " + ", ".join(f"{k} {v}" for k, v in same.items()), flush=True)
        reps = 20 if m > 30 else 50
        _times(smi, f"K6 at {label}, the rebin as the grid calls it", runs, reps)
        # Each pass's kernel alone: the halo kernel (the z pass on the raw
        # fields), and the former kernel on the pass's pre-built windows.
        x, raw = fields, True
        for axis in range(2):
            lo, hi = k6.halo_planes(x, mesh, axis)
            h_args = (x, lo, hi, k6.global_coords(mesh, local, axis), box, axis, m, c, ns, raw)
            xs = torch.stack(k6._parked(x, box, ns)) if raw else x
            w_args = k6.whole_windows(xs, *k6.halo_planes(xs, mesh, axis), axis) + (
                k6.global_coords(mesh, local, axis), box, k6.COORD_OF_AXIS[axis], m, c, ns)

            def window(lib, w_args=w_args):
                with _kernels_of(lib):
                    return k6.rebin_window_pass(*w_args, backend="cuda")

            def halo(lib, h_args=h_args):
                with _kernels_of(lib):
                    return k6.rebin_halo_pass(*h_args, backend="cuda")

            alone = {"A": lambda h_args=h_args: k6.rebin_halo_pass(*h_args, backend="cuda"),
                     **{k: (lambda lib=lib: halo(lib) if hasattr(lib, "emdee_rebin_halo") else window(lib))
                        for k, lib in dirs.items()},
                     "W": lambda: window(a_lib)}
            _times(smi, f"K6 at {label}, the {'zy'[axis]} pass's kernel alone (the halo kernels "
                        + ("on the raw fields" if raw else "on the z pass's output")
                        + ", the former kernels on pre-built windows)", alone, reps)
            x, raw = k6.rebin_halo_pass(*h_args, backend="cuda")[0], False
            del xs, w_args
        torch.cuda.empty_cache()
    print(f"{smi}: every version bit for bit A in every K7 and K6 case: {all(bits)}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
