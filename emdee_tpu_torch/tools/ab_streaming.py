"""A/B the one-card streaming LJ pass (K5) against other versions of it —
a parent's warp-owned K5, or the pencil kernel it replaced — on the card,
in one process.  Builds of K5's part of
`csrc/cell_forces_streaming.cu` (`-DEMDEE_PART=0`), each into its own
library under `build/emdee_tpu_torch/`, all compiled at once:

- A: the checkout's, through `streaming_kernel` (the package's library);
- B, C, …: the one in each DIR (an unpacked parent commit's `csrc/` or a
  kept working copy, with its own `lj_pair.cuh` if it has one, else the
  checkout's): the pencil kernel through its entry signatures, which this
  tool keeps (`PENCIL_SIGNATURES`), or, where the source has
  `emdee_streaming_attrs`, a warp-owned K5 through the checkout's;
- W: the checkout's without the cull (`-DEMDEE_K5_NO_CULL`), the witness:
  each phase's sums are then formed as the pencil's, so W should equal B
  bit for bit.

Run from the repository root on a machine with a CUDA card, with DIR an
unpacked parent's `csrc/` (e.g. `git archive HEAD~1 emdee_tpu_torch/csrc`
unpacked under `build/`):

    python3 -m emdee_tpu_torch.tools.ab_streaming DIR [DIR ...]

On the 97,556- and 1,000,188-atom melts of `tools/melt.py`, every atom
moved 0.45·skin along its velocity (across cell faces and the seam), for
K5's two entries — the split one (uniform parameters, forces) and the
stacked one (per-atom parameters, forces, and with energies) — it prints
whether each warp-owned DIR equals A bit for bit in every output (a
parent's K5 at C ≤ 96, where the checkout runs the same variants), whether
W equals each pencil DIR bit for bit (else the largest difference), the
largest difference of every version from B (gated at 2e-5 of the force
scale), and the CUDA-event ms of each version in turns A, B, C, …, W and
back, with the resident kernel's (K2a, K2b) beside them; first the card's
name and power limit and A's variants' registers, spills, shared bytes and
blocks an SM.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

from emdee_tpu_torch.csrc import build

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
# The pencil kernel's C entries: px, py, pz, pstride, hs, tse, valid, fx,
# fy, fz, fstride, e, w, groups, m, c, box (device), rc2 … eps4_u, uniform,
# energy, stream; and its fold, fx, fy, fz, fstride, e, w, groups,
# num_slots, energy, stream.
PENCIL_SIGNATURES = {
    "emdee_streaming_forces": [_P] * 3 + [_I] + [_P] * 6 + [_I] + [_P] * 3 + [_I, _I, _P] + [_F] * 10 + [_I, _I, _P],
    "emdee_streaming_fold": [_P, _P, _P, _I, _P, _P, _P, _L, _I, _P],
}
_PENCIL_GROUPS = 4  # the pencil's reaction row groups


def _load(jobs) -> dict:
    """Build every (name, source dir, defines, signatures) at once, each
    into its own library, and load them with those entry signatures:
    {name: CDLL}."""
    paths = {name: build.BUILD_DIR / f"ab_streaming_{name}.so" for name, *_ in jobs}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    build._run([[build._nvcc(), *build.NVCC_FLAGS, "-DEMDEE_PART=0", *defines, "-I",
                 str(src if (src / "lj_pair.cuh").exists() else build.CSRC), "-shared", "-o", str(paths[name]),
                 str(src / "cell_forces_streaming.cu")] for name, src, defines, _ in jobs])
    libs = {}
    for name, _, _, sigs in jobs:
        lib = ctypes.CDLL(str(paths[name]))
        for entry, argtypes in sigs.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _owned_run(lib):
    """A warp-owned build's pair pass and fold on launch operands."""
    from emdee_tpu_torch.neighbors.cell_dense import box_ptr
    from emdee_tpu_torch.neighbors.cell_kernel import _pair_consts
    from emdee_tpu_torch.neighbors.streaming_kernel import _ptr, scratch_bytes

    def run(operands, config, uni, energy):
        px, py, pz, pstride, hs, tse, valid, fx, fy, fz, fstride, e, w = operands
        slices = torch.empty(scratch_bytes(config, energy) // 4, dtype=torch.float32, device=px.device)
        stream = torch.cuda.current_stream(px.device).cuda_stream
        build.check(lib.emdee_streaming_forces(
            _ptr(px), _ptr(py), _ptr(pz), pstride, _ptr(hs), _ptr(tse), _ptr(valid), slices.data_ptr(),
            config.cells_per_dim, config.capacity, box_ptr(config.box, px), *_pair_consts(config, uni),
            int(uni is not None), int(energy), stream), "A/B pair pass")
        build.check(lib.emdee_streaming_fold(_ptr(fx), _ptr(fy), _ptr(fz), fstride, _ptr(e), _ptr(w),
                                             slices.data_ptr(), config.num_slots, int(energy), stream),
                    "A/B fold")

    return run


def _pencil_run(lib):
    """The pencil kernel's pair pass and fold (B) on launch operands."""
    from emdee_tpu_torch.neighbors.cell_dense import box_ptr
    from emdee_tpu_torch.neighbors.cell_kernel import _pair_consts
    from emdee_tpu_torch.neighbors.streaming_kernel import _ptr

    def run(operands, config, uni, energy):
        px, py, pz, pstride, hs, tse, valid, fx, fy, fz, fstride, e, w = operands
        groups = torch.empty((_PENCIL_GROUPS, 5 if energy else 3, config.num_slots), dtype=torch.float32,
                             device=px.device)
        stream = torch.cuda.current_stream(px.device).cuda_stream
        build.check(lib.emdee_streaming_forces(
            _ptr(px), _ptr(py), _ptr(pz), pstride, _ptr(hs), _ptr(tse), _ptr(valid), _ptr(fx), _ptr(fy), _ptr(fz),
            fstride, _ptr(e), _ptr(w), groups.data_ptr(), config.cells_per_dim, config.capacity,
            box_ptr(config.box, px), *_pair_consts(config, uni), int(uni is not None), int(energy), stream),
            "B pair pass")
        build.check(lib.emdee_streaming_fold(_ptr(fx), _ptr(fy), _ptr(fz), fstride, _ptr(e), _ptr(w),
                                             groups.data_ptr(), config.num_slots, int(energy), stream), "B fold")

    return run


def _a_run(operands, config, uni, energy):
    from emdee_tpu_torch.neighbors import streaming_kernel

    streaming_kernel._launch(*operands, config, config.box, uni, energy)


def main(argv) -> None:
    if not argv or not torch.cuda.is_available():
        raise SystemExit("usage on a CUDA machine: python3 -m emdee_tpu_torch.tools.ab_streaming DIR [DIR ...]")
    import chip_smoke
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces, cell_forces_split, split_operands, stacked_operands
    from emdee_tpu_torch.neighbors.streaming_kernel import K5_SLICES, k5_resources
    from emdee_tpu_torch.tools.melt import N_CELLS, N_CELLS_1M, SKIN, melt

    smi = chip_smoke.card()
    device = torch.device("cuda", 0)
    build.load()
    sigs = {name: build._SIGNATURES[name] for name in ("emdee_streaming_forces", "emdee_streaming_fold")}
    dirs = {chr(ord("B") + i): Path(d) for i, d in enumerate(argv)}
    owned = {k: "emdee_streaming_attrs" in (d / "cell_forces_streaming.cu").read_text() for k, d in dirs.items()}
    libs = _load([(k, d, [], sigs if owned[k] else PENCIL_SIGNATURES) for k, d in dirs.items()]
                 + [("W", build.CSRC, ["-DEMDEE_K5_NO_CULL"], sigs)])
    runs = {"A": _a_run, **{k: _owned_run(libs[k]) if owned[k] else _pencil_run(libs[k]) for k in dirs},
            "W": _owned_run(libs["W"])}
    print(f"{smi}: K5 A/B; A = the checkout ({K5_SLICES} slices), "
          + ", ".join(f"{k} = {'warp-owned' if owned[k] else 'the pencil'} in {d}" for k, d in dirs.items())
          + ", W = A without the cull", flush=True)
    witness, same_a = [], []
    pencils = [k for k in dirs if not owned[k]]
    for cells in (N_CELLS, N_CELLS_1M):
        st, config, model, _, uni, n = melt(device, cells)
        st = chip_smoke.drifted(st, SKIN)
        v = st.valid
        comps = tuple(st.positions[..., i].contiguous() for i in range(3))
        for name, u, e in (("A", True, False), ("A", False, False), ("A", False, True)):
            print(f"{smi}: {n} atoms, {name}'s variant uniform={u} energies={e}: {k5_resources(config, u, e)}",
                  flush=True)
        launches = {
            "split (uniform, forces)": (lambda: split_operands(*comps, v, config), uni, False,
                                        lambda: cell_forces_split(*comps, v, config, uniform_params=uni,
                                                                  backend="cuda")),
            "stacked (per-atom, forces)": (lambda: stacked_operands(st, config, None, False), None, False,
                                           lambda: cell_forces(st, model, config, backend="cuda")),
            "stacked (per-atom, energies)": (lambda: stacked_operands(st, config, None, True), None, True,
                                             lambda: cell_forces(st, model, config, compute_energy=True,
                                                                 backend="cuda")),
        }
        big = n > 500_000
        for what, (operands, params, energy, k2) in launches.items():
            outs = {}
            for key, run in runs.items():
                ops, out = operands()
                run(ops, config, params, energy)
                outs[key] = [t for t in out if t is not None]
            torch.cuda.synchronize()
            forces = lambda o: o[0] if len(o) == 1 or o[0].dim() == 3 else torch.stack(o[:3], -1)  # noqa: E731
            ref = forces(outs["B"])
            scale = max(float(ref[v].abs().max()), 1.0)
            diffs = {k: chip_smoke.close(f"{k} vs B {what} at {n}", forces(outs[k])[v], ref[v], atol=2e-5 * scale)
                     for k in runs if k != "B"}
            bits = lambda x, y: all(torch.equal(a.view(torch.int32), b.view(torch.int32))  # noqa: E731
                                    for a, b in zip(outs[x], outs[y]))
            owned_same = {k: bits(k, "A") for k in dirs if owned[k]}
            same_a += list(owned_same.values())
            pencil_same = {k: bits("W", k) for k in pencils}
            witness += list(pencil_same.values())
            worst = {k: max(float((a.double() - b.double()).abs().max()) for a, b in zip(outs["W"], outs[k]))
                     for k in pencils}

            def timed(run):
                def call():
                    ops, _ = operands()
                    run(ops, config, params, energy)
                return call

            times = {k: [] for k in runs}
            for k in list(runs) + list(runs)[::-1]:
                times[k].append(chip_smoke.cuda_ms(timed(runs[k]), 20 if big else 50))
            k2_ms = chip_smoke.cuda_ms(k2, 20 if big else 50)
            print(f"{smi}: {what} at {n} atoms (M={config.cells_per_dim} C={config.capacity}): bit for bit A "
                  + ", ".join(f"{k} {v}" for k, v in owned_same.items()) + "; W bit for bit the pencil "
                  + ", ".join(f"{k} {v} (largest |W - {k}| {worst[k]:.3e})" for k, v in pencil_same.items())
                  + f"; max |dF| vs B (scale {scale:.1f}) "
                  + ", ".join(f"{k} {d:.3e}" for k, d in diffs.items()) + "; ms "
                  + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in ts) for k, ts in times.items())
                  + f"; K2 {k2_ms:.4f}", flush=True)
        del st
        torch.cuda.empty_cache()
    if same_a:
        print(f"{smi}: every warp-owned version bit for bit A in every launch: {all(same_a)}", flush=True)
    if witness:
        print(f"{smi}: the cull-off build bit for bit the pencil kernel in every launch: {all(witness)}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
