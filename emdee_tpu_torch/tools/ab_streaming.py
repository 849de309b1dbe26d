"""A/B the streaming force kernel (K5) against another version of its source
on the card, in one process: the checkout's `csrc/cell_forces_streaming.cu`
(A, through `streaming_kernel`) and the one in `DIR` (B, built into
`build/emdee_tpu_torch/ab_streaming_b.so`, with `DIR`'s `lj_pair.cuh` if it
has one, else the checkout's), both on the drifted 97,556- and
1,000,188-atom melts.

Run from the repository root on a machine with a CUDA card, with B from an
unpacked parent commit or a kept working copy:

    python3 -m emdee_tpu_torch.tools.ab_streaming DIR

For each size it checks that B's split forces agree with A's within 2e-5
of the force scale, then prints CUDA-event ms per split call in turns A, B,
B, A, and the resident kernel (K2) beside them, with `nvidia-smi`'s card
name and power limit.  B must keep the C entries `emdee_streaming_forces`
and `emdee_streaming_fold` with A's signatures (the pair pass reads the
box from a 0-d device tensor).
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

from emdee_tpu_torch.csrc import build


def _load_b(src_dir: Path) -> ctypes.CDLL:
    lib_path = build.BUILD_DIR / "ab_streaming_b.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    build._run([[build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                 "-shared", "-o", str(lib_path), str(src_dir / "cell_forces_streaming.cu")]])
    lib = ctypes.CDLL(str(lib_path))
    for name in ("emdee_streaming_forces", "emdee_streaming_fold"):
        fn = getattr(lib, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def _split_b(lib, px, py, pz, valid, config, uni):
    from emdee_tpu_torch.neighbors.cell_dense import box_ptr
    from emdee_tpu_torch.neighbors.cell_kernel import _pair_consts, split_operands

    (px, py, pz, _, _, _, valid, fx, fy, fz, _, _, _), out = split_operands(px, py, pz, valid, config)
    groups = torch.empty((4, 3, config.num_slots), dtype=torch.float32, device=px.device)
    stream = torch.cuda.current_stream(px.device).cuda_stream
    build.check(lib.emdee_streaming_forces(
        px.data_ptr(), py.data_ptr(), pz.data_ptr(), 1, None, None, valid.data_ptr(),
        fx.data_ptr(), fy.data_ptr(), fz.data_ptr(), 1, None, None, groups.data_ptr(),
        config.cells_per_dim, config.capacity, box_ptr(config.box, px), *_pair_consts(config, uni), 1, 0, stream,
    ), "B pair pass")
    build.check(lib.emdee_streaming_fold(
        fx.data_ptr(), fy.data_ptr(), fz.data_ptr(), 1, None, None, groups.data_ptr(),
        config.num_slots, 0, stream,
    ), "B fold")
    return out


def main() -> None:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        raise SystemExit("usage on a CUDA machine: python3 -m emdee_tpu_torch.tools.ab_streaming DIR")
    import chip_smoke
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces_split
    from emdee_tpu_torch.neighbors.streaming_kernel import cell_forces_streaming_split
    from emdee_tpu_torch.tools.melt import N_CELLS, N_CELLS_1M, SKIN, melt

    smi = chip_smoke.card()
    print(smi, flush=True)
    lib_b = _load_b(Path(sys.argv[1]))
    device = torch.device("cuda", 0)
    for cells in (N_CELLS, N_CELLS_1M):
        st, config, _, _, uni, n = melt(device, cells)
        st = chip_smoke.drifted(st, SKIN)
        v = st.valid
        args = tuple(st.positions[..., i].contiguous() for i in range(3)) + (v, config)
        a = cell_forces_streaming_split(*args, uniform_params=uni, backend="cuda")
        b = _split_b(lib_b, *args, uni)
        torch.cuda.synchronize()
        scale = max(max(float(f[v].abs().max()) for f in a), 1.0)
        diff = max(chip_smoke.close(f"B vs A f{c}", y[v], x[v], atol=2e-5 * scale) for c, x, y in zip("xyz", a, b))
        run_a = lambda: cell_forces_streaming_split(*args, uniform_params=uni, backend="cuda")  # noqa: E731
        run_b = lambda: _split_b(lib_b, *args, uni)  # noqa: E731
        turns = [chip_smoke.cuda_ms(fn, 20) for fn in (run_a, run_b, run_b, run_a)]
        k2 = chip_smoke.cuda_ms(lambda: cell_forces_split(*args, uniform_params=uni, backend="cuda"), 20)
        print(f"[{smi}] {n} atoms: B vs A max |dF| {diff:.3e} (rel {diff / scale:.3e}); split ms A "
              f"{turns[0]:.4f}, B {turns[1]:.4f}, B {turns[2]:.4f}, A {turns[3]:.4f}; K2 {k2:.4f}", flush=True)
        del st, a, b
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
