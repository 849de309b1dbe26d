"""A/B the molecular resident kernel (K2c; with `--ghost` its GHOST mode
K2c-G, the grid's per-shard molecular pass) against other versions of its
source on the card, in one process: the checkout's `csrc/cell_forces.cu`
(A, through `cell_kernel`) and the one in each `DIR` (B, C, …, each built
alone into `build/emdee_tpu_torch/ab_mol_<i>.so`, with the checkout's
`lj_pair.cuh` unless `DIR` has one), on the 98,304-atom water box of
`tools/water.py` (M = 12, C = 80; the lattice with every atom moved by up
to 0.3 Å on each axis, numpy seed 1), DSF and the water's tags with and
without the bond tags.  With `--ghost`, K2c-G in place of those launches,
on the same drifted box sharded (1,1,1), (2,2,2) and (2,1,2), its shards'
ghost grids built as the grid engine builds them (`LocalMesh`, every shard
on the card), DSF and the tags without bond tags, forces and then
energies.

Run from the repository root on a machine with a CUDA card, with the other
versions from an unpacked parent commit or a kept working copy:

    python3 -m emdee_tpu_torch.tools.ab_mol [--ghost] DIR [DIR ...]

It prints, with `nvidia-smi`'s card name and power limit, whether each
version's forces, energies and virials equal A's bit for bit, and the
CUDA-event ms of the step launch (bond tags) and the energy launch (no bond
tags) of every version in turns, forwards and back (`--ghost`: first A's
K2c-G registers, local bytes, shared bytes and blocks an SM, then the
force and the energy launch on each decomposition).  Each version must keep
the C entries `emdee_cell_forces_mol` and `emdee_cell_forces_ghost_mol`
with A's signatures.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from emdee_tpu_torch.csrc import build


def _load(src_dir: Path, i: int) -> ctypes.CDLL:
    lib_path = build.BUILD_DIR / f"ab_mol_{i}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    include = src_dir if (src_dir / "lj_pair.cuh").exists() else build.CSRC
    build._run([[build._nvcc(), *build.NVCC_FLAGS, "-I", str(include), "-shared", "-o", str(lib_path),
                 str(src_dir / "cell_forces.cu")]])
    lib = ctypes.CDLL(str(lib_path))
    for name in ("emdee_cell_forces_mol", "emdee_cell_forces_ghost_mol"):
        getattr(lib, name).argtypes = build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _call(lib, st, config, coul, excl, energy):
    """One launch of `lib`'s K2c entry, as `cell_kernel._launch_mol` makes it."""
    from emdee_tpu_torch.neighbors.cell_dense import _box_of, box_ptr
    from emdee_tpu_torch.neighbors.cell_kernel import _pair_consts, mol_operands, stacked_operands

    operands, (forces, e, w) = stacked_operands(st, config, None, energy)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    q, aid, ids, mlj, mcs, kb, kr0, kr02, ne, neb, *consts = mol_operands(st, config, coul, excl)
    build.check(lib.emdee_cell_forces_mol(
        operands[0].data_ptr(), ptr(operands[4]), ptr(operands[5]), operands[6].data_ptr(), ptr(q), ptr(aid),
        ptr(ids), ptr(mlj), ptr(mcs), ptr(kb), ptr(kr0), ptr(kr02), ne, neb, *map(ptr, consts), forces.data_ptr(),
        ptr(e), ptr(w), config.cells_per_dim, config.capacity, box_ptr(_box_of(st, config), operands[0]),
        *_pair_consts(config, None)[:8], 1, 1, int(kb is not None), int(energy),
        torch.cuda.current_stream(st.positions.device).cuda_stream,
    ), "K2c (A/B version)")
    return forces, e, w


def _ghost_call(lib, gh, mesh, config, coul, tags, energy):
    """One launch of `lib`'s K2c-G entry, as `cell_kernel.ghost_forces`
    makes it: the ghost grids gh (x, y, z with NaN in empty slots, σ/2,
    2√ε, q, atom ids as float32 bits), the own slots' tags (ids, mlj,
    mcs)."""
    from emdee_tpu_torch.neighbors.cell_dense import box_ptr
    from emdee_tpu_torch.neighbors.cell_kernel import _dsf_operands, _pair_consts

    sz, sy, sx = mesh.local_shape
    gz, gy, gx, c = gh.shape[-4:]
    local = (sz, sy, sx, gz - 2, gy - 2, gx - 2, c)
    f = torch.empty((3,) + local, dtype=torch.float32, device=gh.device)
    e = torch.empty(local, dtype=torch.float32, device=gh.device) if energy else None
    w = torch.empty(local, dtype=torch.float32, device=gh.device) if energy else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    build.check(lib.emdee_cell_forces_ghost_mol(
        *(gh[i].data_ptr() for i in range(7)), *(t.data_ptr() for t in tags), tags[0].shape[-1],
        *(t.data_ptr() for t in _dsf_operands(coul, gh.device)), f[0].data_ptr(), f[1].data_ptr(), f[2].data_ptr(),
        ptr(e), ptr(w), gz - 2, gy - 2, gx - 2, sz * sy * sx, sy, sx, *mesh.base, config.cells_per_dim, c,
        box_ptr(config.box, gh), *_pair_consts(config, None)[:8], 1, 1, int(energy),
        torch.cuda.current_stream(gh.device).cuda_stream,
    ), "K2c-G (A/B version)")
    return f, e, w


def _ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _compare(smi, what, runs):
    """Bit for bit against A, then ms of every version in turns, forwards
    and back; returns {version: bit for bit A}."""
    ref = runs["A"]()
    same = {}
    for k in list(runs)[1:]:
        got = runs[k]()
        torch.cuda.synchronize()
        same[k] = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(ref, got) if a is not None)
    times = {k: [] for k in runs}
    for k in list(runs) + list(runs)[::-1]:
        times[k].append(_ms(runs[k]))
    print(f"{smi}: {what}: bit for bit A " + ", ".join(f"{k} {v}" for k, v in same.items()) + "; ms "
          + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v) for k, v in times.items()), flush=True)
    return same


def _ghost_main(smi, libs, st, config, model, coul, n, tabs) -> None:
    """K2c-G of every version on the drifted box sharded (1,1,1), (2,2,2)
    and (2,1,2): bit for bit A in every output, ms in turns."""
    from emdee_tpu_torch import make_exclusion_aux_fn
    from emdee_tpu_torch.distributed.grid_sharded import _ghost3, distribute_grid
    from emdee_tpu_torch.distributed.mesh import make_grid_mesh
    from emdee_tpu_torch.neighbors.cell_kernel import ghost_forces, k2c_resources

    aux = make_exclusion_aux_fn(n, *tabs)
    for energy in (False, True):
        res = k2c_resources(config, coul, aux(st)[:3], energy, ghost=True)
        print(f"{smi}: A's K2c-G {'energy' if energy else 'force'} variant: {res}", flush=True)
    bits = []
    for shape in ((1, 1, 1), (2, 2, 2), (2, 1, 2)):
        mesh = make_grid_mesh(shape, device=st.positions.device)
        sh = distribute_grid(st, config, mesh)
        gh = _ghost3(torch.cat([torch.where(sh.valid, sh.positions.movedim(-1, 0), float("nan")),
                                sh.half_sigma[None], sh.twice_sqrt_eps[None], sh.charges[None],
                                torch.where(sh.valid, sh.atom_id, -2).view(torch.float32)[None]]), mesh)
        ids, mlj, mcs = aux(sh)[:3]
        tags = (ids, mlj, mlj if mcs is None else mcs)  # the water's Coulomb scales are its LJ scales
        for energy, what in ((False, "forces"), (True, "energies")):
            runs = {k: (lambda lib=lib, energy=energy: ghost_forces(
                gh, mesh.local_shape, mesh.base, config, model, compute_energy=energy, backend="cuda",
                coulomb=coul, excl=tags) if lib is None else _ghost_call(lib, gh, mesh, config, coul, tags, energy))
                for k, lib in libs.items()}
            bits.append(_compare(smi, f"K2c-G {what} on {shape}", runs))
    print(f"{smi}: every version bit for bit A in every K2c-G launch: {all(all(b.values()) for b in bits)}",
          flush=True)


def main(argv) -> None:
    from emdee_tpu_torch import build_exclusion_tables, cell_dense_init, make_exclusion_aux_fn
    from emdee_tpu_torch.neighbors.cell_kernel import cell_forces
    from emdee_tpu_torch.tools import water

    ghost = "--ghost" in argv
    dirs = [a for a in argv if a != "--ghost"]
    if not torch.cuda.is_available() or not dirs:
        raise SystemExit("ab_mol: needs a CUDA device and at least one DIR")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda", 0)
    libs = {"A": None, **{chr(ord("B") + i): _load(Path(d), i) for i, d in enumerate(dirs)}}
    box, config, model, coul, params = water.water_setup(device, spill=False)
    n = len(box["masses"])
    pos = box["positions"] + np.random.default_rng(1).uniform(-0.3, 0.3, box["positions"].shape)
    st = cell_dense_init(pos, box["velocities"], box["masses"], params, config, charges=box["charges"], device=device)
    tabs, _, bond_tabs, _ = build_exclusion_tables(n, box["exclusion_pairs"], box["exclusion_scales"], None,
                                                   bonds=(box["bonds"], box["bond_k"], box["bond_r0"]))
    print(f"{smi}: {'K2c-G' if ghost else 'K2c'} A/B at {n} atoms, M={config.cells_per_dim} C={config.capacity}; "
          "A = the checkout, " + ", ".join(f"{k} = {d}" for k, d in zip(list(libs)[1:], dirs)), flush=True)
    if ghost:
        _ghost_main(smi, libs, st, config, model, coul, n, tabs)
        return
    tags = make_exclusion_aux_fn(n, *tabs, bond_tabs=bond_tabs)(st)
    for excl, energy, what in ((tags, False, "step launch (bond tags)"), (tags[:3], True, "energy launch")):
        _compare(smi, what, {k: (lambda lib=lib: cell_forces(st, model, config, compute_energy=energy, backend="cuda",
                                                             coulomb=coul, excl=excl) if lib is None
                                 else _call(lib, st, config, coul, excl, energy)) for k, lib in libs.items()})


if __name__ == "__main__":
    main(sys.argv[1:])
