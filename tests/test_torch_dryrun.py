"""The multi-process dry run (`emdee_tpu_torch.distributed.dryrun`, parts 3
to 6 of the repository's `__graft_entry__.py` `dryrun_multichip`) on the
CPU: the whole run on two gloo ranks, every part bitwise equal to the
`LocalMesh` run; the part-4 (DSF charges + exclusion tags) and part-5
(bonded pairs as term rows, half the pairs in the tags, half as leftover
exclusions, capacity 16) fixtures fed as the same arrays to the JAX
package's grid engine (`backend="xla"`, 8 virtual CPU devices) on (2,2,2),
energies within the grid tests' rel 1e-5 / abs 1e-2 before and after the
2-step rollout; and part 6 (part 5 on the plain streaming family) within
1e-4 of part 5, as `__graft_entry__.py:271` checks."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.distributed import grid_sharded as jgs
from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.neighbors import cell_dense_molecular as jmol
from emdee_tpu.potentials import bonded as jb
from emdee_tpu.potentials.coulomb import DSFCoulomb as JCoulomb
from emdee_tpu.potentials.lennard_jones import LennardJonesModel as JModel
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom as jlj
from emdee_tpu_torch import LennardJonesModel, cell_dense_init, lennard_jones_atom
from emdee_tpu_torch.distributed import dryrun
from emdee_tpu_torch.distributed import grid_sharded as gs
from emdee_tpu_torch.distributed.mesh import make_grid_mesh

torch.set_num_threads(2)
N_DEVICES = 8  # the (2,2,2) mesh: 512 atoms, M = 8


def test_dryrun_multichip_on_two_gloo_ranks(capsys):
    dryrun.dryrun_multichip(2)
    assert "parts 3-6" in capsys.readouterr().out


def _jax_kwargs(part, a):
    """The JAX package's options for part 4, or parts 5 and 6, from the
    same arrays (`__graft_entry__.py:181-240`)."""
    n = a["n"]
    kw = dict(coulomb=JCoulomb.create(2.5, alpha=0.25, coulomb_constant=1.0))
    if part == 4:
        return dict(kw, excl_tables=jmol.build_exclusion_tables(n, a["tags4"], np.zeros(len(a["tags4"]), np.float32)))
    nb, left = len(a["bonds"]), a["leftover"]
    bonded = jb.BondedSystem(bonds=jb.BondTable(atoms=jnp.asarray(a["bonds"], jnp.int32),
                                                length=jnp.full(nb, a["r_min"], jnp.float32),
                                                k=jnp.full(nb, 10.0, jnp.float32), valid=jnp.ones(nb, bool)),
                             angles=None, torsions=None, impropers=None)
    half = np.full(len(left), 0.5, np.float32)
    return dict(kw, excl_tables=jmol.build_exclusion_tables(n, a["tags5"], np.zeros(len(a["tags5"]), np.float32)),
                bonded=bonded, excl_leftover=(left.astype(np.int32), half, half),
                atom_params=jlj(np.ones(n), np.ones(n)), atom_charges=a["q"])


@pytest.fixture(scope="module")
def arrays():
    a = dryrun.molecular_arrays(N_DEVICES)
    assert a["shape"] == (2, 2, 2) and a["config4"].cells_per_dim == 8
    return a


def _port(a, part, backend="auto"):
    """The port's part on a (2,2,2) `LocalMesh`: (energies before, energies
    after the 2-step rollout, end state)."""
    n = a["n"]
    pos, cfg = (a["pos"], a["config4"]) if part == 4 else (a["pos5"], a["config5"])
    st = cell_dense_init(pos, a["vel"], np.ones(n), lennard_jones_atom(np.ones(n), np.ones(n), device="cpu"), cfg,
                         charges=a["q"], device="cpu")
    mesh = make_grid_mesh(a["shape"], device="cpu")
    rollout, energy = gs.make_grid_sharded_sim(cfg, LennardJonesModel.create(2.5, 2.0, device="cpu"), 0.002, mesh,
                                               backend=backend, **dryrun.molecular_kwargs(part, N_DEVICES, "cpu"))
    st = gs.distribute_grid(st, cfg, mesh)
    before = [float(x) for x in energy(st)]
    out = rollout(st, num_steps=2, rebin_every=2)
    return before, [float(x) for x in energy(out)], out


@pytest.mark.parametrize("part", [4, 5])
def test_molecular_parts_match_jax(arrays, part):
    a = arrays
    n = a["n"]
    pos, cfg = (a["pos"], a["config4"]) if part == 4 else (a["pos5"], a["config5"])
    st = jcd.cell_dense_init(pos, a["vel"], np.ones(n), jlj(np.ones(n), np.ones(n)), cfg, charges=a["q"])
    jmesh = jgs.make_grid_mesh(a["shape"])
    jroll, jenergy = jgs.make_grid_sharded_sim(cfg, JModel.create(2.5, 2.0), 0.002, jmesh, backend="xla",
                                               **_jax_kwargs(part, a))
    st = jgs.distribute_grid(st, cfg, jmesh)
    ref_before = [float(x) for x in jenergy(st)]
    ref_out = jroll(st, num_steps=2, rebin_every=2)
    ref_after = [float(x) for x in jenergy(ref_out)]
    before, after, out = _port(a, part)
    # Part 4's random start puts atoms close enough to move past the skin
    # in two steps (both flags raised, as in the reference, which checks
    # the flag from part 5 on).
    assert bool(out.overflow) == bool(ref_out.overflow) == (part == 4)
    for got, want in ((before, ref_before), (after, ref_after)):
        assert got == pytest.approx(want, rel=1e-5, abs=1e-2)


def test_part6_matches_part5(arrays):
    """Part 5 on the plain streaming family (the half shell and the fold of
    its reaction ghosts) against the resident family's plain version."""
    pe5 = _port(arrays, 5)[1][0]
    pe6 = _port(arrays, 5, backend="torch_streaming")[1][0]
    assert abs(pe6 - pe5) <= 1e-4 * max(1.0, abs(pe5))


def test_kwargs_fn_pickles():
    """`grid_job`'s kwargs_fn crosses to spawned ranks by pickle."""
    import pickle

    fn = pickle.loads(pickle.dumps(functools.partial(dryrun.molecular_kwargs, 5, 2)))
    assert set(fn("cpu")) >= {"coulomb", "excl_tables", "bonded", "excl_leftover"}
