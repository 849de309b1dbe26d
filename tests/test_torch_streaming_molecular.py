"""The streaming family's molecular terms (K5c) on the CPU: the plain
version of `streaming_kernel.cell_forces_streaming(coulomb=, excl=)` — the
path a CPU tensor takes — against the TPU streaming kernel in interpret mode
with DSF, exclusion tags and bond tags (tests/test_pallas_kernel.py:162-210's
setup and tolerances, on `tools/fixtures.py`'s charged fixture); the family
rule (the tag tables, absorbed bonds and band cap that the resolved family
'cuda_streaming' gets equal the reference's for 'pallas_streaming',
cell_dense_molecular.py:543-560); the water boxes' backend resolution; the
kernel's geometry limits; and the C entries' ctypes signatures.  No card is
touched."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.neighbors import cell_dense_molecular as jmol
from emdee_tpu.neighbors.pallas_cell_kernel import pallas_cell_forces_streaming
from emdee_tpu.potentials import coulomb as jc
from emdee_tpu.potentials.lennard_jones import LennardJonesModel as JModel
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom as jlj
from emdee_tpu_torch.csrc import build
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.neighbors import cell_dense_molecular as tmol
from emdee_tpu_torch.neighbors import streaming_kernel
from emdee_tpu_torch.potentials import bonded as tb
from emdee_tpu_torch.potentials import coulomb as tc
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel as TModel
from emdee_tpu_torch.tools import fixtures, water
from torch_port_utils import jax_triatomic_bonded, port_tags, to_port

torch.set_num_threads(2)

TMODEL = TModel.create(2.5, 2.0, device="cpu")
JMODEL = JModel.create(2.5, 2.0)


@pytest.fixture(scope="module")
def charged():
    """The 864-atom charged fixture as a JAX state with its slot tags
    (bond weights on the first E_b tags) and the DSF model."""
    a = fixtures.charged_arrays()
    n = a["n"]
    config = jcd.suggest_cell_dense_config(n, a["box"], cutoff=2.5, switch=2.0, skin=0.3)
    st = jcd.cell_dense_init(a["pos"], a["vel"], np.ones(n), jlj(np.ones(n), np.ones(n)), config, charges=a["q"])
    tabs, _, bond_tabs, absorbed = jmol.build_exclusion_tables(n, a["pairs"], a["ljs"], a["cs"], bonds=a["bonds"])
    assert absorbed.all()
    aux = jmol.make_exclusion_aux_fn(n, *tabs, bond_tabs=bond_tabs)(st)
    return st, config, jc.DSFCoulomb.create(2.5, alpha=0.25, coulomb_constant=1.0), aux


@pytest.mark.parametrize("energy", [False, True])
def test_k5c_plain_matches_reference_streaming_interpret(charged, energy):
    """K5c's plain version against `pallas_cell_forces_streaming(interpret=
    True, coulomb=, excl=)` with the bond tags: forces within 2e-4 of the
    force scale, per-slot energies and virials within 1e-3, exact zeros on
    empty slots; the tags and bonds change the forces."""
    st, config, coul, aux = charged
    want = pallas_cell_forces_streaming(st, JMODEL, config, compute_energy=energy, interpret=True,
                                        coulomb=jc.coulomb_consts(coul), excl=aux)
    ts = to_port(st)
    tcoul = tc.coulomb_from_numpy(jax.device_get(coul), "cpu")
    got = streaming_kernel.cell_forces_streaming(ts, TMODEL, config, compute_energy=energy, coulomb=tcoul,
                                                 excl=port_tags(aux))
    valid = np.asarray(st.valid)
    f, fr = got[0].numpy(), np.asarray(want[0])
    scale = max(np.abs(fr[valid]).max(), 1.0)
    np.testing.assert_allclose(f[valid], fr[valid], atol=2e-4 * scale)
    assert (f[~valid] == 0).all()
    if energy:
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy()[valid], np.asarray(w)[valid], atol=1e-3)
            assert (g.numpy()[~valid] == 0).all()
    else:
        assert got[1] is None and got[2] is None
        bare = streaming_kernel.cell_forces_streaming(ts, TMODEL, config, coulomb=tcoul)[0]
        assert float((got[0] - bare).abs().max()) > 1.0


def _triatomic():
    fx = fixtures.triatomic_arrays()
    fx["jbonded"] = jax_triatomic_bonded(fx)
    fx["tbonded"] = tb.bonded_from_numpy(jax.device_get(fx["jbonded"]), "cpu")
    return fx


def _assert_same(got, want, what):
    assert (got is None) == (want is None), what
    if isinstance(want, (tuple, list)):
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    elif want is not None:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


@pytest.mark.parametrize("band", [None, 1])
def test_family_rule_matches_reference(band):
    """`exclusion_setup` for the resolved family 'cuda_streaming' builds what
    the reference's `make_molecular_dense_sim` builds for 'pallas_streaming'
    (cell_dense_molecular.py:543-560): the bonds ride the tags, the same tag
    tables, leftover pairs, bond weights and remaining bond table; 'cuda'
    (K2c) gets the same, 'torch' keeps the bonds on the gather path, as the
    reference's 'xla'."""
    fx = _triatomic()
    n, bonds = fx["n"], fx["jbonded"].bonds
    bvalid = np.asarray(bonds.valid)
    tabs, leftover, bond_tabs, absorbed = jmol.build_exclusion_tables(
        n, fx["pairs"], fx["ljs"], fx["cs"], band_e=band,
        bonds=(np.asarray(bonds.atoms)[bvalid], np.asarray(bonds.k)[bvalid], np.asarray(bonds.length)[bvalid]))
    rest = jmol._without_absorbed_bonds(fx["jbonded"], absorbed)
    if leftover[0].shape[0] == 0:
        leftover = None
    for family in ("cuda_streaming", "cuda"):
        g_tabs, g_left, g_bond, g_sys = tmol.exclusion_setup(n, fx["pairs"], fx["ljs"], fx["cs"], fx["tbonded"],
                                                             family, band)
        _assert_same(g_tabs, tabs, f"{family} tabs")
        _assert_same(g_left, leftover, f"{family} leftover")
        _assert_same(g_bond, bond_tabs, f"{family} bond tags")
        assert (g_sys.bonds is None) == (rest.bonds is None)
        if rest.bonds is not None:
            _assert_same(tuple(g_sys.bonds), tuple(jax.device_get(rest.bonds)), f"{family} bond rows")
    g_tabs, _, g_bond, g_sys = tmol.exclusion_setup(n, fx["pairs"], fx["ljs"], fx["cs"], fx["tbonded"], "torch", band)
    want = jmol.build_exclusion_tables(n, fx["pairs"], fx["ljs"], fx["cs"], **({} if band is None else {"band_e": band}))
    _assert_same(g_tabs, want if band is None else want[0], "torch tabs")
    assert g_bond is None and g_sys is fx["tbonded"]


def test_water_boxes_resolve_to_the_streaming_family():
    """The 98,304-atom box (M = 12, C = 80) and the 985,527-atom box (69³
    waters, M = 26, C = 88) resolve to 'cuda_streaming' for CUDA tensors
    with Coulomb and exclusions, without touching a card; K5c takes both
    (C ≤ 96, a block's shared memory within Hopper's with E = E_b = 2)."""
    for n_side, geometry in ((32, (12, 80)), (69, (26, 88))):
        box = water.water_box(n_side)
        cfg = water.plain_config(box)
        assert (cfg.cells_per_dim, cfg.capacity) == geometry
        assert tcd.resolve_dense_backend(cfg, "auto", device="cuda", with_coulomb=True, with_excl=True) \
            == "cuda_streaming"
        assert tcd.resolve_dense_backend(cfg, "auto", device="cpu", with_coulomb=True, with_excl=True) == "torch"
        for energy in (False, True):
            streaming_kernel._check_geometry(cfg, energy, True, 2, 2 if not energy else 0)


def test_k5c_refuses_geometry_it_cannot_take(charged):
    """What the C entries refuse raises before a launch: C > 1024 and M < 3,
    for K5c and for K5 (LJ).  Both blocks hold four warps' tiles and centre
    and reaction rows (K5c's also its staged tags), whatever M: K5c's widest
    block (C = 96, E = E_b = 8, energies) and K5's fit at M = 60, and the
    entries count the bytes alike; at C = 1024 with eight tags and bond
    tags one K5c warp's chunks, tags and rows fill a block."""
    _, config, _, _ = charged
    with pytest.raises(ValueError, match="C ≤ 1024"):
        streaming_kernel._check_geometry(config._replace(capacity=1025), True, True, 2, 2)
    streaming_kernel._check_geometry(config._replace(capacity=1024), True, True, 8, 8)
    assert streaming_kernel._owned_block(1024, True, 8, 8) == (4 * (24 * 8 * 96 + 3 * 16 * 96 + 2 * 5 * 1024), 1)
    with pytest.raises(ValueError, match="M ≥ 3"):
        streaming_kernel._check_geometry(config._replace(cells_per_dim=2), True, True, 2, 2)
    with pytest.raises(ValueError, match="M ≥ 3"):
        streaming_kernel._check_geometry(config._replace(cells_per_dim=2), True)
    streaming_kernel._check_geometry(config._replace(cells_per_dim=60, capacity=96), True)
    widest = config._replace(cells_per_dim=40, capacity=96)
    streaming_kernel._check_geometry(widest, True, True, 8, 8)
    assert streaming_kernel.smem_bytes(widest, True, True, 8, 8) == 4 * 4 * (2 * 8 * 96 + 3 * 16 * 96 + 2 * 5 * 96)
    assert streaming_kernel.smem_bytes(config, False, True, 2, 2) == 4 * 4 * (2 * 8 * 64 + 3 * 4 * 64 + 2 * 3 * 24)
    assert streaming_kernel.smem_bytes(config, False) == 4 * 4 * (3 * 6 * 64 + 2 * 3 * 24)


def test_c_entries_match_ctypes_signatures():
    """Every `extern "C"` entry of csrc/ has a ctypes signature of the same
    arity and kinds (pointer, int, float, long), K5's pair pass, fold and
    resource query, the K5c pair pass, its fold, its resource query, the
    K2c-G entry and its resource query, K5s-mol's pair pass, assembly and
    resource query and K2c's resource query among them."""
    kinds = {"int": "c_int", "float": "c_float", "long": "c_long"}
    src = "".join(p.read_text() for p in sorted(Path(build.CSRC).glob("*.cu")))
    entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert {"emdee_streaming_forces", "emdee_streaming_fold", "emdee_streaming_attrs", "emdee_streaming_forces_mol", "emdee_streaming_fold_mol", "emdee_streaming_mol_attrs",
            "emdee_cell_forces_ghost_mol", "emdee_streaming_ghost_mol", "emdee_streaming_ghost_assemble_mol",
            "emdee_streaming_ghost_mol_attrs", "emdee_cell_forces_mol_attrs",
            "emdee_cell_forces_ghost_mol_attrs"} <= set(entries)
    assert set(entries) == set(build._SIGNATURES)
    for name, params in entries.items():
        want = ["c_void_p" if "*" in p else kinds[p.split()[0]] for p in params.split(",")]
        assert [t.__name__ for t in build._SIGNATURES[name]] == want, name
