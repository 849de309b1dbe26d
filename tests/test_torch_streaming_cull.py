"""K5c's geometric cull on the CPU, through its plain mirror
(`streaming_kernel.cull_pair` / `cull_keep`, the predicate the kernel
evaluates before its ring): on the 864-atom charged fixture (atoms drifted
0.45·skin along their velocities, across cell faces and the periodic seam)
and on a slice of the 98,304-atom water lattice drifted up to skin/2, no
pair whose float32 r² lies within the cutoff is ever dropped, for every
half-shell offset and periodic shift; on the undrifted water lattice, the
kept share of a centre cell against a face, an edge and a corner
neighbour agrees with the geometric reckoning (0.84, 0.56, 0.31 at a cell
of 8.29 Å and a cutoff of 7 Å) within 0.1; and K5c's block fits four to an
SM at the water boxes' geometries.  The same predicate at rc² alone, as
K5 (LJ) applies it, keeps every inside pair of the fixture at C = 32.  The same predicate as K5s-mol applies
it on the grid's ghost grids, with the shift from the neighbour's global
cell index (`streaming_kernel.ghost_phase`, held to the plain ghost pass's
blocks), on the grid's charged fixture and a drifted (2,2,2) water box;
and as K2c applies it (`cell_kernel.k2c_cull`: a warp's box of 32 centres
against each of the 27 neighbour cells) on the 864-atom fixture and the
water slice, and as K2c-G applies it on the ghost grids (the shift of
`cell_kernel.ghost_lj_table`) on the grid's charged fixture and a drifted
(2,2,2) water slice; and the kernels' shared memory and K5s-mol's scratch
at the smoke's shapes.  No card is touched."""

import numpy as np
import pytest
import torch

from emdee_tpu_torch.neighbors import cell_kernel
from emdee_tpu_torch.neighbors import streaming_kernel as sk
from emdee_tpu_torch.tools import fixtures, water

# The half-shell offsets (dz, dy, dx) in K5c's phase order (kOffDz/Dy/Dx).
OFFSETS = [(0, 1, -1), (0, 1, 0), (0, 1, 1), (1, -1, -1), (1, -1, 0), (1, -1, 1), (1, 0, -1), (1, 0, 0),
           (1, 0, 1), (1, 1, -1), (1, 1, 0), (1, 1, 1), (0, 0, 1)]


def _cells(pos, cell_of, m):
    """Per cell id (z·M + y)·M + x, the float32 positions of its atoms."""
    order = np.argsort(cell_of, kind="stable")
    bounds = np.searchsorted(cell_of[order], np.arange(m**3 + 1))
    return [torch.from_numpy(pos[order[bounds[i]:bounds[i + 1]]].astype(np.float32)) for i in range(m**3)]


def _neighbour(cell, off, m, box):
    """The neighbour cell of `cell` at offset (dz, dy, dx), wrapped, and the
    periodic shift the kernel subtracts from x_i − x_j."""
    z, y, x = cell // (m * m), (cell // m) % m, cell % m
    idx, shift = [], []
    for v, d in zip((x, y, z), off[::-1]):
        w = v + d
        shift.append(-box if w < 0 else (box if w >= m else 0.0))
        idx.append(w % m)
    return (idx[2] * m + idx[1]) * m + idx[0], torch.tensor(shift, dtype=torch.float32)


def _check_no_inside_pair_dropped(cells, centres, m, box, cut2):
    """Every pair of a centre cell with a half-shell neighbour whose float32
    r² ((x_i − x_j) − shift, as the kernel forms it) is below cut2 (with a
    margin of 1e-5 above it) has both its atoms kept; returns the pairs
    checked."""
    checked = 0
    for cell in centres:
        cen = cells[cell]
        for off in OFFSETS:
            nb_cell, shift = _neighbour(cell, off, m, box)
            nb = cells[nb_cell]
            if len(cen) == 0 or len(nb) == 0:
                continue
            keep_c, keep_n = sk.cull_pair(cen, nb, shift, cut2)
            d = (cen[:, None, :] - nb[None, :, :]) - shift
            r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
            inside = r2 < cut2 * (1 + 1e-5)
            assert bool(keep_c[inside.any(1)].all()), (cell, off)
            assert bool(keep_n[inside.any(0)].all()), (cell, off)
            checked += int(inside.sum())
    return checked


@pytest.mark.parametrize("capacity,lj_only", [pytest.param(None, False, id="k5c"),
                                               pytest.param(32, True, id="k5-c32")])
def test_cull_keeps_every_inside_pair_on_the_charged_fixture(capacity, lj_only):
    """Every cell and offset of the 864-atom fixture: K5c's cull at the
    larger of the two cutoffs at the fixture's capacity, and K5's at rc²
    alone at C = 32."""
    st, config, _, coul, _ = fixtures.charged_fixture("cpu", capacity)
    m, c = config.cells_per_dim, config.capacity
    pos = st.positions.reshape(-1, 3).numpy()
    valid = st.valid.reshape(-1).numpy()
    cell_of = np.repeat(np.arange(m**3), c)[valid]
    cells = _cells(pos[valid], cell_of, m)
    cut2 = float(config.cutoff) ** 2 if lj_only else max(float(config.cutoff) ** 2, float(coul.rc2))
    assert _check_no_inside_pair_dropped(cells, range(m**3), m, float(config.box), cut2) > 5_000


@pytest.fixture(scope="module")
def water_lattice():
    box = water.water_box(water.N_SIDE)
    cfg = water.plain_config(box)
    m, edge = cfg.cells_per_dim, float(cfg.box)
    pos = box["positions"]
    cell_of = (np.floor(pos / (edge / m)).astype(np.int64) % m) @ np.array([1, m, m * m])
    return pos, cell_of, m, edge, cfg.cutoff**2


def test_cull_keeps_every_inside_pair_on_a_drifted_water_slice(water_lattice):
    """The water lattice binned, then every atom moved by up to skin/2 on
    each axis (numpy seed 3), as between rebins: the centre cells of the
    z = 0 and z = M − 1 layers at y ∈ {0, M − 1}, which meet every seam."""
    pos, cell_of, m, edge, cut2 = water_lattice
    rng = np.random.default_rng(3)
    drifted = pos + rng.uniform(-0.5 * water.SKIN, 0.5 * water.SKIN, pos.shape)
    cells = _cells(drifted, cell_of, m)
    centres = [(z * m + y) * m + x for z in (0, m - 1) for y in (0, m - 1) for x in range(m)]
    assert _check_no_inside_pair_dropped(cells, centres, m, edge, cut2) > 100_000


def test_cull_kept_shares_match_the_reckoning(water_lattice):
    """Kept share of a centre cell's atoms against the neighbour's box, by
    the kind of offset, over 64 centre cells of the undrifted lattice."""
    pos, cell_of, m, edge, cut2 = water_lattice
    cells = _cells(pos, cell_of, m)
    want = {1: 0.84, 2: 0.56, 3: 0.31}  # face, edge, corner
    kept = {k: [0, 0] for k in want}
    for cell in range(0, m**3, m**3 // 64):
        for off in OFFSETS:
            nb_cell, shift = _neighbour(cell, off, m, edge)
            keep_c, _ = sk.cull_pair(cells[cell], cells[nb_cell], shift, cut2)
            kind = sum(d != 0 for d in off)
            kept[kind][0] += int(keep_c.sum())
            kept[kind][1] += len(keep_c)
    for kind, share in want.items():
        assert abs(kept[kind][0] / kept[kind][1] - share) <= 0.1, (kind, kept[kind])


def test_cull_keep_is_conservative_at_the_boundary():
    """A point 0.01 beyond the cutoff from a box face is dropped, one 1e-4
    inside it is kept, whatever the periodic shift's magnitude."""
    lo, hi = torch.zeros(3), torch.ones(3)
    for shift in (0.0, 99.52, -214.59):
        o = torch.tensor([shift, 0.0, 0.0])
        inside = torch.tensor([[1.0 + shift + 6.9999, 0.5, 0.5]])
        far = torch.tensor([[1.0 + shift + 7.01, 0.5, 0.5]])
        assert bool(sk.cull_keep(inside, lo, hi, o, 49.0).all())
        assert not bool(sk.cull_keep(far, lo, hi, o, 49.0).any())


@pytest.mark.parametrize("energy", [False, True])
@pytest.mark.parametrize("geometry", [(12, 80), (26, 88), pytest.param((17, 32, "lj"), id="lj-97556"),
                                      pytest.param((37, 32, "lj"), id="lj-1m")])
def test_k5c_blocks_fit_four_an_sm(geometry, energy):
    """K5c's block (4 warps) at the water boxes' geometries, with the water
    tags (E = 2, E_b = 2 on the step launch, none on the energy launch),
    fits four to an SM's 233,472 shared bytes (1,024 reserved a block):
    shared memory allows the 16 warps an SM that its 128 registers a thread
    allow, whatever M.  K5's block (LJ, 4 warps, each with three tiles of x,
    y, z with uniform parameters, with σ/2 and 2√ε per atom) at the melts'
    geometries (M = 17 and 37, C = 32) is 15,360 B (uniform), 17,408
    (uniform with energies), 21,504 (per atom) and 23,552 (per atom with
    energies), so shared memory and the warp slots allow the
    K5_MIN_BLOCKS blocks an SM that its launch bounds ask the registers
    for."""
    m, c, *lj = geometry
    config = fixtures.charged_fixture("cpu")[1]._replace(cells_per_dim=m, capacity=c)
    if lj:
        for uniform in (False, True):
            smem = sk.smem_bytes(config, energy, uniform=uniform)
            assert smem == 4 * sk.K5_WARPS * (3 * (4 if uniform else 6) * 64 + 2 * (5 if energy else 3) * c)
            assert smem == {(True, False): 15_360, (True, True): 17_408, (False, False): 21_504,
                            (False, True): 23_552}[uniform, energy]
            assert sk.K5_MIN_BLOCKS * (smem + 1024) <= 233_472 and sk.K5_MIN_BLOCKS * sk.K5_WARPS <= 64
        return
    smem = sk.smem_bytes(config, energy, True, 2, 0 if energy else 2)
    assert smem == 4 * 4 * (2 * 8 * 96 + 3 * (2 if energy else 4) * 96 + 2 * (5 if energy else 3) * c)
    assert 4 * (smem + 1024) <= 233_472


# ---------------------------------------------------------------------------
# K5s-mol (the cull on the grid's ghost grids) and K2c (the warp's centre box
# against each neighbour cell)
# ---------------------------------------------------------------------------


def _ghost_grid(st, config, shape):
    """A state's positions as the grid engine's ghost grids on a CPU
    `LocalMesh` (NaN in empty slots): ((shards·(mz+2)(my+2)(mx+2), C, 3),
    the mesh)."""
    from emdee_tpu_torch.distributed import grid_sharded as gs
    from emdee_tpu_torch.distributed.mesh import LocalMesh

    mesh = LocalMesh(shape, "cpu")
    sh = gs.distribute_grid(st, config, mesh)
    g = gs._ghost3(torch.where(sh.valid, sh.positions.movedim(-1, 0), float("nan")), mesh)
    return g.movedim(0, -1).reshape(-1, config.capacity, 3), mesh


def _check_ghost_cull(st, config, shape, cut2, edge_cells_only=False):
    """For every own cell of the (2,2,2)-or-other mesh and every half-shell
    offset, K5s-mol's cull (`cull_pair` with the shift `ghost_phase` takes
    from the neighbour's global cell index, on the raw ghost coordinates)
    keeps both atoms of every pair whose float32 r² is below cut2 (with a
    margin of 1e-5); returns the pairs checked."""
    gpos, mesh = _ghost_grid(st, config, shape)
    m = config.cells_per_dim
    local = tuple(m // s for s in shape)
    n_own = int(np.prod(shape)) * int(np.prod(local))
    checked = 0
    for cell in range(n_own):
        x, y, z = cell % local[2], (cell // local[2]) % local[1], (cell // (local[2] * local[1])) % local[0]
        if edge_cells_only and all(0 < v < n - 1 for v, n in zip((z, y, x), local)):
            continue
        for phase in range(1, 14):
            home, nbi, shift = sk.ghost_phase(cell, phase, shape, mesh.base, local, m, float(config.box))
            cen, nb = gpos[home], gpos[nbi]
            cen, nb = cen[~torch.isnan(cen[:, 0])], nb[~torch.isnan(nb[:, 0])]
            if len(cen) == 0 or len(nb) == 0:
                continue
            shift = torch.tensor(shift, dtype=torch.float32)
            keep_c, keep_n = sk.cull_pair(cen, nb, shift, cut2)
            d = (cen[:, None, :] - nb[None, :, :]) - shift
            r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
            inside = r2 < cut2 * (1 + 1e-5)
            assert bool(keep_c[inside.any(1)].all()), (cell, phase)
            assert bool(keep_n[inside.any(0)].all()), (cell, phase)
            checked += int(inside.sum())
    return checked


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 5, 1)])
def test_ghost_cull_keeps_every_inside_pair_on_the_grid_charged_fixture(shape):
    """The grid's charged fixture (2,048 atoms, M = 10, as the reference's
    grid test builds it), drifted 0.45·skin along the velocities across cell
    faces, shard faces and the seam, on (2,2,2) and (2,5,1)."""
    st, config, _ = fixtures.grid_charged_state("cpu")
    v = st.velocities
    st = st._replace(positions=torch.where(
        st.valid[..., None], st.positions + (0.45 * fixtures.CHARGED_SKIN / float(v.abs().max())) * v, 0.0))
    cut2 = max(float(config.cutoff) ** 2, float(fixtures.CUTOFF) ** 2)
    assert _check_ghost_cull(st, config, shape, cut2) > 4_000


def test_ghost_cull_keeps_every_inside_pair_on_a_drifted_water_slice():
    """The 98,304-atom water box binned (M = 12), then every atom moved by
    up to skin/2 on each axis (numpy seed 5), as between rebins, on (2,2,2):
    the own cells on a shard face, whose neighbours lie in the ghost
    layers, some across the seam."""
    from emdee_tpu_torch import cell_dense_init

    box, config, _, _, params = water.water_setup("cpu", spill=False)
    st = cell_dense_init(box["positions"], box["velocities"], box["masses"], params, config,
                         charges=box["charges"], device="cpu")
    rng = np.random.default_rng(5)
    drift = torch.from_numpy(rng.uniform(-0.5 * water.SKIN, 0.5 * water.SKIN, st.positions.shape).astype(np.float32))
    st = st._replace(positions=torch.where(st.valid[..., None], st.positions + drift, 0.0))
    assert _check_ghost_cull(st, config, (2, 2, 2), config.cutoff**2, edge_cells_only=True) > 1_000_000


def _check_k2c_cull(pos, valid, m, box, cut2, cells):
    """For each cell of `cells`, every warp of 32 live centres (slot order)
    and each of the 27 neighbour cells, K2c's cull (`k2c_cull`, the warp's
    centre box shifted back by the cell's periodic shift) keeps every
    neighbour atom within the cutoff (float32 r², margin 1e-5) of a centre
    of the warp; returns the pairs checked.  pos (M³, C, 3), valid (M³, C)."""
    checked = 0
    for cell in cells:
        cen_all = pos[cell][valid[cell]]
        z, y, x = cell // (m * m), (cell // m) % m, cell % m
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    idx, shift = [], []
                    for v, d in zip((x, y, z), (dx, dy, dz)):
                        shift.append(-box if v + d < 0 else (box if v + d >= m else 0.0))
                        idx.append((v + d) % m)
                    j = (idx[2] * m + idx[1]) * m + idx[0]
                    nb = pos[j][valid[j]]
                    shift = torch.tensor(shift, dtype=torch.float32)
                    for w0 in range(0, len(cen_all) if len(nb) else 0, 32):
                        cen = cen_all[w0:w0 + 32]
                        keep = cell_kernel.k2c_cull(cen, nb, shift, cut2)
                        d = (cen[:, None, :] - nb[None, :, :]) - shift
                        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
                        inside = r2 < cut2 * (1 + 1e-5)
                        assert bool(keep[inside.any(0)].all()), (cell, dz, dy, dx, w0)
                        checked += int(inside.sum())
    return checked


@pytest.mark.parametrize("capacity", [None, 80])
def test_k2c_cull_keeps_every_inside_pair_on_the_charged_fixture(capacity):
    """The 864-atom fixture (drifted 0.45·skin across faces and the seam),
    at C = 24 and at C = 80 (up to three warps a cell, each its own box)."""
    st, config, _, coul, _ = fixtures.charged_fixture("cpu", capacity)
    m = config.cells_per_dim
    cut2 = max(float(config.cutoff) ** 2, float(coul.rc2))
    assert _check_k2c_cull(st.positions, st.valid, m, float(config.box), cut2, range(m**3)) > 10_000


def test_k2c_cull_keeps_every_inside_pair_on_a_drifted_water_slice(water_lattice):
    """The water lattice binned, then every atom moved by up to skin/2 on
    each axis (numpy seed 3): the cells of the z = 0 and z = M − 1 layers at
    y ∈ {0, M − 1}, which meet every seam, their atoms in warps of 32."""
    pos, cell_of, m, edge, cut2 = water_lattice
    rng = np.random.default_rng(3)
    cells = _cells(pos + rng.uniform(-0.5 * water.SKIN, 0.5 * water.SKIN, pos.shape), cell_of, m)
    c = max(len(t) for t in cells)
    stacked = torch.zeros((m**3, c, 3))
    valid = torch.zeros((m**3, c), dtype=torch.bool)
    for i, t in enumerate(cells):
        stacked[i, : len(t)] = t
        valid[i, : len(t)] = True
    centres = [(z * m + y) * m + x for z in (0, m - 1) for y in (0, m - 1) for x in range(m)]
    assert _check_k2c_cull(stacked, valid, m, edge, cut2, centres) > 100_000


def test_k2c_and_k5s_mol_shared_memory_and_scratch_at_the_smoke_shapes():
    """K2c's block (`cell_kernel.mol_smem_bytes`: four warps' tiles, lists,
    tags and rank maps) at the water box's C = 80 (the step launch with E =
    E_b = 2, the energy launch with E = 2) and from C = 256 on (a warp
    stages at most 256 slots at once) with eight tags and bond tags, within
    a block's 232,448 B.
    K5s-mol's block at the 985,527-atom box (C = 88, E = 2, energies) is
    K5c's without bond tags, and its scratch on (2,2,2) (8 shards of 13³
    cells: 14 slices over 1,546,688 own slots and 13 over 2,376,000 ghost
    slots) is 630.5 MB forces only and 1.05 GB with energies."""
    assert cell_kernel.mol_smem_bytes(80, 2, 2) == 4 * 4 * (8 * 96 + 8 * 96 + 3 * 4 * 32 + 32) == 31_232
    assert cell_kernel.mol_smem_bytes(80, 2, 0) == 28_160
    assert cell_kernel.mol_smem_bytes(1024, 8, 8) == cell_kernel.mol_smem_bytes(256, 8, 8) == 90_624 <= 232_448
    config = fixtures.charged_fixture("cpu")[1]
    assert sk.smem_bytes(config._replace(capacity=88), True, True, 2) == 47_872
    assert sk.ghost_scratch_bytes(8, (13, 13, 13), 88, False, mol=True) == 630_499_584
    assert sk.ghost_scratch_bytes(8, (13, 13, 13), 88, True, mol=True) == 1_050_832_640


def _check_k2cg_cull(st, config, shape, cut2, face_cells_only=False):
    """For the own cells of `shape`'s ghost grids (with `face_cells_only`,
    those on a shard's z and y faces), every warp of 32 live centres (slot
    order) and each of the 27 ghost neighbours, K2c-G's cull (`k2c_cull`
    with the shift of `ghost_lj_table`, the neighbour's global cell index,
    on the raw ghost coordinates) keeps every neighbour atom whose float32
    r² ((x_i − x_j) − shift) to a centre of the warp is below cut2 (margin
    1e-5); returns (pairs checked, those across the seam)."""
    gpos, mesh = _ghost_grid(st, config, shape)
    m = config.cells_per_dim
    local = tuple(m // s for s in shape)
    checked = seams = 0
    for cell in range(int(np.prod(shape)) * int(np.prod(local))):
        y, z = (cell // local[2]) % local[1], (cell // (local[2] * local[1])) % local[0]
        if face_cells_only and (z not in (0, local[0] - 1) or y not in (0, local[1] - 1)):
            continue
        home, first, shift = cell_kernel.ghost_lj_table(cell, shape, mesh.base, local, m, float(config.box))
        cen_all = gpos[home][~torch.isnan(gpos[home][:, 0])]
        for code in range(27):
            nb = gpos[first[code]][~torch.isnan(gpos[first[code]][:, 0])]
            sh = torch.tensor(shift[code], dtype=torch.float32)
            for w0 in range(0, len(cen_all) if len(nb) else 0, 32):
                cen = cen_all[w0:w0 + 32]
                keep = cell_kernel.k2c_cull(cen, nb, sh, cut2)
                d = (cen[:, None, :] - nb[None, :, :]) - sh
                r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
                inside = r2 < cut2 * (1 + 1e-5)
                assert bool(keep[inside.any(0)].all()), (cell, code, w0)
                checked += int(inside.sum())
                seams += int(inside.sum()) if any(shift[code]) else 0
    return checked, seams


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 5, 1)])
def test_k2cg_cull_keeps_every_inside_pair_on_the_grid_charged_fixture(shape):
    """K2c-G's cull at max(rc², rc_C²) on the grid's charged fixture (2,048
    atoms, M = 10), drifted 0.45·skin along the velocities across cell
    faces, shard faces and the seam, on (2,2,2) and (2,5,1): every own cell
    against its 27 ghost neighbours."""
    st, config, _ = fixtures.grid_charged_state("cpu")
    v = st.velocities
    st = st._replace(positions=torch.where(
        st.valid[..., None], st.positions + (0.45 * fixtures.CHARGED_SKIN / float(v.abs().max())) * v, 0.0))
    coul = fixtures.grid_charged_kwargs("cpu")["coulomb"]
    cut2 = max(float(config.cutoff) ** 2, float(coul.rc2))
    checked, seams = _check_k2cg_cull(st, config, shape, cut2)
    assert checked > 10_000 and seams > 400, (checked, seams)


def test_k2cg_cull_keeps_every_inside_pair_on_a_drifted_water_slice():
    """K2c-G's cull at max(rc², rc_C²) on the 98,304-atom water box binned
    at M = 12, C = 80, every atom then moved by up to skin/2 on each axis
    (numpy seed 8), as between rebins, sharded (2,2,2): the own cells on a
    shard's z and y faces, whose neighbours lie in the ghost layers, some
    across the seam, their centres in warps of 32 (up to three a cell)."""
    from emdee_tpu_torch import cell_dense_init

    box, config, _, coul, params = water.water_setup("cpu", spill=False)
    st = cell_dense_init(box["positions"], box["velocities"], box["masses"], params, config,
                         charges=box["charges"], device="cpu")
    rng = np.random.default_rng(8)
    drift = torch.from_numpy(rng.uniform(-0.5 * water.SKIN, 0.5 * water.SKIN, st.positions.shape).astype(np.float32))
    st = st._replace(positions=torch.where(st.valid[..., None], st.positions + drift, 0.0))
    assert int(st.valid.sum(1).max()) > 64  # three warps in the fullest cells
    cut2 = max(float(config.cutoff) ** 2, float(coul.rc2))
    checked, seams = _check_k2cg_cull(st, config, (2, 2, 2), cut2, face_cells_only=True)
    assert checked > 1_000_000 and seams > 100_000, (checked, seams)


@pytest.mark.parametrize("c,ne", [(80, 2), (1024, 8)])
def test_k2cg_shared_memory_fits_a_block(c, ne):
    """K2c-G's block (`mol_smem_bytes(..., ghost=True)`: K2c's four warps'
    tiles, lists, tags and rank maps with no bond tags, plus each warp's
    table of the 27 neighbours' shifts and first slots, 4·27 words) at the
    water box's C = 80 with its two tags, and at the largest C the entry
    takes with eight tags (a warp stages at most 256 slots at once), as the
    C source's `mol_warp_floats` counts it, within a block's 232,448 B."""
    nt = min(32 * -(-c // 32), 256)
    want = 4 * 4 * (8 * nt + 8 * nt + 3 * ne * 32 + 32 + 4 * 27)
    got = cell_kernel.mol_smem_bytes(c, ne, 0, ghost=True)
    assert got == want == {80: 29_888, 1024: 80_064}[c] <= 232_448
    assert got == cell_kernel.mol_smem_bytes(c, ne, 0) + 4 * 4 * 4 * 27


def test_ghost_phase_matches_the_plain_ghost_blocks():
    """`ghost_phase`'s neighbour index is the block of the ghost grid that
    the plain ghost pass takes for each offset (`ghost_tiles.block`), and
    its shift is ±box exactly where the neighbour's global cell index
    wraps, on (2,2,2) and (1,2,4) over M = 4."""
    from emdee_tpu_torch import LennardJonesModel
    from emdee_tpu_torch.neighbors.cell_kernel import ghost_tiles

    m, c = 4, 2
    for shape in ((2, 2, 2), (1, 2, 4)):
        local = tuple(m // s for s in shape)
        gz, gy, gx = (v + 2 for v in local)
        n_sh = int(np.prod(shape))
        index = torch.arange(n_sh * gz * gy * gx, dtype=torch.float32).reshape(n_sh, gz, gy, gx, 1)
        ghost = index.expand(n_sh, gz, gy, gx, c).reshape((1, *shape, gz, gy, gx, c)).expand(5, *shape, gz, gy, gx, c)
        config = fixtures.charged_fixture("cpu")[1]._replace(cells_per_dim=m, capacity=c)
        t = ghost_tiles(ghost.contiguous(), config, LennardJonesModel.create(2.5, 2.0, device="cpu"), (0.5, 2.0), False)
        base = (0, 0, 0)
        for phase in range(1, 14):
            dz, dy, dx = sk.PHASE_OFFSETS[phase - 1]
            block = t.block(t.pos_g[..., 0], (dx, dy, dz))[:, 0]
            for cell in range(n_sh * int(np.prod(local))):
                home, nb, shift = sk.ghost_phase(cell, phase, shape, base, local, m, 12.0)
                assert nb == int(block[cell]) and home == int(t.pos[cell, 0, 0])
                x, y, z = cell % local[2], (cell // local[2]) % local[1], (cell // (local[2] * local[1])) % local[0]
                s = cell // int(np.prod(local))
                glob = ((s % shape[2]) * local[2] + x + dx, ((s // shape[2]) % shape[1]) * local[1] + y + dy,
                        (s // (shape[2] * shape[1])) * local[0] + z + dz)
                assert shift == [12.0 * ((v >= m) - (v < 0)) for v in glob]
