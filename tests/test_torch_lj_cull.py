"""The LJ resident force pass's cull on the CPU (K2a, K2b and K3's grid
side: `csrc/cell_forces.cu` `cell_lj_kernel`), through its plain mirror
`cell_kernel.k2c_cull` at rc² — a warp's box of up to 32 live centres of a
cell (slot order), shifted back by each neighbour's periodic shift,
against each of the 27 neighbour cells: on the 97,556-atom melt (FCC 29³
at ρ* = 0.8442, M = 17) binned and then drifted by up to skin/2 on each
axis, at the wide capacity C = 32 and at the straggler grid's C_t = 28,
and on the 864-atom charged fixture at C = 32, no pair whose float32 r² is
below rc² is dropped; on a uniform fluid at the melt's density the kept
share of a neighbour's atoms by face, edge and corner offset agrees with
the geometric reckoning; and the kernel's shared memory and launch fit the
smoke's shapes.  The one-card streaming LJ pass's cull (K5:
`csrc/cell_forces_streaming.cu` `streaming_lj_kernel`), through its mirror
`streaming_kernel.cull_pair` at rc² over the 13 half-shell offsets — the
neighbour's box against the centres, then the kept centres' box against
the neighbour — drops no such pair on the 1,000,188-atom melt (FCC 63³, M
= 37) drifted by up to skin/2 (and on the 864-atom fixture at C = 32, in
test_torch_streaming_cull.py); and K5's scratch at the melts is what the wrapper allocates.  No card is
touched.  K2-G, the LJ pass on the grid's ghost grids: its per-warp
table (`cell_kernel.ghost_lj_table`) against the plain ghost pass's blocks
and the one-card neighbours on (1,1,1), (2,2,2) and (2,4,1), and its cull
(the table's shift, `k2c_cull` at rc²) on the drifted melt sharded (2,2,2);
and K5s's, K5's kernel on the ghost grids (`cull_pair` at rc² with the
shift `streaming_kernel.ghost_phase` takes from the neighbour's global cell
index), on the same sharded melt."""

import numpy as np
import pytest
import torch

from emdee_tpu_torch.neighbors import cell_kernel
from emdee_tpu_torch.neighbors import streaming_kernel as sk
from emdee_tpu_torch.tools import fixtures
from emdee_tpu_torch.tools.melt import CUTOFF, DENSITY, N_CELLS, N_CELLS_1M, SKIN
from emdee_tpu_torch.utils.lattice import fcc_lattice
from test_torch_streaming_cull import _cells, _check_k2c_cull, _check_no_inside_pair_dropped

M = 17  # the melt's wide config: 97,556 atoms in 17³ cells of 2.865σ


def _binned(pos, box, m, capacity):
    """Positions binned into (m³, capacity, 3) slots in atom order (a cell's
    atoms past `capacity` left out, as the straggler grid parks them) and
    the valid mask."""
    cell_of = (np.floor(pos / (box / m)).astype(np.int64) % m) @ np.array([1, m, m * m])
    order = np.argsort(cell_of, kind="stable")
    bounds = np.searchsorted(cell_of[order], np.arange(m**3 + 1))
    stacked = torch.zeros((m**3, capacity, 3))
    valid = torch.zeros((m**3, capacity), dtype=torch.bool)
    for i in range(m**3):
        atoms = pos[order[bounds[i]:bounds[i + 1]]][:capacity]
        stacked[i, : len(atoms)] = torch.from_numpy(atoms.astype(np.float32))
        valid[i, : len(atoms)] = True
    return stacked, valid


@pytest.mark.parametrize("capacity", [32, 28])
def test_lj_cull_keeps_every_inside_pair_on_the_drifted_melt(capacity):
    """The melt's lattice binned, then every atom moved by up to skin/2 on
    each axis (numpy seed 4), as between rebins: the cells of the z = 0 and
    z = M − 1 layers at y ∈ {0, M − 1}, which meet every seam, at C = 32
    (bench.py's wide config) and C_t = 28 (its straggler grid)."""
    pos, box = fcc_lattice(N_CELLS, density=DENSITY)
    stacked, valid = _binned(pos, box, M, capacity)
    drift = np.random.default_rng(4).uniform(-0.5 * SKIN, 0.5 * SKIN, stacked.shape).astype(np.float32)
    stacked = torch.where(valid[..., None], stacked + torch.from_numpy(drift), 0.0)
    assert int(valid.sum(1).max()) == capacity
    centres = [(z * M + y) * M + x for z in (0, M - 1) for y in (0, M - 1) for x in range(M)]
    assert _check_k2c_cull(stacked, valid, M, box, CUTOFF**2, centres) > 50_000


def test_lj_cull_keeps_every_inside_pair_on_the_charged_fixture():
    """The 864-atom fixture (drifted 0.45·skin across faces and the seam)
    at the LJ pass's C = 32, at rc² alone."""
    st, config, _, _, _ = fixtures.charged_fixture("cpu", 32)
    m = config.cells_per_dim
    assert _check_k2c_cull(st.positions, st.valid, m, float(config.box), CUTOFF**2, range(m**3)) > 10_000


def test_lj_cull_kept_shares_match_the_reckoning():
    """Kept share of a neighbour cell's atoms against a warp's centre box,
    by the kind of offset, over 64 cells of a uniform fluid at the melt's
    density (97,556 points, numpy seed 2; M = 17, h = 2.865, rc = 2.5).
    The reckoning: the neighbour's atoms spread evenly, the box the cell
    inset on each side by δ = h/(n̄ + 1), the mean gap of n̄ = 19.9 points;
    a face keeps (rc − δ)/h, an edge and a corner the share of the square
    and the cube within rc of the box's inset edge and corner (float64
    quadrature): 0.825, 0.516, 0.268."""
    n = 97_556
    box = (n / DENSITY) ** (1.0 / 3.0)
    h, rc = box / M, CUTOFF
    stacked, valid = _binned(np.random.default_rng(2).uniform(0.0, box, (n, 3)), box, M, 40)
    kept = {1: [0, 0], 2: [0, 0], 3: [0, 0]}
    for cell in range(0, M**3, M**3 // 64):
        z, y, x = cell // (M * M), (cell // M) % M, cell % M
        cen = stacked[cell][valid[cell]][:32]
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    kind = (dz != 0) + (dy != 0) + (dx != 0)
                    if kind == 0:
                        continue
                    idx, shift = [], []
                    for v, d in zip((x, y, z), (dx, dy, dz)):
                        shift.append(-box if v + d < 0 else (box if v + d >= M else 0.0))
                        idx.append((v + d) % M)
                    j = (idx[2] * M + idx[1]) * M + idx[0]
                    keep = cell_kernel.k2c_cull(cen, stacked[j][valid[j]], torch.tensor(shift), rc * rc)
                    kept[kind][0] += int(keep.sum())
                    kept[kind][1] += len(keep)
    delta = h / (n / M**3 + 1.0)
    g2 = (np.arange(200) + 0.5) / 200 * h + delta
    g3 = (np.arange(80) + 0.5) / 80 * h + delta
    want = {1: (rc - delta) / h,
            2: float((g2[:, None] ** 2 + g2[None, :] ** 2 < rc * rc).mean()),
            3: float((g3[:, None, None] ** 2 + g3[None, :, None] ** 2 + g3[None, None, :] ** 2 < rc * rc).mean())}
    assert [round(want[k], 3) for k in (1, 2, 3)] == [0.825, 0.516, 0.268]
    for kind, share in want.items():
        assert abs(kept[kind][0] / kept[kind][1] - share) <= 0.03, (kind, kept[kind], share)


@pytest.mark.parametrize("m,capacity", [(17, 32), (17, 28), (37, 32), (16, 32), (17, 1024)])
def test_lj_shared_memory_and_launch_fit_the_smoke_shapes(m, capacity):
    """The LJ pass's block (`cell_kernel.lj_smem_bytes`: four warps' staged
    chunks of 32 entries, the 27 shifts and first slots, and the rank maps)
    is 5,312 B at every shape — the wide melt (M = 17, C = 32), the
    straggler grid (C_t = 28, its Kn = 16 aux atoms staged 32 at a time
    too), the 1M melt (M = 37), the spill config (M = 16) and the largest
    capacity the entry takes (C = 1024, 32 warps a cell) — so shared memory
    and the warp slots allow the 8 blocks an SM that the launch bounds ask
    the registers for; a warp takes 32 live centres of a cell."""
    config = fixtures.charged_fixture("cpu")[1]._replace(cells_per_dim=m, capacity=capacity)
    shape = cell_kernel.lj_launch_shape(config)
    assert cell_kernel.lj_smem_bytes() == shape["smem_bytes"] == 4 * 4 * (6 * 32 + 4 * 27 + 32) == 5_312
    assert shape["blocks_per_sm_smem"] == 36 and shape["blocks_per_sm_warps"] == 16
    assert min(shape["blocks_per_sm_smem"], shape["blocks_per_sm_warps"]) >= cell_kernel.LJ_MIN_BLOCKS
    assert shape["warps"] == m**3 * -(-capacity // 32) and shape["blocks"] == -(-shape["warps"] // 4)
    if (m, capacity) == (17, 32):
        assert shape["warps"] == 4_913 and round(shape["waves"], 3) == 1.163


def test_k5_cull_keeps_every_inside_pair_on_the_drifted_1m_melt():
    """bench_all.py's 1M melt (FCC 63³ at ρ* = 0.8442, 1,000,188 atoms)
    binned into M = 37 cells of 2.86σ (the C = 32 config), then every atom
    moved by up to skin/2 on each axis (numpy seed 6), as between rebins:
    K5's cull over the 13 half-shell offsets, for the cells of the z = 0 and
    z = M − 1 layers at y ∈ {0, M − 1}, which meet every seam."""
    m = 37
    pos, box = fcc_lattice(N_CELLS_1M, density=DENSITY)
    assert len(pos) == 1_000_188 and box / m > CUTOFF
    cell_of = (np.floor(pos / (box / m)).astype(np.int64) % m) @ np.array([1, m, m * m])
    assert np.bincount(cell_of, minlength=m**3).max() <= 32
    drift = np.random.default_rng(6).uniform(-0.5 * SKIN, 0.5 * SKIN, pos.shape)
    cells = _cells(pos + drift, cell_of, m)
    centres = [(z * m + y) * m + x for z in (0, m - 1) for y in (0, m - 1) for x in range(m)]
    assert _check_no_inside_pair_dropped(cells, centres, m, box, CUTOFF**2) > 40_000


@pytest.mark.parametrize("m,want", [(17, (26_412_288, 44_020_480)), (37, (272_310_528, 453_850_880))])
def test_k5_scratch_at_the_melts(m, want):
    """K5's scratch as `cell_forces_streaming` allocates it, a warp walking
    its cell's 14 phases: one centre slice and 13 reaction slices of (n_r,
    M³·C) float32 — at the 97,556-atom melt (M = 17, C = 32) 26.4 MB forces
    only and 44.0 MB with energies, at the 1M melt (M = 37) 272.3 MB and
    453.9 MB, written once by the pair pass and read once by the fold."""
    config = fixtures.charged_fixture("cpu")[1]._replace(cells_per_dim=m, capacity=32)
    assert sk.K5_SLICES == 14
    assert (sk.scratch_bytes(config, False), sk.scratch_bytes(config, True)) == want
    assert want[0] == 4 * 14 * 3 * m**3 * 32


# ---------------------------------------------------------------------------
# K2-G: the LJ pass's GHOST mode on the grid's ghost grids
# ---------------------------------------------------------------------------


def _slots_state(stacked, valid):
    """A one-card CellDenseState of binned positions and their valid mask
    (every other field zero), for sharding with `distribute_grid`."""
    from emdee_tpu_torch.neighbors.cell_dense import CellDenseState

    z = torch.zeros(valid.shape)
    return CellDenseState(stacked, torch.zeros_like(stacked), z, z, z, torch.zeros(valid.shape, dtype=torch.int32),
                          valid, stacked, torch.tensor(0, dtype=torch.int32), torch.tensor(False))


def _ghost_positions(stacked, valid, config, shape):
    """The grid engine's ghost grids of these slots on a CPU `LocalMesh` of
    `shape` (NaN in empty slots), flattened: ((shards·(mz+2)(my+2)(mx+2), C,
    3), the mesh)."""
    from emdee_tpu_torch.distributed import grid_sharded as gs
    from emdee_tpu_torch.distributed.mesh import LocalMesh

    mesh = LocalMesh(shape, "cpu")
    sh = gs.distribute_grid(_slots_state(stacked, valid), config, mesh)
    g = gs._ghost3(torch.where(sh.valid, sh.positions.movedim(-1, 0), float("nan")), mesh)
    return g.movedim(0, -1).reshape(-1, config.capacity, 3), mesh


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2), (2, 4, 1)])
def test_k2g_table_matches_the_ghost_blocks_and_the_one_card_neighbours(shape):
    """K2-G's per-warp table (`cell_kernel.ghost_lj_table`: each of the 27
    neighbours' ghost cell and the shift of its global cell index): the
    ghost cell is the block of the ghost grid that the plain
    ghost pass takes at that offset (`ghost_tiles.block`), it holds the
    one-card neighbour cell at the wrapped index (the slots carry each
    cell's global id), and the shift is the one the one-card LJ pass takes
    for that neighbour — ±box exactly where the index wraps.  M = 8, so
    that (2,4,1) has two cell layers a shard.  So the warp
    sees the one-card walk's slots and shifts, the ground of bit-for-bit
    equality on every decomposition."""
    from emdee_tpu_torch import LennardJonesModel

    m, c, box = 8, 2, 24.0
    config = fixtures.charged_fixture("cpu")[1]._replace(cells_per_dim=m, capacity=c, box=box)
    ids = torch.arange(m**3, dtype=torch.float32)[:, None, None].expand(m**3, c, 3).contiguous()
    gpos, mesh = _ghost_positions(ids, torch.ones((m**3, c), dtype=torch.bool), config, shape)
    local = tuple(m // s for s in shape)
    n_sh, gdims = int(np.prod(shape)), tuple(v + 2 for v in local)
    index = torch.arange(n_sh * int(np.prod(gdims)), dtype=torch.float32).reshape((n_sh, *gdims, 1))
    ghost = index.expand((n_sh, *gdims, c)).reshape((1, *shape, *gdims, c)).expand((5, *shape, *gdims, c))
    t = cell_kernel.ghost_tiles(ghost.contiguous(), config, LennardJonesModel.create(2.5, 2.0, device="cpu"),
                                (0.5, 2.0), False)
    for cell in range(n_sh * int(np.prod(local))):
        home, first, shift = cell_kernel.ghost_lj_table(cell, shape, mesh.base, local, m, box)
        assert home == int(t.pos[cell, 0, 0])
        own = int(gpos[home, 0, 0])
        z, y, x = own // (m * m), (own // m) % m, own % m
        for code in range(27):
            dz, dy, dx = code // 9 - 1, (code // 3) % 3 - 1, code % 3 - 1
            assert first[code] == int(t.block(t.pos_g[..., 0], (dx, dy, dz))[cell, 0])
            wrapped = (((z + dz) % m) * m + (y + dy) % m) * m + (x + dx) % m
            assert int(gpos[first[code], 0, 0]) == wrapped
            assert shift[code] == [box * ((v + d >= m) - (v + d < 0)) for v, d in zip((x, y, z), (dx, dy, dz))]


def test_k2g_cull_keeps_every_inside_pair_on_the_drifted_melt_sharded_222():
    """K2-G's cull on the ghost grids: the melt's lattice binned at the
    grid's M = 16, C = 40 (`reconfigure_dense_state(cells_multiple_of=2)`'s
    config for the smoke's (2,2,2) runs), every atom moved by up to skin/2
    on each axis (numpy seed 7), as between rebins, sharded (2,2,2) into
    ghost grids: for the own cells on a shard's z and y faces (whose
    neighbours lie in the ghost layers, some across the seam), each warp of
    32 live centres (slot order) keeps, by `k2c_cull` at rc² with the
    table's shift (`ghost_lj_table`), every neighbour atom whose float32 r²
    to one of its centres ((x_i − x_j) − shift, on the raw ghost
    coordinates) is below rc²."""
    m, capacity, shape = 16, 40, (2, 2, 2)
    pos, box = fcc_lattice(N_CELLS, density=DENSITY)
    stacked, valid = _binned(pos, box, m, capacity)
    assert int(valid.sum()) == len(pos)
    drift = np.random.default_rng(7).uniform(-0.5 * SKIN, 0.5 * SKIN, stacked.shape).astype(np.float32)
    stacked = torch.where(valid[..., None], stacked + torch.from_numpy(drift), 0.0)
    config = fixtures.charged_fixture("cpu")[1]._replace(cells_per_dim=m, capacity=capacity, box=box)
    gpos, mesh = _ghost_positions(stacked, valid, config, shape)
    local = (8, 8, 8)
    cut2 = CUTOFF**2
    checked = 0
    for cell in range(8 * 512):
        y, z = (cell // 8) % 8, (cell // 64) % 8
        if z not in (0, 7) or y not in (0, 7):
            continue
        home, first, shift = cell_kernel.ghost_lj_table(cell, shape, mesh.base, local, m, box)
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
    assert checked > 200_000


def test_k5s_cull_keeps_every_inside_pair_on_the_drifted_melt_sharded_222():
    """K5s's cull on the ghost grids (K5's, at rc²): the same drifted melt
    at M = 16, C = 40, sharded (2,2,2) into ghost grids: for the own cells
    on a shard's z and y faces and every half-shell offset, `cull_pair` with
    the shift that `ghost_phase` takes from the neighbour's global cell
    index, on the raw ghost coordinates, keeps both atoms of every pair
    whose float32 r² ((x_i − x_j) − shift) is below rc² (with a margin of
    1e-5), across shard faces and the seam."""
    m, capacity, shape = 16, 40, (2, 2, 2)
    pos, box = fcc_lattice(N_CELLS, density=DENSITY)
    stacked, valid = _binned(pos, box, m, capacity)
    drift = np.random.default_rng(7).uniform(-0.5 * SKIN, 0.5 * SKIN, stacked.shape).astype(np.float32)
    stacked = torch.where(valid[..., None], stacked + torch.from_numpy(drift), 0.0)
    config = fixtures.charged_fixture("cpu")[1]._replace(cells_per_dim=m, capacity=capacity, box=box)
    gpos, mesh = _ghost_positions(stacked, valid, config, shape)
    local = (8, 8, 8)
    cut2 = CUTOFF**2
    checked = seams = 0
    for cell in range(8 * 512):
        y, z = (cell // 8) % 8, (cell // 64) % 8
        if z not in (0, 7) or y not in (0, 7):
            continue
        for phase in range(1, 14):
            home, nbi, shift = sk.ghost_phase(cell, phase, shape, mesh.base, local, m, float(box))
            cen, nb = gpos[home], gpos[nbi]
            cen, nb = cen[~torch.isnan(cen[:, 0])], nb[~torch.isnan(nb[:, 0])]
            if len(cen) == 0 or len(nb) == 0:
                continue
            sh = torch.tensor(shift, dtype=torch.float32)
            keep_c, keep_n = sk.cull_pair(cen, nb, sh, cut2)
            d = (cen[:, None, :] - nb[None, :, :]) - sh
            r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
            inside = r2 < cut2 * (1 + 1e-5)
            assert bool(keep_c[inside.any(1)].all()), (cell, phase)
            assert bool(keep_n[inside.any(0)].all()), (cell, phase)
            checked += int(inside.sum())
            seams += int(inside.sum()) if any(shift) else 0
    assert checked > 100_000 and seams > 10_000, (checked, seams)
