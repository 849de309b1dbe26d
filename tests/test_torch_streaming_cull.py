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
SM at the water boxes' geometries.  No card is touched."""

import numpy as np
import pytest
import torch

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


def test_cull_keeps_every_inside_pair_on_the_charged_fixture():
    st, config, _, coul, _ = fixtures.charged_fixture("cpu")
    m, c = config.cells_per_dim, config.capacity
    pos = st.positions.reshape(-1, 3).numpy()
    valid = st.valid.reshape(-1).numpy()
    cell_of = np.repeat(np.arange(m**3), c)[valid]
    cells = _cells(pos[valid], cell_of, m)
    cut2 = max(float(config.cutoff) ** 2, float(coul.rc2))
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
@pytest.mark.parametrize("geometry", [(12, 80), (26, 88)])
def test_k5c_blocks_fit_four_an_sm(geometry, energy):
    """K5c's block (4 warps) at the water boxes' geometries, with the water
    tags (E = 2, E_b = 2 on the step launch, none on the energy launch),
    fits four to an SM's 233,472 shared bytes (1,024 reserved a block):
    shared memory allows the 16 warps an SM that its 128 registers a thread
    allow, whatever M."""
    m, c = geometry
    config = fixtures.charged_fixture("cpu")[1]._replace(cells_per_dim=m, capacity=c)
    smem = sk.smem_bytes(config, energy, True, 2, 0 if energy else 2)
    assert smem == 4 * 4 * (2 * 8 * 96 + 3 * (2 if energy else 4) * 96 + 2 * (5 if energy else 3) * c)
    assert 4 * (smem + 1024) <= 233_472
