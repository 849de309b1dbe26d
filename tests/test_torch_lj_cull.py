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
smoke's shapes.  No card is touched."""

import numpy as np
import pytest
import torch

from emdee_tpu_torch.neighbors import cell_kernel
from emdee_tpu_torch.tools import fixtures
from emdee_tpu_torch.tools.melt import CUTOFF, DENSITY, N_CELLS, SKIN
from emdee_tpu_torch.utils.lattice import fcc_lattice
from test_torch_streaming_cull import _check_k2c_cull

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
