"""Work of a molecular system's force pass and rebin at a state."""

from mdbench.reference.cells import count_pairs, min_image
from mdbench.work import counts


def work(sim, positions) -> dict:
    ff, n = sim.forcefield, sim.num_atoms
    pairs = count_pairs(positions, ff.box, ff.cutoff)
    d = min_image(positions[ff.bonds[:, 0]].double() - positions[ff.bonds[:, 1]].double(), ff.box)
    bonded = int(((d * d).sum(-1) < ff.cutoff**2).sum())
    ops, nbytes = counts.molecular_force_pass(pairs, bonded, sim.work["e_tags"], sim.work["e_bonds"], n)
    return {"force": (ops, nbytes), "rebin": (0, counts.rebin(sim.work["rebin_fields"], n))}
