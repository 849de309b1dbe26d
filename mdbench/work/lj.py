"""Work of the LJ melt's force pass and rebin at a state."""

from mdbench.reference.cells import count_pairs
from mdbench.work import counts


def work(sim, positions) -> dict:
    n = sim.num_atoms
    ops, nbytes = counts.lj_force_pass(count_pairs(positions, sim.forcefield.box, sim.forcefield.cutoff), n)
    return {"force": (ops, nbytes), "rebin": (0, counts.rebin(sim.work["rebin_fields"], n))}
