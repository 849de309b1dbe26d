"""The NVE drift statistic of a sampled energy series, shared by the
full-tier drift test (`tests/test_torch_cell_dense_sim.py`) and
`chip_smoke.py`'s float64 drift window.

tests/test_fidelity.py:73 reads the drift as the difference of one total
energy sample at each end of a 500-step window.  The total energy of a
leapfrog trajectory swings about its trend by about as much as the 1e-6 of
KE that the gate allows, so that reading depends on where in its swing each
end falls.  `drift_line` reads the trend from a longer series instead."""

from __future__ import annotations

import numpy as np

# The reference test's window (steps): a fitted rise is quoted over it.
SPAN = 500


def drift_line(steps, energies, ke0: float, span: int = SPAN):
    """(rise, ends, swing) of a total-energy series, each as a fraction of
    the kinetic energy ke0: rise, the least-squares line's slope times
    `span` steps; ends, the mean of the last tenth of the samples less that
    of the first tenth; swing, the std of the samples about the line.  Rise
    and ends are signed.  steps: the step of each sample; energies: the
    total energies (float64)."""
    t = np.asarray(steps, np.float64)
    e = np.asarray(energies, np.float64)
    e = e - e[0]  # the line's conditioning: the swing is ~1e-10 of E
    slope, icept = np.polyfit(t, e, 1)
    tenth = max(len(e) // 10, 1)
    ends = e[-tenth:].mean() - e[:tenth].mean()
    swing = np.std(e - (slope * t + icept))
    return slope * span / ke0, ends / ke0, swing / ke0
