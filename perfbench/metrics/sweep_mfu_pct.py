"""The whole sweep's share of the chip's peak: the least time one
Metropolis sweep's work needs (:func:`perfbench.work.sweep_bound_s`,
counted from the lattice alone) over the traced window's seconds a
sweep."""
from perfbench import work


def read(w):
    if w.config.get("algorithm") != "metropolis" or not w.sweeps:
        return None
    return 100.0 * work.sweep_bound_s(w.sites) / (w.seconds / w.sweeps)
