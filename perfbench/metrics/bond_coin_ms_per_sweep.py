"""Device milliseconds a sweep of the cluster sweep's random draws and what
they decide: the operations launched inside the program's
``repro_torch.cluster.bonds`` span (the neighbour compares and the two bond
hashes) and ``repro_torch.cluster.coins`` span (the per-site coin hash)."""
from perfbench import spans


def read(w):
    s = spans.launched_seconds(w, ("repro_torch.cluster.bonds",
                                   "repro_torch.cluster.coins"))
    if s is None or not w.sweeps:
        return None
    return 1e3 * s / w.sweeps
