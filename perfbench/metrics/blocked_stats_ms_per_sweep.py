"""Device milliseconds a sweep of the measurement: the operations launched
inside the program's ``repro_torch.measure.blocked_totals`` span (the white
colour's neighbour sums and the spin and bond sums of
``core.measure.blocked_totals``)."""
from perfbench import spans


def read(w):
    s = spans.launched_seconds(w, ("repro_torch.measure.blocked_totals",))
    if s is None or not w.sweeps:
        return None
    return 1e3 * s / w.sweeps
