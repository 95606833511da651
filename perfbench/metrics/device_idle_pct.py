"""The share of the traced window in which no operation ran on the
device."""


def read(w):
    if not w.ops:
        return None
    return 100.0 * (1.0 - w.busy_seconds() / (w.t1 - w.t0))
