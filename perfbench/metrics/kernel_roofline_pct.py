"""The keyed tile kernel's share of its roofline: one colour's bound
(:func:`perfbench.work.colour_bound_s`) over the mean device time of one
keyed launch in the traced window."""
from perfbench import work


def read(w):
    keyed = [op.seconds for op in w.ops if work.is_keyed_tile_launch(op.name)]
    if not keyed:
        return None
    return 100.0 * work.colour_bound_s(w.sites) / (sum(keyed) / len(keyed))
