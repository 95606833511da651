"""Device milliseconds a sweep of the site update: the operations launched
inside the program's ``repro_torch.checkerboard.flip`` span
(``core.checkerboard._flip``: on the card the flip kernel's launch for the
LUT rule at a number beta, else the rule's eager chain)."""
from perfbench import spans

FLIP = "repro_torch.checkerboard.flip"


def read(w):
    s = spans.launched_seconds(w, (FLIP,))
    if s is None or not w.sweeps:
        return None
    return 1e3 * s / w.sweeps
