"""Device milliseconds a sweep of the program's eager random draws: the
operations launched inside its ``repro_torch.random.draws`` span
(``random.bits``, ``random.uniform`` and ``random.randint``: the threefry
hash in int64 lanes and the conversion to the draw's dtype)."""
from perfbench import spans

DRAWS = "repro_torch.random.draws"


def read(w):
    s = spans.launched_seconds(w, (DRAWS,))
    if s is None or not w.sweeps:
        return None
    return 1e3 * s / w.sweeps
