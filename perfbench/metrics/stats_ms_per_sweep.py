"""Device milliseconds a sweep of everything but the keyed launches: in a
measured checkerboard chain, ``core.measure.blocked_stats`` and the
engine's block and unblock copies."""
from perfbench import work


def read(w):
    if not w.sweeps or not any(work.is_keyed_tile_launch(op.name)
                               for op in w.ops):
        return None
    rest = sum(op.seconds for op in w.ops
               if not work.is_keyed_tile_launch(op.name))
    return 1e3 * rest / w.sweeps
