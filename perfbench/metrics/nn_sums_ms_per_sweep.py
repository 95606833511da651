"""Device milliseconds a sweep of the Algorithm-2 neighbour sums: the
operations launched inside the program's ``repro_torch.checkerboard.nn``
span (``core.checkerboard.nn_black`` / ``nn_white``: the K-hat matmuls,
the four halo lines and their adds). The f32 chain of ``stats`` enters it
once a chunk too, for its white sums."""
from perfbench import spans


def read(w):
    s = spans.launched_seconds(w, ("repro_torch.checkerboard.nn",))
    if s is None or not w.sweeps:
        return None
    return 1e3 * s / w.sweeps
