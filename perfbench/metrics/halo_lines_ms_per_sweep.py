"""Device milliseconds a sweep of the halo lines: the operations launched
inside the program's ``repro_torch.kernels.lines`` span, the gather of
each colour's four halo lines (``core.checkerboard.edge_lines``'s torus
rolls of tile edges, made contiguous) that the edge-line kernel takes as
operands."""
from perfbench import spans


def read(w):
    s = spans.launched_seconds(w, ("repro_torch.kernels.lines",))
    if s is None or not w.sweeps:
        return None
    return 1e3 * s / w.sweeps
