"""Device milliseconds a sweep of cluster labelling: the operations
launched inside the program's ``repro_torch.cluster.label`` span, every
label iteration with its changed flag."""
from perfbench import spans


def read(w):
    s = spans.launched_seconds(w, ("repro_torch.cluster.label",))
    if s is None or not w.sweeps:
        return None
    return 1e3 * s / w.sweeps
