"""Label-propagation iterations a sweep, from the program's own counter
(``repro_torch.cluster.label.counters["iterations"]``, one changed-flag
host sync each)."""


def read(w):
    iters = w.counters.get("label_iterations")
    if not iters or not w.sweeps:
        return None
    return iters / w.sweeps
