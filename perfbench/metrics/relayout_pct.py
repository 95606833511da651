"""The share of the traced window that the device spends on the kernel
path's relayout: the operations launched inside the program's
``repro_torch.kernels.block`` and ``repro_torch.kernels.unblock`` spans,
the copies of the lattice into the kernels' blocked layout and back."""
from perfbench import spans


def read(w):
    s = spans.launched_seconds(w, ("repro_torch.kernels.block",
                                   "repro_torch.kernels.unblock"))
    if s is None:
        return None
    return 100.0 * s / (w.t1 - w.t0)
