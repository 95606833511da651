"""The site update's share of its roofline: the least time the window's
site updates need (:func:`flip_bound_s`) over the device time launched
inside the program's ``repro_torch.checkerboard.flip`` span.

The bound is counted from the function, not from any implementation: each
site of a sweep reads its spin and its neighbour sum at the spins' width
(the configuration's ``dtype``) and its uniform at ``prob_dtype``'s width,
and writes its spin once, over the HBM rate of :mod:`perfbench.work`. Its
arithmetic (a product, an index, a select, a compare) is far below the
issue rate, so the bytes are the bound: 8 bytes a site with bf16 spins and
uniforms."""
from perfbench import spans, work

FLIP = "repro_torch.checkerboard.flip"
WIDTH = {"float32": 4, "bfloat16": 2, "float16": 2}


def flip_bound_s(sites: int, spin_bytes: int, prob_bytes: int) -> float:
    return sites * (3 * spin_bytes + prob_bytes) / work.HBM_BYTES_PER_S


def read(w):
    s = spans.launched_seconds(w, (FLIP,))
    if not s or not w.sweeps:
        return None
    bound = flip_bound_s(w.sites * w.sweeps,
                         WIDTH[w.config.get("dtype", "bfloat16")],
                         WIDTH[w.config.get("prob_dtype", "float32")])
    return 100.0 * bound / s
