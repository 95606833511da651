"""Plain checkerboard Metropolis on boxes of the full lattice.

The stated rule of the ``metropolis_lut`` configurations: a sweep updates
the sites with (i + j) even (black), then those with (i + j) odd (white).
A site with spin s and neighbour sum nn flips when x = s * nn <= 0, and
otherwise when u < t(x), where u = (bits >> 8) * 2**-24 and t(x) is
exp(-2 beta x) computed in float64 and rounded once to float32. The bits
of a site are the threefry draw (``threefry.counter_bits``) under the
colour key ``fold_in(fold_in(chunk_key, step), colour)`` of the site's
flat index in the colour's blocked planes ``[2, mr, mc, bs, bs]``: plane
i & 1, tile (qr // bs, qc // bs), offset (qr % bs, qc % bs) for the
compact coordinates (qr, qc) = (i >> 1, j >> 1), mr = mc = L / 2 / bs.

An output site after k sweeps depends only on the input within Manhattan
distance 2k, so a box of the input ``2k`` wider on each side gives its
core exactly: every half-sweep updates the box's interior and drops its
border. Boxes carry their global origin (row, column of their top-left
site), so the colours and the counters are those of the whole torus.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import threefry

U24 = 1 << 24
PRECISIONS = ("float32", "bfloat16")


def table(beta: float, precision: str = "float32") -> dict:
    """t(x) for the two positive x (x <= 0 always flips): float32 as the
    configuration states it; ``bfloat16`` rounds it on to bfloat16."""
    t = {x: float(np.float32(math.exp(-2.0 * float(beta) * x)))
         for x in (2, 4)}
    if precision == "bfloat16":
        t = {x: float(torch.tensor(v).to(torch.bfloat16)) for x, v in t.items()}
    elif precision != "float32":
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return t


def _accept(u24: torch.Tensor, t: float, precision: str) -> torch.Tensor:
    """u < t for u = u24 * 2**-24: exact in float64 for float32 operands; in
    bfloat16 both sides are rounded to bfloat16 first."""
    u = u24.to(torch.float64) * (1.0 / U24)
    if precision == "bfloat16":
        return u.to(torch.bfloat16) < torch.tensor(t, dtype=torch.bfloat16,
                                                    device=u.device)
    return u < t


def site_counters(rows: torch.Tensor, cols: torch.Tensor, size: int,
                  bs: int) -> torch.Tensor:
    """Flat indices in the colour's ``[2, mr, mc, bs, bs]`` planes of the
    sites at global rows [P, h] x cols [P, w] (int64 [P, h, w])."""
    m = size // 2 // bs
    qr, qc = rows >> 1, cols >> 1
    tile_r = ((rows & 1) * m + qr // bs)[:, :, None]
    tile = tile_r * m + (qc // bs)[:, None, :]
    return (tile * bs + (qr % bs)[:, :, None]) * bs + (qc % bs)[:, None, :]


def half_sweep(boxes: torch.Tensor, origins: torch.Tensor, size: int,
               bs: int, colour_key, colour: int, tab: dict,
               precision: str = "float32") -> tuple:
    """One colour's update of the interior of every box; returns the
    interior ``[P, h - 2, w - 2]`` and its origins."""
    p, h, w = boxes.shape
    b = boxes.to(torch.int32)
    s = b[:, 1:-1, 1:-1]
    nn = b[:, :-2, 1:-1] + b[:, 2:, 1:-1] + b[:, 1:-1, :-2] + b[:, 1:-1, 2:]
    origins = origins + 1
    dev = boxes.device
    rows = (origins[:, :1] + torch.arange(h - 2, device=dev)) % size
    cols = (origins[:, 1:] + torch.arange(w - 2, device=dev)) % size
    active = ((rows[:, :, None] + cols[:, None, :]) & 1) == colour
    u24 = (threefry.counter_bits(colour_key,
                                 site_counters(rows, cols, size, bs))
           >> 8) & (U24 - 1)
    x = s * nn
    flip = ((x <= 0) | ((x == 2) & _accept(u24, tab[2], precision))
            | ((x == 4) & _accept(u24, tab[4], precision)))
    new = torch.where(active & flip, -s, s)
    return new.to(boxes.dtype), origins


def sweep_boxes(boxes: torch.Tensor, origins: torch.Tensor, size: int,
                bs: int, chunk_key, n_sweeps: int, beta: float,
                precision: str = "float32") -> torch.Tensor:
    """``n_sweeps`` sweeps keyed as one chunk under ``chunk_key`` (steps 0
    to n - 1); returns the cores, ``2 * n_sweeps`` smaller on each side."""
    tab = table(beta, precision)
    for step in range(n_sweeps):
        sweep_key = threefry.fold_in(chunk_key, step)
        for colour in (0, 1):
            boxes, origins = half_sweep(
                boxes, origins, size, bs, threefry.fold_in(sweep_key, colour),
                colour, tab, precision)
    return boxes
