"""Plain checkerboard Metropolis of the paper pipeline, on boxes of the
full lattice.

The stated rule of the ``ising-160x128-xla`` configuration (the paper's
Algorithm 2 with bfloat16 probabilities): a sweep updates the sites with
(i + j) even (black), then those with (i + j) odd (white). A site with
spin s and neighbour sum nn flips when x = s * nn <= 0, and otherwise
when u < t(x), both in bfloat16:

* u = ((bits & 0xFF) >> 1) * 2**-7: the draw's low 8 bits, of which the
  top 7 are the mantissa of a bfloat16 in [1, 2), less 1 (exact);
* t(x) = bf16(f32(exp(-2 x f32(beta)))): the product in float32 (exact,
  x is 2 or 4), ``exp`` in float64 rounded once to float32, then rounded
  to bfloat16 (the acceptance in the lattice's dtype).

The bits of a site are the threefry draw (``threefry.counter_bits``) under
the colour key of the site's flat index in the colour's blocked planes
``[2, mr, mc, bs, bs]`` (:func:`perfbench.reference.metropolis.
site_counters`); the colour key is ``fold_in(fold_in(rank key, step),
colour)`` with the rank key ``fold_in(chunk key, 0)``, rank 0 of a 1 x 1
grid.

At a lower ``precision`` (the control) the uniforms are drawn as that
dtype lays them out and t(x) is rounded on to it.

Neighbour sums are shifted slices of each box, in int32: no matmul, so
TF32 never enters, and the only floating-point step is the compare, in
float64 on values exact in the precision asked for. As in
:mod:`perfbench.reference.metropolis`, a box ``2k`` wider on each side
than its core gives the core after k sweeps exactly.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import threefry
from perfbench.reference.metropolis import site_counters

STATED = "bfloat16"
RANK = 0        # the linear grid index of the one rank


def rounded(x, precision: str):
    """``x`` (a float64 tensor or a float) rounded to ``precision`` (a
    torch dtype name), back in float64."""
    dtype = getattr(torch, precision)
    if isinstance(x, torch.Tensor):
        return x.to(dtype).to(torch.float64)
    return float(torch.tensor(x, dtype=torch.float64).to(dtype)
                 .to(torch.float64))


def table(beta: float, precision: str = STATED) -> dict:
    """t(x) for the two positive x (x <= 0 always flips), in the stated
    bfloat16, or rounded on to ``precision`` (the control)."""
    b32 = float(np.float32(beta))
    t = {x: float(torch.tensor(np.float32(math.exp(-2.0 * x * b32)))
                  .to(torch.bfloat16)) for x in (2, 4)}
    return {x: rounded(v, precision) for x, v in t.items()}


def uniforms(bits: torch.Tensor, precision: str = STATED) -> torch.Tensor:
    """The uniforms of 32-bit draws (int64 in [0, 2**32)) as float64, laid
    out as a draw in ``precision`` lays them out: of the low 8 bits, the
    top ``nmant`` (7 in bfloat16, 3 in float8_e4m3fn) are the mantissa of
    a number in [1, 2), less 1."""
    nmant = round(-math.log2(torch.finfo(getattr(torch, precision)).eps))
    if nmant > 7:
        raise ValueError(f"{precision} has {nmant} mantissa bits; the "
                         "stated draw has 8 random bits")
    return ((bits & 0xFF) >> (8 - nmant)).to(torch.float64) * 2.0 ** -nmant


def half_sweep(boxes: torch.Tensor, origins: torch.Tensor, size: int,
               bs: int, colour_key, colour: int, tab: dict,
               precision: str = STATED) -> tuple:
    """One colour's update of the interior of every box; returns the
    interior ``[P, h - 2, w - 2]`` and its origins."""
    _, h, w = boxes.shape
    b = boxes.to(torch.int32)
    s = b[:, 1:-1, 1:-1]
    nn = b[:, :-2, 1:-1] + b[:, 2:, 1:-1] + b[:, 1:-1, :-2] + b[:, 1:-1, 2:]
    origins = origins + 1
    dev = boxes.device
    rows = (origins[:, :1] + torch.arange(h - 2, device=dev)) % size
    cols = (origins[:, 1:] + torch.arange(w - 2, device=dev)) % size
    active = ((rows[:, :, None] + cols[:, None, :]) & 1) == colour
    u = uniforms(threefry.counter_bits(colour_key,
                                       site_counters(rows, cols, size, bs)),
                 precision)
    x = s * nn
    flip = (x <= 0) | ((x == 2) & (u < tab[2])) | ((x == 4) & (u < tab[4]))
    new = torch.where(active & flip, -s, s)
    return new.to(boxes.dtype), origins


def sweep_boxes(boxes: torch.Tensor, origins: torch.Tensor, size: int,
                bs: int, chunk_key, n_sweeps: int, beta: float,
                precision: str = STATED) -> torch.Tensor:
    """``n_sweeps`` sweeps keyed as one chunk under ``chunk_key`` (steps 0
    to n - 1); returns the cores, ``2 * n_sweeps`` smaller on each side."""
    tab = table(beta, precision)
    rank_key = threefry.fold_in(chunk_key, RANK)
    for step in range(n_sweeps):
        sweep_key = threefry.fold_in(rank_key, step)
        for colour in (0, 1):
            boxes, origins = half_sweep(
                boxes, origins, size, bs, threefry.fold_in(sweep_key, colour),
                colour, tab, precision)
    return boxes
