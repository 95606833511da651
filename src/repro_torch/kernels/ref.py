"""Plain PyTorch oracle with the kernels' bit-level semantics.

The port of ``repro.kernels.ref``: the K-hat neighbour sums of
:mod:`repro_torch.core.checkerboard` (themselves held against the
full-lattice oracle), then the registry's ``kernel_form`` flip: f32 nn,
f32 table, f32 compare of ``(bits >> 8) * 2**-24``. The CUDA kernels of
:mod:`repro_torch.kernels.checkerboard` are held against it.
"""
from __future__ import annotations

import torch

from repro_torch.core import checkerboard as cb
from repro_torch.core import update_rules


def update_color_ref(quads_blocked, bits, kh, beta: float, color: int,
                     rule: str = "metropolis_lut") -> torch.Tensor:
    """One colour's half-sweep of blocked quads [4, mr, mc, bs, bs] from
    bits [2, mr, mc, bs, bs]; returns a new stack."""
    a, b, c, d = (quads_blocked[i] for i in range(4))
    if color == 0:
        nn0, nn1 = cb.nn_black(a, b, c, d, kh)
        s0, s1 = a, d
    else:
        nn0, nn1 = cb.nn_white(a, b, c, d, kh)
        s0, s1 = b, c
    flip = update_rules.get_rule(rule).kernel_form(float(beta))
    new0 = flip(s0, nn0.float(), bits[0])
    new1 = flip(s1, nn1.float(), bits[1])
    if color == 0:
        return torch.stack([new0, b, c, new1])
    return torch.stack([a, new0, new1, d])
