"""The measurement kernel: one sweep's exact spin and bond sums of blocked
quads, in one pass. CUDA wrapper and plain version.

:func:`blocked_totals` reads blocked compact quads ``qb[4, mr, mc, bs, bs]``
(A, B, C, D; bf16 or f32 spins +-1) and returns an int64 tensor
``[m_sum, e_sum]``: the sum of every spin, and the sum over the white
quads of ``sigma * nn`` with ``core.checkerboard.nn_white``'s neighbour
sets on the torus (each bond once). Source: ``csrc/blocked_totals.cu``. It
replaces no TPU kernel: the reference leaves ``blocked_stats`` to XLA
(``src/repro/core/measure.py``). It is bound by memory: it reads each spin
once, 2 bytes a lattice site in bf16 (13.42 GB at 81920^2, 4.01 ms at the
H100's 3.35 TB/s).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor, and only there, it runs :func:`blocked_totals_plain`, which repeats
the kernel's integer arithmetic in int64: sigma = 1 - 2 s for a spin's sign
bit s, so ``sigma_x sigma_y = 1 - 2 (s_x ^ s_y)``, and the sums are
``4 n - 2 (negative spins)`` and ``8 n - 2 (unsatisfied bonds)`` over the
``n`` sites of a quad. Each launch is counted in
``build.launches["blocked_totals"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import lattice as L
from repro_torch.kernels import build

# the quads' and the output's pointers, mr, mc, bs and dtype
_P, _I = ctypes.c_void_p, ctypes.c_int
_TOTALS = build.Entry("blocked_totals", "blocked_totals",
                      "ising_blocked_totals", (_P, _P, _I, _I, _I, _I))


def _check(qb: torch.Tensor) -> None:
    if qb.dim() != 5 or qb.shape[0] != 4 or qb.shape[3] != qb.shape[4]:
        raise ValueError(f"quads must be [4, mr, mc, bs, bs], got "
                         f"{tuple(qb.shape)}")
    if qb.dtype not in build.DTYPE_CODE:
        raise TypeError(f"quads must be float32 or bfloat16, got {qb.dtype}")


def blocked_totals_plain(qb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: int64 ``[m_sum, e_sum]``."""
    a, b, c, d = (L.unblock(torch.signbit(qb[i])).to(torch.int64)
                  for i in range(4))
    # the eight bonds of a site (i, j), as the kernel takes them: the row
    # above and the column to the right on the torus
    a_right, c_right = (torch.roll(x, -1, 1) for x in (a, c))
    c_up, d_up = (torch.roll(x, 1, 0) for x in (c, d))
    unsat = ((a ^ b) + (a ^ c) + (d ^ b) + (d ^ c) + (b ^ a_right)
             + (b ^ d_up) + (d ^ c_right) + (a ^ c_up)).sum()
    neg = (a + b + c + d).sum()
    n = a.numel()
    return torch.stack([4 * n - 2 * neg, 8 * n - 2 * unsat])


def blocked_totals(qb: torch.Tensor) -> torch.Tensor:
    """int64 ``[m_sum, e_sum]`` of blocked quads, on ``qb``'s device."""
    _check(qb)
    if not build.on_cuda(_TOTALS, qb.device, qb):
        return blocked_totals_plain(qb)
    _, mr, mc, bs, _ = qb.shape
    out = torch.empty(2, dtype=torch.int64, device=qb.device)
    build.launch(_TOTALS, qb.device, qb, out, mr, mc, bs,
                 build.DTYPE_CODE[qb.dtype])
    return out
