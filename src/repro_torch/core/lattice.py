"""Lattice representations for the 2-D Ising model.

Three layouts are used throughout the port, as in the JAX package:

* ``full``   — ``[H, W]`` tensor of spins in {-1, +1} (torus boundary).
* ``quads``  — ``[4, H/2, W/2]`` compact parity sub-lattices:
               index 0 = sigma_00 (even row, even col)   "A"  (black)
               index 1 = sigma_01 (even row, odd  col)   "B"  (white)
               index 2 = sigma_10 (odd  row, even col)   "C"  (white)
               index 3 = sigma_11 (odd  row, odd  col)   "D"  (black)
* ``blocked``— ``[mr, mc, b, b]`` grid of b x b tiles of a 2-D tensor.

Every conversion also takes leading replica axes (``[R, H, W]`` <->
``[R, 4, H/2, W/2]``, ``[R, mr, mc, b, b]``). All are exact and round-trip. ``block`` and ``unblock`` return
views where PyTorch can; call ``.contiguous()`` where a kernel needs one.
"""
from __future__ import annotations

import torch

from repro_torch import random as jr

# Quad indices (paper notation sigma_{rc} = sigma[r::2, c::2]).
Q00, Q01, Q10, Q11 = 0, 1, 2, 3
BLACK_QUADS = (Q00, Q11)
WHITE_QUADS = (Q01, Q10)

MXU_BLOCK = 128

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(dtype) -> torch.dtype:
    """A dtype given by name ("bfloat16", "float32", ...) or as itself."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}; known: "
                         f"{sorted(_DTYPES)}") from None


def random_lattice(key, height: int, width: int, dtype=torch.bfloat16,
                   device="cpu") -> torch.Tensor:
    """Uniform random +-1 spin configuration, shape [height, width]."""
    up = jr.bernoulli(key, 0.5, (height, width), device)
    one = torch.ones((), dtype=torch_dtype(dtype), device=device)
    return torch.where(up, one, -one)


def cold_lattice(height: int, width: int, dtype=torch.bfloat16,
                 device="cpu") -> torch.Tensor:
    """All-up configuration (ground state)."""
    return torch.ones((height, width), dtype=torch_dtype(dtype), device=device)


def to_quads(full: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., 4, H/2, W/2] compact parity decomposition."""
    h, w = full.shape[-2:]
    if h % 2 or w % 2:
        raise ValueError(f"lattice dims must be even, got {tuple(full.shape)}")
    return torch.stack([full[..., 0::2, 0::2], full[..., 0::2, 1::2],
                        full[..., 1::2, 0::2], full[..., 1::2, 1::2]], -3)


def from_quads(quads: torch.Tensor) -> torch.Tensor:
    """[..., 4, R, C] -> [..., 2R, 2C]; inverse of :func:`to_quads`."""
    r, c = quads.shape[-2:]
    q = quads.unbind(-3)
    full = quads.new_zeros(quads.shape[:-3] + (2 * r, 2 * c))
    full[..., 0::2, 0::2] = q[Q00]
    full[..., 0::2, 1::2] = q[Q01]
    full[..., 1::2, 0::2] = q[Q10]
    full[..., 1::2, 1::2] = q[Q11]
    return full


def block(x: torch.Tensor, bs: int = MXU_BLOCK) -> torch.Tensor:
    """[..., R, C] -> [..., R/bs, C/bs, bs, bs] tile grid."""
    r, c = x.shape[-2:]
    if r % bs or c % bs:
        raise ValueError(f"{tuple(x.shape)} not divisible by block {bs}")
    return x.reshape(x.shape[:-2] + (r // bs, bs, c // bs, bs)).transpose(
        -3, -2)


def unblock(xb: torch.Tensor) -> torch.Tensor:
    """[..., mr, mc, bs, bs] -> [..., mr*bs, mc*bs]; inverse of
    :func:`block`."""
    mr, mc, bs, _ = xb.shape[-4:]
    return xb.transpose(-3, -2).reshape(xb.shape[:-4] + (mr * bs, mc * bs))


def kernel_naive(n: int, dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    """Paper's K: tridiagonal, zero diagonal, ones on sub/super diagonals."""
    i = torch.arange(n, device=device)
    return ((i[:, None] - i[None, :]).abs() == 1).to(torch_dtype(dtype))


def kernel_compact(n: int, dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    """Paper's K-hat: upper bidiagonal (ones on diag and superdiag)."""
    i = torch.arange(n, device=device)
    d = i[None, :] - i[:, None]
    return ((d == 0) | (d == 1)).to(torch_dtype(dtype))


def color_mask(n: int, color: int, dtype=torch.bfloat16,
               device="cpu") -> torch.Tensor:
    """Paper's M: checkerboard mask; color 0 selects (i+j) even sites."""
    i = torch.arange(n, device=device)
    m = (i[:, None] + i[None, :]) % 2 == color
    return m if dtype is torch.bool else m.to(torch_dtype(dtype))
