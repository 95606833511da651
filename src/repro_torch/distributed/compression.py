"""Gradient compression for cross-pod reduction (int8 + per-row scales): the
port of ``repro.distributed.compression``.

On a multi-pod grid the pod-to-pod links are the scarcest bandwidth:
quantize the gradient to int8 with per-row scales (4.4x fewer bytes than
f32), all-reduce the payload over the ``pod`` axis only, and dequantize.
Error is bounded by scale/254 per element and unbiased under stochastic
rounding (optional; the noise is the port's threefry ``uniform``, bitwise
JAX's).

The numbers are the reference's as XLA compiles it: the scale is
``max|row|`` times the f32 reciprocal of 127 (XLA rewrites the division by
the constant), every other division is a true one, and ``torch.round``
rounds half to even as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

from repro_torch import random as jr
from repro_torch import tree

_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def _scale(flat: torch.Tensor) -> torch.Tensor:
    scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) * _INV_127
    return torch.clamp_min(scale, 1e-12)


def _scale_shape(x: torch.Tensor) -> tuple:
    return (x.shape[0],) + (1,) * (x.dim() - 1) if x.dim() > 1 else (1,)


def quantize(x: torch.Tensor, stochastic_key=None):
    """-> (int8 payload, f32 per-row scales). Rows = leading dim."""
    flat = x.float().reshape(x.shape[0] if x.dim() > 1 else 1, -1)
    scale = _scale(flat)
    y = flat / scale
    if stochastic_key is not None:
        y = y + (jr.uniform(stochastic_key, y.shape, device=y.device) - 0.5)
    q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale.reshape(_scale_shape(x))


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_tree(grads, stochastic_key=None):
    """(payload, scale) per leaf; with a key, leaf i draws its noise under
    ``split(key, n_leaves)[i]`` in leaf order."""
    leaves = tree.leaves(grads)
    keys = (iter(jr.split(stochastic_key, len(leaves)))
            if stochastic_key is not None else None)
    return tree.unflatten(grads, [
        quantize(g, None if keys is None else next(keys)) for g in leaves])


def decompress_tree(ctree, dtype=torch.float32):
    if isinstance(ctree, dict):
        return {k: decompress_tree(v, dtype) for k, v in ctree.items()}
    if isinstance(ctree, list):
        return [decompress_tree(v, dtype) for v in ctree]
    return dequantize(*ctree, dtype)


def psum_compressed(grads, grid, axes):
    """All-reduce a gradient tree over the ring of ``axes`` in int8 units.

    Each rank takes its per-row scales, the common scale is their maximum
    over the ring (``pmax``), the gradient is requantized against it, and
    the int32 payloads are summed (int8 sums can overflow), then
    dequantized in the gradient's dtype."""
    def one(g):
        gf = g.float()
        s_max = grid.pmax(_scale(gf.reshape(g.shape[0] if g.dim() > 1
                                            else 1, -1))
                          .reshape(_scale_shape(g)), axes)
        q = torch.clamp(torch.round(gf / s_max), -127, 127).to(torch.int32)
        total = grid.psum(q, axes)
        return (total.float() * s_max).to(g.dtype)
    return tree.map(one, grads)
