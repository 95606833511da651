"""XLA:CPU's f32 ``exp``, ``sigmoid`` and ``log``, bit for bit, in tensor ops.

The JAX package builds its f32 probability tables with ``jnp.exp`` and
``jax.nn.sigmoid`` and decides tempering swaps with ``jnp.log``. On the
CPU, XLA compiles these to Cephes-style polynomials whose multiply-adds
LLVM fuses; ``torch.exp``, ``torch.sigmoid`` and ``torch.log`` round
differently in the last place at many inputs. This module reproduces
XLA's forms from IEEE operations only, so the result is the same on every
device (no device libm is called):

* :func:`exp_f32`: the input is clamped to [-88.3762626647949,
  ln(FLT_MAX)]; range reduction ``fx = min(floor(fma(x, log2 e, 1/2)),
  127)``, ``r = fma(fx, -0.693359375, x)``, ``r = fma(fx, 2.12194440e-4,
  r)``; a degree-5 Horner polynomial by ``fma``, ``y = fma(y, r*r, r) +
  1``, scaled by ``2**fx`` built from exponent bits;
* :func:`sigmoid_f32` ``= 1 / (1 + exp_f32(-x))``;
* :func:`log_f32`: mantissa/exponent split around sqrt(1/2) and a
  nine-term polynomial in three interleaved ``fma`` chains.

Each ``fma`` is an f64 multiply-add rounded once to f32: the product of
two f32 values is exact in f64. XLA:CPU runs with denormals flushed, so
subnormal inputs read as 0 and subnormal results become 0.

A table of a compile-time constant is not computed by that kernel: when a
reference loop bakes a Python-number beta into a table whose inputs are
all literals, XLA folds the ``exp`` at compile time in f64 and rounds
once. :func:`exp_f32_folded_np` is that form (host only); the callers say
which of the two their reference runs.

The ``*_np`` twins take and return numpy arrays, for tables built on the
host.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_EXP_LO = -88.3762626647949
_EXP_HI = 88.72283935546875        # ln(FLT_MAX) in f32
_LOG2E = 1.44269504088896341
_C1 = -0.693359375
_C2 = 2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_FLT_MIN = 1.17549435e-38

_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375
_SQRTHF = 0.707106781186547524


def _fma(a, b, c) -> torch.Tensor:
    """f32 fused multiply-add: exact f64 product, one rounding to f32."""
    return (torch.as_tensor(a, dtype=torch.float64)
            * torch.as_tensor(b, dtype=torch.float64)
            + torch.as_tensor(c, dtype=torch.float64)).float()


def _f32(x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormals to (signed) zero, as under FTZ/DAZ."""
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's compiled f32 ``exp`` of an f32 tensor."""
    x = _flush(_f32(x)).clamp(_EXP_LO, _EXP_HI)
    fx = torch.floor(_fma(x, np.float32(_LOG2E), 0.5)).clamp(max=127.0)
    r = _fma(fx, np.float32(_C1), x)
    r = _fma(fx, np.float32(_C2), r)
    y = torch.full_like(r, float(np.float32(_EXP_P[0])))
    for p in _EXP_P[1:]:
        y = _fma(y, r, float(np.float32(p)))
    y = _fma(y, r * r, r) + 1.0
    # 2**fx from exponent bits (fx = -127 gives +0)
    scale = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return _flush(y * scale)


def sigmoid_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA:CPU computes it: 1 / (1 + exp(-x))."""
    return _flush(1.0 / (1.0 + exp_f32(-_flush(_f32(x)))))


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's compiled f32 ``log`` (0 -> -inf, x < 0 -> nan)."""
    x0 = _flush(_f32(x))
    x = torch.clamp(x0, min=_FLT_MIN)
    bits = x.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 0x7F).float()
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _SQRTHF
    e = e - small.float()
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    m2 = m * m
    m3 = m2 * m
    p = [float(np.float32(c)) for c in _LOG_P]
    y = _fma(m, p[0], p[1])
    y1 = _fma(m, p[3], p[4])
    y2 = _fma(m, p[6], p[7])
    y = _fma(y, m, p[2])
    y1 = _fma(y1, m, p[5])
    y2 = _fma(y2, m, p[8])
    y = _fma(y, m3, y1)
    y = _fma(y, m3, y2)
    y = _fma(y, m3, np.float32(_LOG_Q1) * e)
    out = (m - 0.5 * m2 + y) + float(np.float32(_LOG_Q2)) * e
    out = torch.where(x0 == 0, torch.full_like(out, -math.inf), out)
    out = torch.where(x0 < 0, torch.full_like(out, math.nan), out)
    return torch.where(x0 == math.inf, x0, out)


def _np_twin(fn):
    def twin(x):
        t = torch.from_numpy(np.array(x, dtype=np.float32, ndmin=1))
        out = fn(t).numpy()
        return out.reshape(np.shape(x))
    twin.__name__ = fn.__name__ + "_np"
    twin.__doc__ = f"Host twin of :func:`{fn.__name__}` (numpy f32 in/out)."
    return twin


exp_f32_np = _np_twin(exp_f32)
sigmoid_f32_np = _np_twin(sigmoid_f32)
log_f32_np = _np_twin(log_f32)


def exp_f32_folded_np(x) -> np.ndarray:
    """``exp`` as XLA's constant folder evaluates f32 literals: in f64,
    rounded once to f32 (numpy f32 in/out)."""
    return np.exp(np.asarray(x, np.float32).astype(np.float64)).astype(
        np.float32)
