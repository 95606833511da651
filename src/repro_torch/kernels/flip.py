"""The Metropolis site update of the paper pipeline in one pass. CUDA
wrapper and plain version.

:func:`flip_lut` takes spins ``sigma``, their neighbour sums ``nn`` (both
f32 or bf16, one dtype) and uniforms ``probs`` (f32, bf16 or f16) of one
shape, and returns ``where(probs < table[(nn sigma + 4) / 2], -sigma,
sigma)`` with the uniforms cast to the spins' dtype and compared there:
the float-uniform form of ``update_rules``' ``metropolis_lut``, bitwise.
``table`` is the five values :func:`lut_table` gives for a beta and the
spins' dtype; they go to the kernel by value. With ``out`` the result is
written there (``out`` may be ``sigma`` itself) and ``out`` is returned.
Source: ``csrc/metropolis_flip.cu``. It replaces no TPU kernel: the
reference leaves the site update to XLA (``src/repro/core/checkerboard.py``
``_flip``). It is bound by memory: 8 bytes a site with bf16 spins and
uniforms.

``core.checkerboard._flip`` launches it on CUDA tensors for the LUT rule at
a Python-number beta and no field. On CPU tensors the wrapper runs
:func:`flip_lut_plain`, which repeats the kernel's arithmetic with torch
ops. Each launch is counted in ``build.launches["flip_lut"]``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import update_rules as rules
from repro_torch.kernels import build

# the spins', sums', uniforms' and output's pointers, n, the spins' and the
# uniforms' dtype codes, and the five table values
_P, _F = ctypes.c_void_p, ctypes.c_float
_FLIP = build.Entry("flip_lut", "metropolis_flip", "ising_metropolis_flip",
                    (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, _F, _F, _F, _F, _F))
# the uniforms' dtype code (the spins' is build.DTYPE_CODE)
PROB_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=64)
def lut_table(beta: float, dtype: torch.dtype) -> tuple:
    """The five acceptance values exp(-2 beta x), x = -4, -2, 0, 2, 4, of
    ``update_rules.acceptance_table`` for ``beta`` in ``dtype``, as Python
    floats (each exact in f32)."""
    return tuple(rules.acceptance_table(beta, dtype, "cpu").float().tolist())


def operands_problem(sigma, nn, probs, out=None) -> str | None:
    """Why the kernel cannot take these operands, or None when it can."""
    if sigma.dtype not in build.DTYPE_CODE or nn.dtype != sigma.dtype:
        return (f"spins and sums must be float32 or bfloat16 of one dtype, "
                f"got {sigma.dtype} and {nn.dtype}")
    if probs.dtype not in PROB_CODE:
        return (f"uniforms must be float32, bfloat16 or float16, got "
                f"{probs.dtype}")
    if not sigma.shape == nn.shape == probs.shape:
        return (f"sigma, nn and probs must share one shape, got "
                f"{tuple(sigma.shape)}, {tuple(nn.shape)} and "
                f"{tuple(probs.shape)}")
    if not sigma.device == nn.device == probs.device:
        return "sigma, nn and probs must lie on one device"
    if out is not None and (out.shape != sigma.shape
                            or out.dtype != sigma.dtype
                            or out.device != sigma.device):
        return (f"out must match sigma ({tuple(sigma.shape)} {sigma.dtype} "
                f"on {sigma.device}), got {tuple(out.shape)} {out.dtype} on "
                f"{out.device}")
    return None


def flip_lut_plain(sigma, nn, probs, table, out=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    x = nn * sigma
    k = ((x.float() + 4.0) * 0.5).to(torch.int64).clamp(0, 4)
    acc = torch.tensor(table, dtype=torch.float32,
                       device=sigma.device).to(sigma.dtype)[k]
    new = torch.where(probs.to(sigma.dtype) < acc, -sigma, sigma)
    return new if out is None else out.copy_(new)


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the bytes of ``a`` and ``b`` (contiguous) overlap."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and \
        b0 < a0 + a.numel() * a.element_size()


def flip_lut(sigma, nn, probs, table, out=None) -> torch.Tensor:
    """The Metropolis update of ``sigma``, written to ``out`` (a new tensor
    when None; ``sigma`` itself may be given) and returned."""
    problem = operands_problem(sigma, nn, probs, out)
    if problem:
        raise ValueError(problem)
    if len(table) != 5:
        raise ValueError(f"the table has five values, got {len(table)}")
    if not build.on_cuda(_FLIP, sigma.device):
        return flip_lut_plain(sigma, nn, probs, table, out)
    args = [t.contiguous() for t in (sigma, nn, probs)]
    dst = out if out is not None and out.is_contiguous() else \
        torch.empty_like(args[0])
    if any(_overlaps(dst, t) for t in args[1:]) or (
            dst.data_ptr() != args[0].data_ptr() and _overlaps(dst, args[0])):
        raise ValueError("out may be sigma itself, and may overlap no other "
                         "input")
    if dst.numel():
        build.launch(_FLIP, sigma.device, *args, dst, dst.numel(),
                     build.DTYPE_CODE[sigma.dtype], PROB_CODE[probs.dtype],
                     *table)
    if out is None or dst is out:
        return dst
    return out.copy_(dst)
