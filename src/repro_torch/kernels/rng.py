"""The device form of ``random.fold_in_bits``: one threefry pass over a
tensor of counters. CUDA wrapper.

:func:`fold_in_bits` takes int32 counters on a CUDA device and returns, for
every element ``c``, the int32 bit pattern of ``fold_in(key, c)[-1]``: x1 of
threefry2x32 of the counter pair ``(0, c)``. Under a key batch the counters
are ``[R, ...]`` and row i is hashed under key i; rows that every key
shares (``random.shared``, stride 0) are read in place. Source:
``csrc/threefry_fold.cu``. It replaces no TPU kernel: the reference leaves
the hash to XLA.

``random.fold_in_bits`` launches it for every counter tensor on a CUDA
device (integer counters of another dtype cast to int32 first). On CPU
counters the wrapper runs the eager int64 form,
``random._fold_in_bits_eager``, the oracle the tests hold the kernel to.
Each launch is counted in ``build.launches["fold_in_bits"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import random as jr
from repro_torch.kernels import build

# the counters' and the output's pointers, n, the row stride, rows, one
# key's two words, and the pointer of a key batch's [R, 2] words (or null)
_P, _I64, _U32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32
_FOLD = build.Entry("fold_in_bits", "threefry_fold", "ising_fold_in_bits",
                    (_P, _P, _I64, _I64, ctypes.c_int, _U32, _U32, _P))


def _key_pairs(keys, device) -> torch.Tensor:
    """[R, 2] int32 bit patterns of a key batch's words on ``device``,
    copied from pinned memory without a host sync."""
    words = [w - ((w >> 31) << 32) for k in keys for w in jr.key_data(k)]
    t = torch.tensor(words, dtype=torch.int32).view(len(keys), 2)
    return t.pin_memory().to(device, non_blocking=True)


def fold_in_bits(key, counters: torch.Tensor) -> torch.Tensor:
    """``fold_in(key, c)[-1]`` for every element of int32 ``counters``
    (int32 bit patterns, the same shape); under a key batch ``counters`` is
    ``[R, ...]``, row i hashed under key i."""
    if counters.dtype != torch.int32:
        raise TypeError(f"the kernel takes int32 counters, got "
                        f"{counters.dtype}")
    if not build.on_cuda(_FOLD, counters.device):
        return jr._fold_in_bits_eager(key, counters)
    batch = jr.is_batch(key)
    flat = counters.reshape(jr._lead(key) + (-1,))
    n = flat.shape[-1]
    if n > 1 and flat.stride(-1) != 1:
        flat = flat.contiguous()
    rows = len(key) if batch else 1
    out = torch.empty((rows, n), dtype=torch.int32, device=counters.device)
    if out.numel() == 0:
        return out.view(counters.shape)
    if batch:
        k0 = k1 = 0
        keys, row_stride = _key_pairs(key, counters.device), flat.stride(0)
    else:
        k0, k1 = jr.key_data(key)
        keys, row_stride = None, n
    build.launch(_FOLD, counters.device, flat, out, n, row_stride, rows, k0,
                 k1, keys)
    return out.view(counters.shape)
