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
device (integer counters of another dtype cast to int32 first); on the CPU
it runs its eager int64 form, the oracle the tests hold the kernel to. The wrapper counts its launches in ``launches["fold_in_bits"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import random as jr
from repro_torch.kernels import build
from repro_torch.kernels.checkerboard import _ptr, _stream

launches = {"fold_in_bits": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _entry():
    fn = build.load("threefry_fold").ising_fold_in_bits
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _key_pairs(keys, device) -> torch.Tensor:
    """[R, 2] int32 bit patterns of a key batch's words on ``device``,
    copied from pinned memory without a host sync."""
    words = [w - ((w >> 31) << 32) for k in keys for w in jr.key_data(k)]
    t = torch.tensor(words, dtype=torch.int32).view(len(keys), 2)
    return t.pin_memory().to(device, non_blocking=True)


def fold_in_bits(key, counters: torch.Tensor) -> torch.Tensor:
    """``fold_in(key, c)[-1]`` for every element of int32 ``counters`` on a
    CUDA device (int32 bit patterns, the same shape); under a key batch
    ``counters`` is ``[R, ...]``, row i hashed under key i."""
    if counters.device.type != "cuda" or counters.dtype != torch.int32:
        raise ValueError(f"the kernel takes int32 counters on a CUDA device, "
                         f"got {counters.dtype} on {counters.device}")
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
        pairs = _key_pairs(key, counters.device)
        keys, row_stride = _ptr(pairs), flat.stride(0)
    else:
        k0, k1 = jr.key_data(key)
        keys, row_stride = None, n
    with torch.cuda.device(counters.device):
        err = _entry()(_ptr(flat), _ptr(out), n, row_stride, rows, k0, k1,
                       keys, _stream(counters.device))
    if err:
        raise RuntimeError(f"ising_fold_in_bits launch failed: "
                           f"cudaError {err}")
    launches["fold_in_bits"] += 1
    return out.view(counters.shape)
