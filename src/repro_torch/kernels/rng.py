"""The device forms of ``random``'s threefry hashes. CUDA wrappers.

:func:`fold_in_bits` takes int32 counters on a CUDA device and returns, for
every element ``c``, the int32 bit pattern of ``fold_in(key, c)[-1]``: x1 of
threefry2x32 of the counter pair ``(0, c)``. Under a key batch the counters
are ``[R, ...]`` and row i is hashed under key i; rows that every key
shares (``random.shared``, stride 0) are read in place. Source:
``csrc/threefry_fold.cu``. ``random.fold_in_bits`` launches it for every
counter tensor on a CUDA device (integer counters of another dtype cast to
int32 first). On CPU counters the wrapper runs the eager int64 form,
``random._fold_in_bits_eager``. Each launch is counted in
``build.launches["fold_in_bits"]``.

:func:`draw` is one draw of ``random.bits`` (int32), ``random.uniform``
(f32, bf16, f16; ``random.bernoulli`` compares the f32 one) or
``random.randint``: element e of row r (key r of a batch) from the
counter ``e``, hashed and converted to the draw's dtype in one launch.
Source: ``csrc/threefry_draw.cu``. ``random``'s draws launch it on a CUDA
device, inside their ``repro_torch.random.draws`` span and counted in their
``draw_words`` as before; ``random.kernel_bits`` takes it too, with
neither. On the CPU the wrapper runs the eager int64 form,
``random._draw_eager``. Each launch is counted in
``build.launches["threefry_draw"]``.

Neither replaces a TPU kernel: the reference leaves the hash to XLA. The
eager forms are the oracles the tests hold the kernels to.
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
# the output's pointer, the first counter, n, rows, a key set (one key's two
# words and a key batch's pointer, or null) and randint's second, its span,
# multiplier and minval, then the output form's code
_DRAW = build.Entry("threefry_draw", "threefry_draw", "ising_threefry_draw",
                    (_P, ctypes.c_uint64, _I64, ctypes.c_int, _U32, _U32, _P,
                     _U32, _U32, _P, _U32, _U32, _U32, ctypes.c_int))
# the form's code by the draw's dtype (randint: 4)
_FORMS = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2,
          torch.float16: 3}
_RANDINT = 4


def _key_pairs(keys, device) -> torch.Tensor:
    """[R, 2] int32 bit patterns of a key batch's words on ``device``,
    copied from pinned memory without a host sync."""
    words = [w - ((w >> 31) << 32) for k in keys for w in jr.key_data(k)]
    t = torch.tensor(words, dtype=torch.int32).view(len(keys), 2)
    return t.pin_memory().to(device, non_blocking=True)


def _key_set(key, device) -> tuple:
    """The kernel's arguments for a key or a key batch: two words by value
    and null, or zeros and the batch's [R, 2] words on ``device``."""
    if jr.is_batch(key):
        return 0, 0, _key_pairs(key, device)
    return (*jr.key_data(key), None)


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
    build.launch(_FOLD, counters.device, flat, out, n,
                 flat.stride(0) if batch else n, rows,
                 *_key_set(key, counters.device))
    return out.view(counters.shape)


def draw(key, shape, dtype=torch.int32, device="cpu", bounds=None,
         start: int = 0) -> torch.Tensor:
    """``random.bits`` (``dtype`` int32), ``random.uniform`` (a float
    ``dtype``) or, with ``bounds = (minval, maxval)``, ``random.randint`` of
    ``key`` over ``shape`` on ``device`` (``[R, *shape]`` under a key
    batch), element e drawn from counter ``start + e``."""
    shape = tuple(int(s) for s in shape)
    if bounds is None and dtype not in _FORMS:
        raise ValueError(f"the draw kernel writes {sorted(map(str, _FORMS))}"
                         f", got {dtype}")
    if bounds is not None and dtype != torch.int32:
        raise ValueError(f"randint draws int32, got {dtype}")
    if not build.on_cuda(_DRAW, device):
        return jr._draw_eager(key, shape, dtype, device, bounds, start)
    out = torch.empty(jr._lead(key) + shape, dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    rows = jr._rows(key)
    if bounds is None:
        first = _key_set(key, device)
        second, fold, form = (0, 0, None), (0, 0, 0), _FORMS[dtype]
    else:   # hi from split key 0, lo from split key 1
        k1, k2, span, multiplier = jr._randint_form(key, *bounds)
        first, second = _key_set(k1, device), _key_set(k2, device)
        fold, form = (span, multiplier, int(bounds[0]) & jr._M32), _RANDINT
    build.launch(_DRAW, device, out, start, out.numel() // rows, rows,
                 *first, *second, *fold, form)
    return out
