"""Counter-based threefry2x32, bitwise equal to what the JAX package draws.

The JAX reference takes every random number from ``jax.random`` with the
threefry2x32 implementation in its partitionable counter layout. This
module reproduces the parts it uses:

* keys are host-side pairs of 32-bit words ``(k0, k1)`` held as Python
  ints — ``PRNGKey``, ``fold_in`` and ``split`` run on the host, so a sweep
  loop that folds in its step never waits for the device;
* ``bits``, ``uniform``, ``bernoulli`` and ``randint`` run on the caller's
  device. Element ``n`` of a draw of shape ``S`` is ``threefry(key, (hi,
  lo))`` of its flat row-major index ``n = hi * 2**32 + lo``, and a 32-bit
  draw is ``out0 ^ out1``. On a CUDA device a draw is one kernel launch
  (:func:`repro_torch.kernels.rng.draw`, counted in
  ``kernels.build.launches["threefry_draw"]``) that hashes each element
  and writes it in the draw's dtype; on any other device it runs the eager
  form, :func:`_draw_eager`, the oracle the kernel is held to. Because
  every element is addressed by its counter, the eager form draws in
  chunks without changing a bit. Either runs inside the
  ``repro_torch.random.draws`` span, and ``counters["draw_words"]``
  counts the 32-bit words they draw (one an element, two for
  ``randint``), on any device. ``kernel_bits`` is ``bits`` with neither:
  the bits a keyed kernel hashes in the kernel, which its plain version
  draws in the kernel's place;
* ``fold_in_bits`` is ``fold_in`` over a tensor of counters: the last key
  word of ``fold_in(key, c)`` for every element ``c``. Counters on a
  CUDA device take one hand-written kernel pass
  (:func:`repro_torch.kernels.rng.fold_in_bits`, bitwise this module's
  eager form); counters anywhere else run the eager form, and
  ``counters["fold_in_bits_eager"]`` counts its passes (the kernel is
  counted in ``kernels.build.launches``);
* a *key batch* is a list of keys, one per replica. ``fold_in`` maps over
  it on the host (with one value for all keys, or a list of one value per
  key), and every device draw under it gains a leading replica
  axis whose row ``i`` is bitwise the draw under key ``i`` alone, so R
  replicas are drawn in one pass.

The eager forms' uint32 arithmetic runs in int64 lanes masked to 32 bits:
PyTorch has no ``+``, ``<<``, ``>>`` or ``<`` for ``torch.uint32`` on the
CPU. On a CUDA device no draw or ``fold_in_bits`` takes them: the kernels
hash in 32-bit registers. Raw 32-bit draws come back as ``torch.int32``
tensors holding the uint32 bit pattern, the layout the kernels read.
"""
from __future__ import annotations

import math

import torch

from repro_torch import spans

Key = tuple  # (k0, k1), two ints in [0, 2**32)

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# passes of fold_in_bits' eager form (calls that took no device kernel), and
# the 32-bit words drawn by bits, uniform and randint
counters = {"fold_in_bits_eager": 0, "draw_words": 0}
DRAWS = "repro_torch.random.draws"
# Elements per chunk of the eager forms: five int64 lanes of this length
# are live at once (about 1.3 GiB at 2**25).
CHUNK = 1 << 25

# (random bits drawn, mantissa bits, bit pattern of 1.0, carrier) per
# uniform dtype. As in JAX, a dtype with fewer than 8 mantissa bits draws
# 8 random bits.
_FLOAT_LAYOUT = {
    torch.float32: (32, 23, 0x3F800000, torch.int32),
    torch.bfloat16: (8, 7, 0x3F80, torch.int16),
    torch.float16: (16, 10, 0x3C00, torch.int16),
}


# ---------------------------------------------------------------------------
# Host-side keys
# ---------------------------------------------------------------------------


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


def _rotl_int(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry_int(k0: int, k1: int, x0: int, x1: int) -> tuple:
    """threefry2x32 of one counter pair, in Python ints."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl_int(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed that fits int32."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit int32")
    return (0, seed & _M32)


def key_data(key: Key) -> tuple:
    """The key's two uint32 words (``jax.random.key_data``)."""
    return (int(key[0]) & _M32, int(key[1]) & _M32)


def is_batch(key) -> bool:
    """True for a key batch (a list of keys)."""
    return isinstance(key, list)


def fold_in(key, data):
    """``jax.random.fold_in``: threefry of the counter pair ``(0, data)``
    (for every key of a batch). Under a key batch ``data`` may also be a
    list, one value per key (each replica at its own step)."""
    if is_batch(key):
        if isinstance(data, (list, tuple)):
            if len(data) != len(key):
                raise ValueError(f"{len(data)} values for a batch of "
                                 f"{len(key)} keys")
            return [fold_in(k, d) for k, d in zip(key, data)]
        return [fold_in(k, data) for k in key]
    return _threefry_int(key[0], key[1], 0, int(data) & _M32)


def shared(key, counters: torch.Tensor) -> torch.Tensor:
    """``counters`` for :func:`fold_in_bits` under ``key``: one row per key
    of a batch (a view), or as they are under a single key."""
    if is_batch(key):
        return counters.expand((len(key),) + tuple(counters.shape))
    return counters


def split(key: Key, num: int = 2) -> list:
    """``jax.random.split`` (partitionable layout): key i hashes counter i."""
    return [_threefry_int(key[0], key[1], i >> 32, i & _M32)
            for i in range(num)]


# ---------------------------------------------------------------------------
# Device-side draws
# ---------------------------------------------------------------------------


def _rotl_(x: torch.Tensor, r: int) -> torch.Tensor:
    hi = x >> (32 - r)
    return x.bitwise_left_shift_(r).bitwise_and_(_M32).bitwise_or_(hi)


def _schedule(key, device) -> tuple:
    """The three key-schedule words: ints, or [R, 1] int64 columns on
    ``device`` for a key batch (copied without a host sync)."""
    if not is_batch(key):
        k0, k1 = key_data(key)
        return (k0, k1, k0 ^ k1 ^ _PARITY)
    rows = [(a, b, a ^ b ^ _PARITY) for a, b in map(key_data, key)]
    t = torch.tensor(rows, dtype=torch.int64)
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return tuple(t[:, j:j + 1] for j in range(3))


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor) -> tuple:
    """threefry2x32 of int64 counter lanes (values in [0, 2**32)); under a
    key batch the lanes are [R, n], row i under key i.

    Updates ``x0`` and ``x1`` in place and returns them."""
    ks = _schedule(key, x0.device)
    x0.add_(ks[0]).bitwise_and_(_M32)
    x1.add_(ks[1]).bitwise_and_(_M32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            _rotl_(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x0, x1


def _bits_lanes(key, start: int, stop: int, device) -> torch.Tensor:
    """32-bit draws for flat counters [start, stop) as int64 lanes, [n] or
    [R, n] under a key batch."""
    n = torch.arange(start, stop, dtype=torch.int64, device=device)
    if is_batch(key):
        n = n.expand(len(key), stop - start).clone()
    hi = n >> 32
    lo = n.bitwise_and_(_M32)
    x0, x1 = threefry2x32(key, hi, lo)
    return x0.bitwise_xor_(x1)


def _rows(key) -> int:
    return len(key) if is_batch(key) else 1


def _chunks(total: int, rows: int = 1):
    """[start, stop) ranges of the per-row counter, ``CHUNK`` lanes in all."""
    step = max(1, CHUNK // rows)
    for start in range(0, total, step):
        yield start, min(start + step, total)


def _lead(key) -> tuple:
    return (len(key),) if is_batch(key) else ()


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 lanes in [0, 2**32) -> int32 tensor with the same bit pattern
    (the lanes are overwritten with their signed value)."""
    return v.add_(1 << 31).bitwise_and_(_M32).sub_(1 << 31).to(torch.int32)


def _randint_form(key, minval: int, maxval: int) -> tuple:
    """randint's two split key sets, its span and its multiplier
    ``((2**16 % span)**2 mod 2**32) % span`` (0 once span > 2**16)."""
    if is_batch(key):
        k1, k2 = (list(ks) for ks in zip(*map(split, key)))
    else:
        k1, k2 = split(key)
    span = (int(maxval) - int(minval)) & _M32 if maxval > minval else 1
    multiplier = ((((1 << 16) % span) ** 2) & _M32) % span
    return k1, k2, span, multiplier


def _draw(key, shape, dtype, device, bounds=None) -> torch.Tensor:
    """The elements of ``bits`` (int32), ``uniform`` (a float dtype) or,
    with ``bounds = (minval, maxval)``, ``randint`` under ``key``: on a CUDA
    device one kernel launch (:func:`repro_torch.kernels.rng.draw`), on any
    other the eager form."""
    shape = tuple(int(s) for s in shape)
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import rng
        return rng.draw(key, shape, dtype, device, bounds)
    return _draw_eager(key, shape, dtype, device, bounds)


def _draw_eager(key, shape, dtype=torch.int32, device="cpu", bounds=None,
                start: int = 0) -> torch.Tensor:
    """:func:`_draw` in int64 lanes, ``CHUNK`` lanes a pass, on any device:
    element e from counter ``start + e``. The oracle the kernel is held
    to."""
    total = math.prod(shape)
    out = torch.empty(_lead(key) + (total,), dtype=dtype, device=device)
    if bounds is not None:
        k1, k2, span, multiplier = _randint_form(key, *bounds)
    elif dtype != torch.int32:
        rng_bits, nmant, one, itype = _FLOAT_LAYOUT[dtype]
    for a, b in _chunks(total, _rows(key)):
        c0, c1 = start + a, start + b
        if bounds is not None:
            hi = _bits_lanes(k1, c0, c1, device).remainder_(span)
            lo = _bits_lanes(k2, c0, c1, device).remainder_(span)
            off = hi.mul_(multiplier).bitwise_and_(_M32).add_(lo)
            off = off.bitwise_and_(_M32).remainder_(span).add_(int(bounds[0]))
            out[..., a:b] = off.to(torch.int32)
        elif dtype == torch.int32:
            out[..., a:b] = _as_int32(_bits_lanes(key, c0, c1, device))
        else:
            v = _bits_lanes(key, c0, c1, device)
            if rng_bits < 32:
                v.bitwise_and_((1 << rng_bits) - 1)   # the draw is cut short
            v = (v >> (rng_bits - nmant)).bitwise_or_(one)
            out[..., a:b] = v.to(itype).view(dtype) - 1.0
    return out.view(_lead(key) + shape)


def kernel_bits(key, shape, device="cpu") -> torch.Tensor:
    """:func:`bits` outside the draws span and uncounted: what a keyed
    kernel's plain version draws in place of the kernel's own hash."""
    return _draw(key, shape, torch.int32, device)


def bits(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int32 bit pattern
    (``[R, *shape]`` under a key batch)."""
    counters["draw_words"] += _rows(key) * math.prod(int(s) for s in shape)
    with spans.span(DRAWS):
        return kernel_bits(key, shape, device)


def uniform(key, shape, dtype=torch.float32,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1) (``[R, *shape]``
    under a key batch)."""
    if dtype not in _FLOAT_LAYOUT:
        raise ValueError(f"uniform draws support "
                         f"{sorted(map(str, _FLOAT_LAYOUT))}, got {dtype}")
    counters["draw_words"] += _rows(key) * math.prod(int(s) for s in shape)
    with spans.span(DRAWS):
        return _draw(key, shape, dtype, device)


def bernoulli(key, p: float = 0.5, shape=(),
              device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: an f32 uniform below ``p``."""
    return uniform(key, shape, torch.float32, device) < p


def randint(key, shape, minval: int, maxval: int,
            device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``
    (``[R, *shape]`` under a key batch).

    Two 32-bit words per element from ``split(key)``, folded into
    ``[0, span)`` with the reference's uint32 arithmetic, where products
    and sums wrap at 2**32: ``((hi % span) * m + lo % span) % span`` with
    ``m = ((2**16 % span)**2 mod 2**32) % span`` (0 once span > 2**16).
    """
    counters["draw_words"] += 2 * _rows(key) * math.prod(int(s)
                                                         for s in shape)
    with spans.span(DRAWS):
        return _draw(key, shape, torch.int32, device, (minval, maxval))


def fold_in_bits(key, counters: torch.Tensor) -> torch.Tensor:
    """``fold_in(key, c)[-1]`` for every element ``c`` of an integer tensor
    (int32 bit patterns, same shape): one threefry pass over the counter
    pairs ``(0, c)``. Equal counters give equal bits. Under a key batch
    ``counters`` is ``[R, ...]``, row i hashed under key i
    (:func:`shared` gives every key the same counters).

    On a CUDA device the counters go to the device kernel
    (:mod:`repro_torch.kernels.rng`), integer ones of another dtype cast
    to int32 first (the cast keeps the low 32-bit word, as the eager
    form's ``& 0xFFFFFFFF`` does); elsewhere they take the eager int64
    form, :func:`_fold_in_bits_eager`, the oracle the kernel is held to."""
    if counters.device.type == "cuda":
        if counters.is_floating_point() or counters.is_complex():
            raise TypeError(f"fold_in_bits takes integer counters, got "
                            f"{counters.dtype}")
        from repro_torch.kernels import rng
        return rng.fold_in_bits(key, counters.to(torch.int32))
    return _fold_in_bits_eager(key, counters)


def _fold_in_bits_eager(key, values: torch.Tensor) -> torch.Tensor:
    """:func:`fold_in_bits` in int64 lanes, on any device; counted in
    ``counters["fold_in_bits_eager"]``."""
    counters["fold_in_bits_eager"] += 1
    flat = values.reshape(_lead(key) + (-1,))
    out = torch.empty(flat.shape, dtype=torch.int32, device=flat.device)
    for start, stop in _chunks(flat.shape[-1], _rows(key)):
        # a copy even of int64 counters: the lanes are updated in place
        x1 = flat[..., start:stop].to(torch.int64, copy=True).bitwise_and_(
            _M32)
        x0 = torch.zeros_like(x1)
        _, x1 = threefry2x32(key, x0, x1)
        out[..., start:stop] = _as_int32(x1)
    return out.view(values.shape)
