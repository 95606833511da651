"""A frozen copy of threefry2x32, ``fold_in`` and the counter draws.

Written from the Threefry description (Salmon et al., SC'11: 20 rounds,
rotations (13, 15, 26, 6) and (17, 29, 16, 24), a key injection every four
rounds with the parity word 0x1BD11BDA) and JAX's use of it:

* ``fold_in(key, d)`` is both output words of ``threefry(key, (0, d))``;
* the 32-bit draw of flat counter ``n`` is ``x0 ^ x1`` of
  ``threefry(key, (n >> 32, n & 0xffffffff))``;
* ``fold_in_word(key, c)`` is the last word of ``threefry(key, (0, c))``.

Keys are host pairs of Python ints; device draws run in int64 lanes masked
to 32 bits. Nothing here is imported from the program under test.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry_host(key, x0: int, x1: int) -> tuple:
    """threefry2x32 of one counter pair in Python ints."""
    ks = (key[0] & M32, key[1] & M32, (key[0] ^ key[1] ^ _PARITY) & M32)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def fold_in(key, data: int) -> tuple:
    return threefry_host(key, 0, int(data) & M32)


def seed_key(seed: int) -> tuple:
    """A chain key from a whole-number seed of up to 64 bits: its two
    32-bit words (``PRNGKey(seed)`` for a seed that fits int32)."""
    s = int(seed) % (1 << 64)
    return (s >> 32, s & M32)


def threefry_lanes(key, x0: torch.Tensor, x1: torch.Tensor) -> tuple:
    """threefry2x32 of int64 lanes holding values in [0, 2**32); new
    tensors."""
    k0, k1 = key[0] & M32, key[1] & M32
    ks = (k0, k1, (k0 ^ k1 ^ _PARITY) & M32)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & M32)) & M32
    return x0, x1


def counter_bits(key, n: torch.Tensor) -> torch.Tensor:
    """The 32-bit draws (int64, in [0, 2**32)) of flat counters ``n``
    (int64 tensor)."""
    x0, x1 = threefry_lanes(key, n >> 32, n & M32)
    return x0 ^ x1


def fold_in_word(key, c: torch.Tensor) -> torch.Tensor:
    """The last word of ``fold_in(key, c)`` for every counter ``c`` (int64,
    taken mod 2**32), as int64 in [0, 2**32)."""
    c = c.to(torch.int64) & M32
    _, x1 = threefry_lanes(key, torch.zeros_like(c), c)
    return x1
