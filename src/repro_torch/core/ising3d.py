"""3-D Ising checkerboard on a [D, H, W] 3-torus.

The port of ``repro.core.ising3d``. Parity ``(i + j + k) % 2`` colours the
two sub-lattices; each half-sweep draws one uniform per site and flips the
active colour against the 7-entry table over ``x = sigma * nn`` in
{-6, ..., 6}.

The reference sums the four in-plane neighbours with matmuls against the
tridiagonal K (plus torus wrap terms) and the depth pair with rolls. The
sum is a small integer, exact in bf16 and f32 either way, so here all six
neighbours are rolls (:func:`nn_full3d`).

RNG: per-site uniforms hash the *global* linear site index
(:func:`site_uniforms3d`, ``fold_in`` over counters), u24 bits mapped to
f32 exactly, so any spatial decomposition draws the same uniform per site.
The decomposed cube (:mod:`repro_torch.distributed.ising3d`) passes its own
``nn_fn`` (halo'd rolls) and the ``mask`` of its global parity
(:func:`parity_mask3d` with its ``offsets``).

Every function also takes a stack of cubes ``[N, D, H, W]`` with a key
batch and an [N] beta tensor, and steps the N replicas in one pass.
"""
from __future__ import annotations

import torch

from repro_torch import random as jr
from repro_torch.core import lattice as L
from repro_torch.core import observables as obs
from repro_torch.core import update_rules as rules

BETA_C_3D = 0.2216546

_INV_2_24 = 1.0 / float(1 << 24)
_X3_VALUES = (-6.0, -4.0, -2.0, 0.0, 2.0, 4.0, 6.0)


def random_lattice3d(key, depth: int, height: int, width: int,
                     dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    up = jr.bernoulli(key, 0.5, (depth, height, width), device)
    one = torch.ones((), dtype=L.torch_dtype(dtype), device=device)
    return torch.where(up, one, -one)


def cold_lattice3d(depth: int, height: int, width: int,
                   dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    return torch.ones((depth, height, width), dtype=L.torch_dtype(dtype),
                      device=device)


def nn_full3d(full: torch.Tensor) -> torch.Tensor:
    """Sum of the 6 nearest neighbours on the 3-torus (the reference's
    matmul form sums the same small integers exactly)."""
    out = torch.zeros_like(full)
    for axis in (-3, -2, -1):
        out = out + torch.roll(full, 1, axis) + torch.roll(full, -1, axis)
    return out


def acceptance_table3d(beta, device="cpu") -> torch.Tensor:
    """[7] f32 exp(-2*beta*x), x = -6..6 step 2 (literal or traced beta, as
    :func:`repro_torch.core.update_rules.exp_table`)."""
    return rules.exp_table(beta, -2.0, _X3_VALUES, device)


def _acceptance3d(nn, sigma, beta) -> torch.Tensor:
    """7-entry table over x = sigma*nn in {-6,...,6} (exact in bf16)."""
    x = (nn * sigma).float()
    idx = ((x + 6.0) * 0.5).to(torch.int64)
    table = acceptance_table3d(rules.per_replica(beta, sigma), sigma.device)
    return rules.lookup(table, idx)


def parity_mask3d(shape, color: int, device="cpu",
                  offsets=(0, 0, 0)) -> torch.Tensor:
    """Bool [D, H, W] mask of sites with *global* parity ``color``;
    ``offsets`` is the block origin on a decomposed cube."""
    d, h, w = shape
    ar = [o + torch.arange(n, dtype=torch.int32, device=device)
          for o, n in zip(offsets, (d, h, w))]
    i = ar[0][:, None, None] + ar[1][None, :, None] + ar[2][None, None, :]
    return i % 2 == color


def global_index3d(shape, device="cpu") -> torch.Tensor:
    """int32 [D, H, W] linear site indices of a full cube."""
    d, h, w = shape
    return torch.arange(d * h * w, dtype=torch.int32,
                        device=device).view(d, h, w)


def site_uniforms3d(key, gi: torch.Tensor) -> torch.Tensor:
    """f32 uniforms in [0, 1) hashed from global site indices ``gi``
    (u24 / 2^24, exact in f32); ``[N, ...]`` under a key batch."""
    bits = jr.fold_in_bits(key, jr.shared(key, gi))
    return ((bits >> 8) & 0xFFFFFF).float() * _INV_2_24


def update_color3d(full, probs, beta, color: int, nn_fn=nn_full3d,
                   mask=None) -> torch.Tensor:
    """One half-sweep of the sites of parity ``color``. A decomposed cube
    passes its halo'd ``nn_fn`` and the ``mask`` of its global parity."""
    if mask is None:
        mask = parity_mask3d(full.shape[-3:], color, full.device)
    acc = _acceptance3d(nn_fn(full).to(full.dtype), full, beta)
    flips = (probs.float() < acc) & mask
    return torch.where(flips, -full, full)


def sweep3d(full, key, step: int, beta, nn_fn=nn_full3d) -> torch.Tensor:
    """One full 3-D sweep (both colours), counter-based RNG."""
    gi = global_index3d(full.shape[-3:], full.device)
    for color in (0, 1):
        k = jr.fold_in(jr.fold_in(key, step), color)
        full = update_color3d(full, site_uniforms3d(k, gi), beta, color,
                              nn_fn)
    return full


def run_sweeps3d(full, key, n_sweeps: int, beta, nn_fn=nn_full3d):
    """Chain of ``n_sweeps``; returns (final, m[T] on the device)."""
    ms = torch.empty(n_sweeps, dtype=torch.float32, device=full.device)
    for step in range(n_sweeps):
        full = sweep3d(full, key, step, beta, nn_fn)
        ms[step] = obs.magnetization(full)
    return full, ms
