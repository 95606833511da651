"""Fortuin-Kasteleyn bond activation for cluster updates.

The port of ``repro.cluster.bonds``. The bond between two *parallel*
neighbouring spins activates with probability ``p = 1 - exp(-2*beta)``
(never between antiparallel spins).

* **Exact probabilities.** ``p`` is an f32 value, so ``u24 / 2^24 < p``
  equals ``u24 < ceil(p * 2^24)``. :func:`bond_threshold_u24` builds the
  threshold on the host from a Python float beta; :func:`bond_threshold_traced`
  from a tensor of betas. Both use XLA:CPU's f32 ``exp``
  (:mod:`repro_torch.core.xla_f32`), as the reference computes them with
  ``jnp.exp`` outside its compiled loops.
* **Counter-based per-bond RNG.** Every bond is indexed by the global
  linear index of its north/west endpoint and a direction bit; its bits
  are ``fold_in(key, 2*gi + direction)`` over counters
  (:func:`repro_torch.random.fold_in_bits`).

Thresholds are Python ints or int64 tensors (one per replica of an
``[N, H, W]`` stack under a key batch); bits are uint32 patterns in int32
tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core import update_rules
from repro_torch.core import xla_f32
from repro_torch.spans import span

_U24 = 1 << 24


def counter_bits(key, counters: torch.Tensor) -> torch.Tensor:
    """uint32 hash bits per counter (int32 patterns): ``fold_in(key, c)``
    over a tensor. Equal counters give equal bits."""
    return jr.fold_in_bits(key, counters)


def u24(bits: torch.Tensor) -> torch.Tensor:
    """The top 24 bits of uint32 patterns, as non-negative ints."""
    return (bits >> 8) & 0xFFFFFF


def bond_prob_f32(beta) -> float:
    """p = 1 - exp(-2*beta) in f32, XLA:CPU's ``exp``."""
    e = xla_f32.exp_f32_np(np.float32(-2.0) * np.float32(beta))
    return float(np.float32(1.0) - e)


def bond_threshold_u24(beta) -> int:
    """ceil(p * 2^24) for p = f32(1 - exp(-2*beta)) (host int)."""
    return update_rules.thresholds_u24([bond_prob_f32(beta)])[0]


def threshold_from_prob(p: torch.Tensor) -> torch.Tensor:
    """min(ceil(p * 2^24), 2^24) as int64 (exact in f32 for f32 p)."""
    t = torch.ceil(p * float(_U24)).to(torch.int64)
    return torch.clamp(t, max=_U24)


def bond_threshold_traced(betas) -> torch.Tensor:
    """Tensor twin of :func:`bond_threshold_u24` (int64, betas' shape);
    bitwise equal for every f32 beta."""
    b = torch.as_tensor(betas, dtype=torch.float32)
    return threshold_from_prob(1.0 - xla_f32.exp_f32(-2.0 * b))


def global_index(h: int, w: int, row_offset: int = 0, col_offset: int = 0,
                 global_width: int = 0, device="cpu") -> torch.Tensor:
    """int32 [h, w] global linear site indices of a local patch whose
    origin is ``(row_offset, col_offset)`` in a lattice ``global_width``
    wide (one device: offsets 0 and the patch's own width)."""
    gw = global_width or w
    rows = row_offset + torch.arange(h, dtype=torch.int32, device=device)
    cols = col_offset + torch.arange(w, dtype=torch.int32, device=device)
    return rows[:, None] * gw + cols[None, :]


def bond_bits(key, gi: torch.Tensor, direction: int) -> torch.Tensor:
    """Bond bits: direction 0 = east bond of site gi, 1 = south."""
    return counter_bits(key, gi * 2 + direction)


def active(bits: torch.Tensor, threshold) -> torch.Tensor:
    """u24 < threshold (bitwise the f32 compare against p)."""
    return u24(bits) < update_rules.per_replica(threshold, bits)


def fk_bonds(full, key, threshold, east=None, south=None, gi=None):
    """(bond_right, bond_down) bool masks for a lattice ``full``:
    bond_right[i, j] joins (i, j)-(i, j+1), bond_down[i, j] joins
    (i, j)-(i+1, j), torus wrap at the last row and column.

    ``east`` / ``south`` default to local torus rolls and ``gi`` to the
    single-device index grid; a decomposed lattice passes its halo
    neighbours and its patch's global indices instead."""
    with span("repro_torch.cluster.bonds"):
        h, w = full.shape[-2:]
        if east is None:
            east = torch.roll(full, -1, -1)
        if south is None:
            south = torch.roll(full, -1, -2)
        if gi is None:
            gi = global_index(h, w, device=full.device)
        gi = jr.shared(key, gi)
        br = (full == east) & active(bond_bits(key, gi, 0), threshold)
        bd = (full == south) & active(bond_bits(key, gi, 1), threshold)
        return br, bd
