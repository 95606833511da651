"""Single-device Swendsen-Wang / Wolff sweeps for the q-state Potts model.

The port of ``repro.potts.sweep``: the Ising cluster pipeline with FK
bonds on equal colours (p = 1 - exp(-beta)) and a fresh colour per cluster
instead of a sign flip.

* Swendsen-Wang: every cluster draws a uniform colour, hashed from its
  shared label.
* Wolff: one uniformly random seed site; its cluster moves to
  ``(sigma + r) % q`` with r uniform in {1..q-1}.

RNG per sweep key k: ``fold_in(k, 0)`` bonds, ``fold_in(k, 1)`` cluster
colours, ``fold_in(k, 2)`` the Wolff seed, ``fold_in(k, 3)`` the Wolff
colour shift. A stack ``[N, L, L]`` with a key batch and N thresholds
sweeps N replicas in one pass.
"""
from __future__ import annotations

import torch

from repro_torch import random as jr
from repro_torch.cluster import label as LBL
from repro_torch.cluster import sweep as CS
from repro_torch.core import update_rules
from repro_torch.potts import bonds as PB
from repro_torch.potts import state as PS

_K_BONDS, _K_COINS, _K_SEED, _K_TARGET = 0, 1, 2, 3

ALGORITHMS = ("swendsen_wang", "wolff")


def labels_for(full, key, threshold) -> torch.Tensor:
    """Cluster labels one sweep would use (bond + label stages)."""
    br, bd = PB.fk_bonds(full, jr.fold_in(key, _K_BONDS), threshold)
    return LBL.label_components(br, bd)


def wolff_target_shift(key, q: int, device="cpu") -> torch.Tensor:
    """r in {1..q-1}: the colour shift applied to the Wolff cluster ([N]
    under a key batch)."""
    return jr.randint(jr.fold_in(key, _K_TARGET), (), 1, q, device)


def _cluster_assignment(full, lab, key, q: int, algorithm: str):
    """New colour per site from the per-cluster draw (or Wolff seed)."""
    if algorithm == "swendsen_wang":
        kf = jr.fold_in(key, _K_COINS)
        return PB.cluster_states(PB.counter_bits(kf, lab), q)
    if algorithm == "wolff":
        shift = wolff_target_shift(key, q, full.device)
        moved = (full + update_rules.per_replica(shift, full)) % q
        return torch.where(CS.wolff_seed_mask(lab, key), moved, full)
    raise ValueError(f"unknown cluster algorithm {algorithm!r}; "
                     f"use one of {ALGORITHMS}")


def cluster_sweep(full, key, threshold, q: int,
                  algorithm: str = "swendsen_wang") -> torch.Tensor:
    """One SW/Wolff update of the full [L, L] colour lattice."""
    lab = labels_for(full, key, threshold)
    return _cluster_assignment(full, lab, key, q, algorithm)


def cluster_sweep_measured(full, key, threshold, q: int,
                           algorithm: str = "swendsen_wang") -> tuple:
    """``(new_full, (order_parameter, E/spin))``."""
    new = cluster_sweep(full, key, threshold, q, algorithm)
    return new, PS.full_stats(new, q)
