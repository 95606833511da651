"""Single-device Swendsen-Wang / Wolff sweeps on the full [L, L] view.

The port of ``repro.cluster.sweep``. One cluster sweep = FK bond
activation (:mod:`repro_torch.cluster.bonds`) -> labeling
(:mod:`repro_torch.cluster.label`) -> per-cluster spin assignment. The
per-cluster coin is gather-free: every site hashes its (shared) cluster
label, so all sites of a cluster draw the same coin.

* Swendsen-Wang: every cluster flips with probability 1/2 (top hash bit).
* Wolff: one uniformly random seed site; only its cluster flips.

RNG per sweep key k (``fold_in(chain_key, step)``): ``fold_in(k, 0)``
bonds, ``fold_in(k, 1)`` cluster coins, ``fold_in(k, 2)`` the Wolff seed.
A stack ``[N, L, L]`` with a key batch and N thresholds sweeps N replicas
in one pass.
"""
from __future__ import annotations

import torch

from repro_torch import random as jr
from repro_torch.cluster import bonds as B
from repro_torch.cluster import label as LBL
from repro_torch.core.measure import site_mean
from repro_torch.spans import span

_K_BONDS, _K_COINS, _K_SEED = 0, 1, 2


def labels_for(full, key, threshold) -> torch.Tensor:
    """Cluster labels one sweep would use (bond + label stages)."""
    br, bd = B.fk_bonds(full, jr.fold_in(key, _K_BONDS), threshold)
    return LBL.label_components(br, bd)


def wolff_seed_mask(lab, key) -> torch.Tensor:
    """Sites in the cluster of one uniformly random seed site (one per
    replica of a stack)."""
    h, w = lab.shape[-2:]
    seed = jr.randint(jr.fold_in(key, _K_SEED), (), 0, h * w, lab.device)
    flat = lab.reshape(lab.shape[:-2] + (-1,))
    seed_lab = torch.gather(flat, -1, seed.long().reshape(seed.shape + (1,)))
    return lab == seed_lab[..., None]


def _cluster_signs(full, lab, key, algorithm: str) -> torch.Tensor:
    """Bool flip mask per site from the per-cluster coin (or Wolff seed)."""
    with span("repro_torch.cluster.coins"):
        if algorithm == "swendsen_wang":
            coin = B.counter_bits(jr.fold_in(key, _K_COINS), lab)
            return ((coin >> 31) & 1) == 1
        if algorithm == "wolff":
            return wolff_seed_mask(lab, key)
    raise ValueError(f"unknown cluster algorithm {algorithm!r}; "
                     "use 'swendsen_wang' or 'wolff'")


def cluster_sweep(full, key, threshold,
                  algorithm: str = "swendsen_wang") -> torch.Tensor:
    """One cluster update of the full [L, L] lattice."""
    lab = labels_for(full, key, threshold)
    return torch.where(_cluster_signs(full, lab, key, algorithm), -full,
                       full)


def full_stats(full) -> tuple:
    """(m, E/spin) of a full-view lattice (per replica of a stack):
    integer-exact f32 sums below 2^24 spins, divided as
    :func:`repro_torch.core.measure.per_spin`."""
    f = full.float()
    m = site_mean(f, 2)
    e = -site_mean(f * (torch.roll(f, -1, -2) + torch.roll(f, -1, -1)), 2)
    return m, e


def cluster_sweep_measured(full, key, threshold,
                           algorithm: str = "swendsen_wang") -> tuple:
    """``(new_full, (m, E/spin))``."""
    new = cluster_sweep(full, key, threshold, algorithm)
    return new, full_stats(new)
