"""Fortuin-Kasteleyn bonds for the q-state Potts model.

The port of ``repro.potts.bonds``: a bond between equal-colour neighbours
activates with ``p = 1 - exp(-beta)`` (half the Ising coupling, so at
``beta_potts = 2 * beta_ising`` the thresholds are Ising's). The equality
compare, the counter RNG and the u24 compare are the cluster plane's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.cluster import bonds as B
from repro_torch.core import update_rules
from repro_torch.core import xla_f32

counter_bits = B.counter_bits
global_index = B.global_index
fk_bonds = B.fk_bonds
active = B.active
bond_bits = B.bond_bits


def bond_prob_f32(beta) -> float:
    """p = 1 - exp(-beta) in f32, XLA:CPU's ``exp``."""
    return float(np.float32(1.0)
                 - xla_f32.exp_f32_np(-np.float32(beta)))


def bond_threshold_u24(beta) -> int:
    """ceil(p * 2^24) for p = f32(1 - exp(-beta)) (host int)."""
    return update_rules.thresholds_u24([bond_prob_f32(beta)])[0]


def bond_threshold_traced(betas) -> torch.Tensor:
    """Tensor twin of :func:`bond_threshold_u24` (int64)."""
    b = torch.as_tensor(betas, dtype=torch.float32)
    return B.threshold_from_prob(1.0 - xla_f32.exp_f32(-b))


def cluster_states(bits, q: int) -> torch.Tensor:
    """Uniform colour in {0..q-1} per hash word: ``(u24 * q) >> 24``
    (q <= 256, so the product fits in 32 bits)."""
    return ((B.u24(bits).to(torch.int64) * q) >> 24).to(torch.int32)
