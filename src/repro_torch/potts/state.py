"""q-state Potts lattice state: integer colours and observables.

The port of ``repro.potts.state``. Every site holds a colour in
{0, ..., q-1} (int32 full views ``[H, W]`` on a torus) and the Hamiltonian
rewards agreement, ``H = -sum_<ij> delta(sigma_i, sigma_j)``. Agreement
counts come from the 4-roll primitive; every streamed sum is a small
integer, exact in f32 below 2^24 sites.

The order parameter is ``m = (q * max_s rho_s - 1) / (q - 1)``. Stacks
``[N, H, W]`` give per-replica counts and statistics.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core.measure import site_mean, site_sum

DTYPE = torch.int32


def beta_c(q: int) -> float:
    """Exact transition point of the 2-D q-state Potts model,
    ln(1 + sqrt(q))."""
    return math.log(1.0 + math.sqrt(float(q)))


def random_state(key, height: int, width: int, q: int,
                 device="cpu") -> torch.Tensor:
    """Uniform random colours in {0..q-1}, [height, width] (hot)."""
    return jr.randint(key, (height, width), 0, q, device)


def cold_state(height: int, width: int, device="cpu") -> torch.Tensor:
    """Monochrome colour-0 configuration."""
    return torch.zeros((height, width), dtype=DTYPE, device=device)


def neighbor_states(full) -> tuple:
    """(east, west, south, north) neighbour colours."""
    return (torch.roll(full, -1, -1), torch.roll(full, 1, -1),
            torch.roll(full, -1, -2), torch.roll(full, 1, -2))


def agreement_count(full, state, neighbors=None) -> torch.Tensor:
    """Per-site count of the 4 neighbours equal to ``state`` (int32 0..4);
    ``state`` is a colour or a tensor like ``full``."""
    if neighbors is None:
        neighbors = neighbor_states(full)
    n = torch.zeros(full.shape, dtype=torch.int32, device=full.device)
    for nb in neighbors:
        n = n + (nb == state).to(torch.int32)
    return n


def state_counts(full, q: int) -> torch.Tensor:
    """[..., q] f32 colour populations (exact integers)."""
    return torch.stack([site_sum((full == s).float(), 2) for s in range(q)],
                       -1)


def order_parameter_terms(counts, q: int, n_spins) -> tuple:
    """``(num, scale)`` with m = num * scale: the order parameter from
    colour populations as the reference's compiled code evaluates it. XLA
    turns both divisions into products with f32 reciprocals, folds
    ``q * (1/N)`` into one constant and fuses the multiply-subtract into
    an ``fma``: num = ``fma(max, f32(q * f32(1/N)), -1)``, scale =
    ``f32(1/(q-1))``."""
    f32 = np.float32
    qr = float(f32(q) * (f32(1.0) / f32(n_spins)))
    num = (torch.amax(counts, -1).double() * qr - 1.0).float()
    return num, float(f32(1.0) / f32(q - 1))


def order_parameter_from_counts(counts, q: int, n_spins) -> torch.Tensor:
    """m = (q * max_s rho_s - 1) / (q - 1) from colour populations
    (:func:`order_parameter_terms`)."""
    num, scale = order_parameter_terms(counts, q, n_spins)
    return num * scale


def order_parameter(full, q: int) -> torch.Tensor:
    h, w = full.shape[-2:]
    return order_parameter_from_counts(state_counts(full, q), q, h * w)


def energy_per_spin(full) -> torch.Tensor:
    """E/N = -(1/N) sum_<ij> delta(sigma_i, sigma_j), each bond once."""
    agree = ((full == torch.roll(full, -1, -1)).float()
             + (full == torch.roll(full, -1, -2)).float())
    return -site_mean(agree, 2)


def full_stats(full, q: int) -> tuple:
    """(order parameter, E/spin) of a full view."""
    return order_parameter(full, q), energy_per_spin(full)


def ising_to_potts(full_ising) -> torch.Tensor:
    """Ising {-1,+1} -> q=2 colours {0,1} (+1 -> 0, -1 -> 1)."""
    return torch.div(1 - full_ising.to(torch.int32), 2,
                     rounding_mode="floor").to(DTYPE)


def potts_to_ising(full_potts, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`ising_to_potts` (q = 2 only)."""
    return (1 - 2 * full_potts).to(dtype)
