"""Checkerboard single-site Potts dynamics: heat-bath and Metropolis.

The port of ``repro.potts.rules``. Both rules update one parity class at
a time on the full ``[H, W]`` int32 view; every uniform is a counter hash
of the site's global linear index.

* **Metropolis**: propose a uniformly random *other* colour
  ``(sigma + 1 + r) % q``, ``r = (u24 * (q-1)) >> 24``, accept with
  ``u24 < t[dn + 4]`` where ``dn`` in {-4..4} is the agreement-count change
  and ``t = ceil(min(1, exp(beta * dn)) * 2^24)``.
* **Heat-bath**: the new colour is the number of cumulative thresholds
  ``ceil((cum_s / total) * 2^24)`` at or below the site's u24, with
  weights ``exp(beta * k)`` for agreement counts k = 0..4, summed in the
  reference's order.

A Python-number beta makes the ``exp`` tables literals of the reference's
compiled sweep, which XLA folds at compile time; a tensor beta goes through
its compiled ``exp`` (:func:`repro_torch.core.update_rules.exp_table`).
A stack ``[N, H, W]`` with a key batch and an [N] beta tensor steps N
replicas in one pass.
"""
from __future__ import annotations

import torch

from repro_torch import random as jr
from repro_torch.cluster import bonds as B
from repro_torch.core import update_rules
from repro_torch.potts import state as PS

_U24 = 1 << 24
RULES = ("metropolis", "heat_bath")


def parity_mask(height: int, width: int, color: int,
                device="cpu") -> torch.Tensor:
    """Bool [height, width] mask of sites with parity ``color``."""
    rows = torch.arange(height, dtype=torch.int32, device=device)
    cols = torch.arange(width, dtype=torch.int32, device=device)
    return (rows[:, None] + cols[None, :]) % 2 == color


def uniform_other(bits, sigma, q: int) -> torch.Tensor:
    """A colour != sigma, uniform over the q-1 others."""
    r = ((B.u24(bits).to(torch.int64) * (q - 1)) >> 24).to(torch.int32)
    return (sigma + 1 + r) % q


# ---------------------------------------------------------------------------
# Metropolis
# ---------------------------------------------------------------------------


_DN = tuple(float(d) for d in range(-4, 5))


def metropolis_thresholds_traced(beta, device="cpu") -> torch.Tensor:
    """ceil(min(1, exp(beta*dn)) * 2^24) for dn = -4..4: [9] int64 on
    ``device`` for a literal or tensor beta ([..., 9] for a per-replica
    beta)."""
    p = update_rules.exp_table(beta, 1.0, _DN, device)
    return B.threshold_from_prob(torch.clamp(p, max=1.0))


def metropolis_color(full, key, thresholds, q: int,
                     color: int) -> torch.Tensor:
    """One Metropolis half-update of parity class ``color``;
    ``thresholds`` is the int64 table of :func:`metropolis_thresholds_traced`."""
    h, w = full.shape[-2:]
    gi = jr.shared(key, B.global_index(h, w, device=full.device))
    cand_bits = B.counter_bits(jr.fold_in(key, 0), gi)
    acc_bits = B.counter_bits(jr.fold_in(key, 1), gi)
    cand = uniform_other(cand_bits, full, q)
    nbs = PS.neighbor_states(full)
    dn = (PS.agreement_count(full, cand, nbs)
          - PS.agreement_count(full, full, nbs))
    t = update_rules.lookup(thresholds, (dn + 4).long())
    accept = B.u24(acc_bits) < t
    mask = parity_mask(h, w, color, device=full.device)
    return torch.where(mask & accept, cand, full)


# ---------------------------------------------------------------------------
# Heat-bath
# ---------------------------------------------------------------------------


def heat_bath_weight_table(beta, device="cpu") -> torch.Tensor:
    """[5] f32 exp(beta * k), k = 0..4, for a literal or tensor beta."""
    return update_rules.exp_table(beta, 1.0, (0.0, 1.0, 2.0, 3.0, 4.0),
                                  device)


def heat_bath_color(full, key, beta, q: int, color: int) -> torch.Tensor:
    """One heat-bath half-update of parity class ``color``."""
    h, w = full.shape[-2:]
    gi = jr.shared(key, B.global_index(h, w, device=full.device))
    u = B.u24(B.counter_bits(key, gi))
    table = heat_bath_weight_table(update_rules.per_replica(beta, full),
                                   full.device)
    nbs = PS.neighbor_states(full)
    run = torch.zeros(full.shape, dtype=torch.float32, device=full.device)
    cum = []
    for s in range(q):
        agree = PS.agreement_count(full, s, nbs).long()
        run = run + update_rules.lookup(table, agree)
        cum.append(run)
    total = cum[-1]
    new = torch.zeros(full.shape, dtype=torch.int32, device=full.device)
    for s in range(q - 1):                   # cdf_{q-1} = 1 by construction
        t = B.threshold_from_prob(cum[s] / total)
        new = new + (u >= t).to(torch.int32)
    mask = parity_mask(h, w, color, device=full.device)
    return torch.where(mask, new, full)


# ---------------------------------------------------------------------------
# Full sweeps
# ---------------------------------------------------------------------------


def checkerboard_sweep(full, key, beta, q: int, rule: str = "heat_bath"):
    """One full sweep (both parity classes) under the per-sweep ``key``."""
    if rule not in RULES:
        raise ValueError(f"unknown potts rule {rule!r}; use one of {RULES}")
    thresholds = (metropolis_thresholds_traced(
        update_rules.per_replica(beta, full), full.device)
        if rule == "metropolis" else None)
    for color in (0, 1):
        kc = jr.fold_in(key, color)
        if rule == "heat_bath":
            full = heat_bath_color(full, kc, beta, q, color)
        else:
            full = metropolis_color(full, kc, thresholds, q, color)
    return full


def checkerboard_sweep_measured(full, key, beta, q: int,
                                rule: str = "heat_bath") -> tuple:
    """``(new_full, (order_parameter, E/spin))``."""
    new = checkerboard_sweep(full, key, beta, q, rule)
    return new, PS.full_stats(new, q)
