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


def parity_mask(height: int, width: int, color: int, row_offset: int = 0,
                col_offset: int = 0, device="cpu") -> torch.Tensor:
    """Bool [height, width] mask of sites with global parity ``color`` (a
    patch at ``(row_offset, col_offset)``)."""
    rows = row_offset + torch.arange(height, dtype=torch.int32,
                                     device=device)
    cols = col_offset + torch.arange(width, dtype=torch.int32, device=device)
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


def _geometry(full, key, gi, mask, color):
    """The site counters (shared by every key of a batch) and parity mask
    of a half-update: the given ones, or the single-device full view's."""
    h, w = full.shape[-2:]
    if gi is None:
        gi = B.global_index(h, w, device=full.device)
    if mask is None:
        mask = parity_mask(h, w, color, device=full.device)
    return jr.shared(key, gi), mask


def metropolis_color(full, key, thresholds, q: int, color: int, gi=None,
                     neighbors=None, mask=None) -> torch.Tensor:
    """One Metropolis half-update of parity class ``color``;
    ``thresholds`` is the int64 table of :func:`metropolis_thresholds_traced`.
    ``gi`` / ``neighbors`` / ``mask`` default to the single-device full
    view; a decomposed lattice passes its patch's global indices, halo
    neighbour colours and offset parity mask."""
    gi, mask = _geometry(full, key, gi, mask, color)
    cand_bits = B.counter_bits(jr.fold_in(key, 0), gi)
    acc_bits = B.counter_bits(jr.fold_in(key, 1), gi)
    cand = uniform_other(cand_bits, full, q)
    nbs = PS.neighbor_states(full) if neighbors is None else neighbors
    dn = (PS.agreement_count(full, cand, nbs)
          - PS.agreement_count(full, full, nbs))
    t = update_rules.lookup(thresholds, (dn + 4).long())
    accept = B.u24(acc_bits) < t
    return torch.where(mask & accept, cand, full)


# ---------------------------------------------------------------------------
# Heat-bath
# ---------------------------------------------------------------------------


def heat_bath_weight_table(beta, device="cpu") -> torch.Tensor:
    """[5] f32 exp(beta * k), k = 0..4, for a literal or tensor beta."""
    return update_rules.exp_table(beta, 1.0, (0.0, 1.0, 2.0, 3.0, 4.0),
                                  device)


def heat_bath_color(full, key, beta, q: int, color: int, gi=None,
                    neighbors=None, mask=None) -> torch.Tensor:
    """One heat-bath half-update of parity class ``color`` (overrides as
    in :func:`metropolis_color`)."""
    gi, mask = _geometry(full, key, gi, mask, color)
    u = B.u24(B.counter_bits(key, gi))
    table = heat_bath_weight_table(update_rules.per_replica(beta, full),
                                   full.device)
    nbs = PS.neighbor_states(full) if neighbors is None else neighbors
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
    return torch.where(mask, new, full)


# ---------------------------------------------------------------------------
# Full sweeps
# ---------------------------------------------------------------------------


def checkerboard_sweep(full, key, beta, q: int, rule: str = "heat_bath",
                       gi=None, neighbors_fn=None, masks=None):
    """One full sweep (both parity classes) under the per-sweep ``key``.

    A decomposed lattice passes its patch's geometry: ``gi`` (global site
    indices), ``neighbors_fn(full)`` (halo neighbour colours, evaluated
    before each half-update, since the first changes what the second
    reads) and ``masks`` (the two offset parity masks). The defaults are
    the single-device full view."""
    if rule not in RULES:
        raise ValueError(f"unknown potts rule {rule!r}; use one of {RULES}")
    thresholds = (metropolis_thresholds_traced(
        update_rules.per_replica(beta, full), full.device)
        if rule == "metropolis" else None)
    for color in (0, 1):
        kc = jr.fold_in(key, color)
        nbs = neighbors_fn(full) if neighbors_fn is not None else None
        mask = masks[color] if masks is not None else None
        if rule == "heat_bath":
            full = heat_bath_color(full, kc, beta, q, color, gi=gi,
                                   neighbors=nbs, mask=mask)
        else:
            full = metropolis_color(full, kc, thresholds, q, color, gi=gi,
                                    neighbors=nbs, mask=mask)
    return full


def checkerboard_sweep_measured(full, key, beta, q: int,
                                rule: str = "heat_bath") -> tuple:
    """``(new_full, (order_parameter, E/spin))``."""
    new = checkerboard_sweep(full, key, beta, q, rule)
    return new, PS.full_stats(new, q)
