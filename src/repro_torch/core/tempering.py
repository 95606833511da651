"""Parallel tempering (replica exchange) over the checkerboard sampler.

The port of ``repro.core.tempering``. R replicas ``[R, 4, r, c]`` run at a
ladder of temperatures; every ``exchange_every`` sweeps, adjacent replicas
(pairs ``(i, i+1)`` with ``i % 2`` equal to the round's parity) propose a
swap accepted when ``log(max(u, 1e-30)) < (beta_i - beta_j)(E_i - E_j)``
with E the total energy. Replica i sweeps with ``fold_in(round_key, i)``,
all replicas in one pass over the leading axis; the swap uniforms come
from ``fold_in(round_key, 77)``.

The ``log`` is XLA:CPU's f32 ``log`` (:func:`repro_torch.core.xla_f32.log_f32`)
and the betas are f32 tensors, as the reference traces them, so the swap
decisions are the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core import checkerboard as cb
from repro_torch.core import lattice as L
from repro_torch.core import observables as obs
from repro_torch.core import sampler
from repro_torch.core import xla_f32
from repro_torch.core.measure import site_mean


@dataclasses.dataclass(frozen=True)
class TemperingConfig:
    betas: tuple                  # ladder, ascending or descending
    n_rounds: int                 # rounds of (exchange_every sweeps + swap)
    exchange_every: int = 5
    block_size: int = 16
    accept: str = "lut"
    dtype: str = "bfloat16"


def _sweep_replicas(quads_r, key, step: int, betas, cfg: TemperingConfig):
    """One sweep of every replica at its own temperature."""
    keys = [jr.fold_in(key, i) for i in range(quads_r.shape[0])]
    probs = sampler.sweep_probs(keys, step, quads_r.shape[-2:],
                                torch.float32, quads_r.device)
    return cb.sweep_compact(quads_r, probs, betas, cfg.block_size,
                            cfg.accept)


def _total_energy(quads_r, n_spins: int) -> torch.Tensor:
    return obs.energy_per_spin(quads_r) * n_spins


def _swap_round(quads_r, betas, key, parity: int, n_spins: int):
    """Propose swaps between pairs (i, i+1) with i % 2 == parity; returns
    (permuted replicas, accepted [R] bool)."""
    r = quads_r.shape[0]
    dev = quads_r.device
    e = _total_energy(quads_r, n_spins).float()
    idx = torch.arange(r, device=dev)
    partner = torch.where(idx % 2 == parity, torch.clamp(idx + 1, max=r - 1),
                          torch.clamp(idx - 1, min=0))
    valid = partner != idx
    log_p = (betas[idx] - betas[partner]) * (e[idx] - e[partner])
    u = jr.uniform(key, (r,), torch.float32, dev)
    u_pair = u[torch.minimum(idx, partner)]
    accept = valid & (xla_f32.log_f32(torch.clamp(u_pair, min=1e-30))
                      < log_p)
    perm = torch.where(accept, partner, idx)
    return quads_r[perm], accept


def run_tempering(key, size: int, cfg: TemperingConfig, init_replicas=None,
                  device="cpu"):
    """Returns (final replicas [R, 4, r, c], |m| trace [rounds, R] on the
    host, swap-acceptance fraction). ``init_replicas`` overrides the
    default hot starts."""
    r = len(cfg.betas)
    if init_replicas is not None:
        qs = init_replicas
        device = qs.device
    else:
        qs = torch.stack([
            sampler.init_state(jr.fold_in(key, 1000 + i), size, size,
                               L.torch_dtype(cfg.dtype), hot=True,
                               device=device) for i in range(r)])
    betas = torch.tensor(cfg.betas, dtype=torch.float32, device=device)
    n_spins = qs.shape[1] * qs.shape[2] * qs.shape[3]
    ms = torch.empty((cfg.n_rounds, r), dtype=torch.float32, device=device)
    n_acc = torch.zeros((), dtype=torch.int64, device=device)
    for round_i in range(cfg.n_rounds):
        k_round = jr.fold_in(key, round_i)
        for s in range(cfg.exchange_every):
            qs = _sweep_replicas(qs, k_round, s, betas, cfg)
        qs, acc = _swap_round(qs, betas, jr.fold_in(k_round, 77),
                              round_i % 2, n_spins)
        ms[round_i] = torch.abs(site_mean(qs, 3))
        n_acc += acc.sum()
    frac = (np.float32(int(n_acc))
            / np.float32(max(cfg.n_rounds * (r - 1), 1)))
    return qs, ms.cpu(), float(frac)
