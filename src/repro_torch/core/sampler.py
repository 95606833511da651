"""MCMC chain drivers for the Ising model (the XLA-path chain).

The port of ``repro.core.sampler``. The reference's ``lax.scan`` and
``lax.fori_loop`` become Python loops; the per-sweep ``m`` and ``E`` stay
on the device and the ``[T]`` series moves to the host once, at the end.

RNG: one threefry key folded per sweep (on the host), so every uniform is
counter-indexed and the chain matches the JAX package from the same key.
Under a key batch (:mod:`repro_torch.random`) the same code steps every
replica of an ``[N, 4, R, C]`` stack in one pass.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as jr
from repro_torch.core import checkerboard as cb
from repro_torch.core import lattice as L
from repro_torch.core import measure as ms
from repro_torch.core import observables as obs


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    beta: float
    n_sweeps: int
    block_size: int = L.MXU_BLOCK
    accept: str = "lut"          # update rule: "lut" | "exp" | "heat_bath"
    dtype: str = "bfloat16"      # lattice/acceptance dtype
    prob_dtype: str = "float32"  # dtype of the uniform draws
    measure: bool = True
    field: float = 0.0           # external field h (paper: h = 0)


def sweep_probs(key, step: int, shape, dtype=torch.float32,
                device="cpu") -> torch.Tensor:
    """Uniforms for one sweep: [4, R, C] (black A, D, then white B, C);
    [N, 4, R, C] under a key batch."""
    return jr.uniform(jr.fold_in(key, step), (4,) + tuple(shape),
                      L.torch_dtype(dtype), device)


def make_sweep_fn(cfg: ChainConfig):
    def one_sweep(quads, key, step: int):
        probs = sweep_probs(key, step, quads.shape[-2:], cfg.prob_dtype,
                            quads.device)
        return cb.sweep_compact(quads, probs, cfg.beta, cfg.block_size,
                                cfg.accept, field=cfg.field)

    return one_sweep


def run_chain(quads, key, cfg: ChainConfig):
    """Run cfg.n_sweeps measured sweeps; returns (final_quads, m[T], E[T])
    with the series as host f32 tensors ([N, T] for a key batch)."""
    m_t, e_t = [], []
    for step in range(cfg.n_sweeps):
        probs = sweep_probs(key, step, quads.shape[-2:], cfg.prob_dtype,
                            quads.device)
        quads, (m, e) = ms.sweep_compact_measured(
            quads, probs, cfg.beta, cfg.block_size, cfg.accept,
            field=cfg.field)
        m_t.append(m)
        e_t.append(e)
    return quads, torch.stack(m_t, -1).cpu(), torch.stack(e_t, -1).cpu()


def run_sweeps(quads, key, cfg: ChainConfig):
    """Measurement-free sweep loop (throughput runs)."""
    one_sweep = make_sweep_fn(cfg)
    for step in range(cfg.n_sweeps):
        quads = one_sweep(quads, key, step)
    return quads


def init_state(key, height: int, width: int, dtype=torch.bfloat16,
               hot: bool = True, device="cpu") -> torch.Tensor:
    full = (L.random_lattice(key, height, width, dtype, device) if hot
            else L.cold_lattice(height, width, dtype, device))
    return L.to_quads(full)


def run_chains_batched(quads_batch, key, cfg: ChainConfig):
    """N independent chains over the leading axis of [N, 4, R, C], stepped
    together, chain i keyed ``fold_in(key, i)``. Returns (final
    [N, 4, R, C], m [N, T], E [N, T]), the series on the host."""
    keys = [jr.fold_in(key, i) for i in range(quads_batch.shape[0])]
    return run_chain(quads_batch, keys, cfg)


def measure_curve(key, size: int, temperatures, n_sweeps: int, burnin: int,
                  dtype="bfloat16", accept="lut", block_size: int = 0,
                  device="cpu") -> list:
    """Paper Fig. 4 driver: U4 and |m| vs T for one lattice size, one
    chain per temperature (cold below Tc, hot above)."""
    block_size = block_size or min(L.MXU_BLOCK, size // 2)
    tc = obs.critical_temperature()
    results = []
    for t in temperatures:
        cfg = ChainConfig(beta=1.0 / t, n_sweeps=n_sweeps,
                          block_size=block_size, accept=accept, dtype=dtype)
        k_init, k_chain = jr.split(jr.fold_in(key, hash(t) % (2 ** 31)))
        quads = init_state(k_init, size, size, L.torch_dtype(dtype),
                           hot=bool(t > tc), device=device)
        _, m_t, e_t = run_chain(quads, k_chain, cfg)
        stats = obs.chain_statistics(m_t.numpy(), e_t.numpy(), burnin)
        stats["T"] = float(t)
        stats["size"] = size
        results.append(stats)
    return results
