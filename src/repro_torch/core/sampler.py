"""MCMC chain drivers for the Ising model (the XLA-path chain).

The port of ``repro.core.sampler``. The reference's ``lax.scan`` and
``lax.fori_loop`` become Python loops; the per-sweep ``m`` and ``E`` stay
on the device and the ``[T]`` series moves to the host once, at the end.

RNG: one threefry key folded per sweep (on the host), so every uniform is
counter-indexed and the chain matches the JAX package from the same key.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as jr
from repro_torch.core import checkerboard as cb
from repro_torch.core import lattice as L
from repro_torch.core import measure as ms


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
    """Uniforms for one sweep: [4, R, C] (black A, D, then white B, C)."""
    return jr.uniform(jr.fold_in(key, step), (4,) + tuple(shape),
                      L.torch_dtype(dtype), device)


def make_sweep_fn(cfg: ChainConfig):
    def one_sweep(quads, key, step: int):
        probs = sweep_probs(key, step, quads.shape[1:], cfg.prob_dtype,
                            quads.device)
        return cb.sweep_compact(quads, probs, cfg.beta, cfg.block_size,
                                cfg.accept, field=cfg.field)

    return one_sweep


def run_chain(quads, key, cfg: ChainConfig):
    """Run cfg.n_sweeps measured sweeps; returns (final_quads, m[T], E[T])
    with the series as host f32 tensors."""
    m_t = torch.empty(cfg.n_sweeps, dtype=torch.float32, device=quads.device)
    e_t = torch.empty_like(m_t)
    for step in range(cfg.n_sweeps):
        probs = sweep_probs(key, step, quads.shape[1:], cfg.prob_dtype,
                            quads.device)
        quads, (m, e) = ms.sweep_compact_measured(
            quads, probs, cfg.beta, cfg.block_size, cfg.accept,
            field=cfg.field)
        m_t[step] = m
        e_t[step] = e
    return quads, m_t.cpu(), e_t.cpu()


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
