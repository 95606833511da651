"""Observables for Ising chains: magnetization, energy, Binder parameter.

The port of ``repro.core.observables``. The host statistics (everything
from :func:`susceptibility` down) are numpy float64 and are kept as the
reference wrote them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import lattice as L
from repro_torch.core.measure import per_spin, site_mean


def magnetization(quads: torch.Tensor) -> torch.Tensor:
    """Mean spin  m = (1/N) sum_i sigma_i  (computed in f32; the sum times
    the f32 reciprocal of the count, as the reference's compiled code)."""
    return per_spin(torch.sum(quads.float()), quads.numel())


def energy_per_spin(quads: torch.Tensor) -> torch.Tensor:
    """E/N = -(1/N) sum_<ij> sigma_i sigma_j  (J=1, each bond counted once)
    of quads [..., 4, R, C], per replica."""
    full = L.from_quads(quads).float()
    right = torch.roll(full, -1, -1)
    down = torch.roll(full, -1, -2)
    return -site_mean(full * (right + down), 2)


def energy_per_spin3d(full: torch.Tensor) -> torch.Tensor:
    """E/N for a [..., D, H, W] spin cube (J=1, each bond counted once),
    per replica."""
    f = full.float()
    bonds = sum(torch.roll(f, -1, axis) for axis in (-3, -2, -1))
    return -site_mean(f * bonds, 3)


def binder_parameter(m2, m4):
    """U4 = 1 - <m^4> / (3 <m^2>^2)  (paper §4.1)."""
    return 1.0 - m4 / (3.0 * m2 ** 2)


def critical_temperature() -> float:
    """Onsager: T_c = 2 / ln(1 + sqrt(2)) (k_B = J = 1)."""
    return 2.0 / math.log(1.0 + math.sqrt(2.0))


def susceptibility(m_samples, beta: float, n_spins: int) -> float:
    """chi = beta * N * (<m^2> - <|m|>^2) (per spin, |m| convention)."""
    m = np.abs(np.asarray(m_samples, np.float64))
    return float(beta * n_spins * (np.mean(m ** 2) - np.mean(m) ** 2))


def specific_heat(e_samples, beta: float, n_spins: int) -> float:
    """C = beta^2 * N * (<E^2> - <E>^2) per spin (E is energy per spin)."""
    e = np.asarray(e_samples, np.float64)
    return float(beta ** 2 * n_spins * (np.mean(e ** 2) - np.mean(e) ** 2))


def specific_heat_from_moments(moments: dict, beta: float, n_spins: int):
    """C from a streamed moments dict: beta^2 * N * E_var (or E2 - E^2)."""
    if "E_var" in moments:
        e_var = np.asarray(moments["E_var"], np.float64)
    else:
        e = np.asarray(moments["E"], np.float64)
        e_var = np.asarray(moments["E2"], np.float64) - e ** 2
    c = beta ** 2 * n_spins * e_var
    return float(c) if np.ndim(c) == 0 else c


def susceptibility_from_moments(moments: dict, beta: float, n_spins: int):
    """chi from a streamed moments dict: beta * N * (m2 - m_abs^2)."""
    m2 = np.asarray(moments["m2"], np.float64)
    m_abs = np.asarray(moments["m_abs"], np.float64)
    chi = beta * n_spins * (m2 - m_abs ** 2)
    return float(chi) if np.ndim(chi) == 0 else chi


def autocorrelation(samples, c: float = 5.0, max_lag: int = 0) -> tuple:
    """(tau, window): integrated autocorrelation time with Sokal's
    self-consistent truncation (smallest W with W >= c * tau_int(W))."""
    x = np.asarray(samples, np.float64)
    x = x - x.mean()
    n = x.shape[0]
    if n < 4:
        return 1.0, 1
    var = x.dot(x) / n
    cap = max_lag or n // 2
    cap = max(2, min(cap, n - 1))
    if var <= 0:
        return 1.0, 1
    f = np.fft.rfft(x, 2 * n)
    acov = np.fft.irfft(f * np.conj(f))[:cap]
    rho = (acov / (n - np.arange(cap))) / max(var, 1e-300)
    tau_w = 1.0 + 2.0 * np.cumsum(rho[1:])   # tau_w[k] = tau_int(W = k+1)
    ws = np.arange(1, cap)
    hits = np.nonzero(ws >= c * tau_w)[0]
    w = int(ws[hits[0]]) if hits.size else int(ws[-1])
    return float(max(tau_w[w - 1], 1e-3)), w


def autocorrelation_time(samples, max_lag: int = 0, c: float = 5.0) -> float:
    """Integrated autocorrelation time of a scalar chain (Sokal window)."""
    return autocorrelation(samples, c=c, max_lag=max_lag)[0]


def chain_statistics(m_samples, e_samples, burnin: int = 0, beta: float = 0.0,
                     n_spins: int = 0) -> dict:
    """Reduce per-sweep scalar samples to the paper's Fig.-4 quantities
    (plus susceptibility / specific heat / tau when beta, n_spins given).
    All reductions host-side in numpy float64."""
    m = np.abs(np.asarray(m_samples, np.float64)[burnin:])
    e = np.asarray(e_samples, np.float64)[burnin:]
    m2 = np.mean(m ** 2)
    m4 = np.mean(m ** 4)
    out = {
        "m_abs": float(np.mean(m)),
        "m2": float(m2),
        "m4": float(m4),
        "U4": float(binder_parameter(m2, m4)),
        "E": float(np.mean(e)),
        "n_samples": int(m.shape[0]),
    }
    if beta and n_spins:
        out["chi"] = susceptibility(m_samples[burnin:], beta, n_spins)
        out["C"] = specific_heat(e_samples[burnin:], beta, n_spins)
        tau, window = autocorrelation(m_samples[burnin:])
        out["tau_m"] = tau
        out["tau_window"] = window
    return out
