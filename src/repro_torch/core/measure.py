"""Streaming observable plane: per-sweep (m, E) from quantities the sweep
already computed, plus running-moment accumulation.

The port of ``repro.core.measure`` for one device. The energy uses

    E / N  =  -(1/N) * sum_white sigma_w * nn_w

so the white half-update's own neighbour sums give the bond energy of the
post-sweep state. Every per-site product is a small integer and the f32
partial sums stay integer-exact up to 2**24, so the sums do not depend on
the reduction order.

:class:`Moments` keeps Kahan-compensated running sums of
``(|m|, m^2, m^4)`` and a mean-shifted energy stream; :func:`accumulate`
does the f32 operations in the reference's order.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import checkerboard as cb
from repro_torch.core import lattice as L

# ---------------------------------------------------------------------------
# Per-sweep scalars
# ---------------------------------------------------------------------------


def per_spin(total: torch.Tensor, n_spins: int) -> torch.Tensor:
    """``total / n_spins`` as the reference's compiled loops compute it: XLA
    rewrites a division by a constant into a product with the constant's
    f32 reciprocal (the same value when ``n_spins`` is a power of two)."""
    return total * float(np.float32(1.0) / np.float32(n_spins))


def site_sum(x: torch.Tensor, rank: int) -> torch.Tensor:
    """Sum over the last ``rank`` dims: per replica of an [N, ...] stack,
    all of ``x`` for one chain."""
    if x.dim() == rank:
        return torch.sum(x)
    return torch.sum(x, dim=tuple(range(-rank, 0)))


def site_mean(x: torch.Tensor, rank: int) -> torch.Tensor:
    """f32 mean of the last ``rank`` dims (per replica), as :func:`per_spin`
    divides."""
    return per_spin(site_sum(x.float(), rank), math.prod(x.shape[-rank:]))


def magnetization_mean(quads, n_spins: int) -> torch.Tensor:
    """Mean spin from any local spin tensor (quads, blocked quads, or a
    tuple of quad tensors). ``n_spins`` is the spin count."""
    if isinstance(quads, (tuple, list)):
        s = 0
        for q in quads:
            s = s + torch.sum(q.float())
    else:
        s = torch.sum(quads.float())
    return per_spin(s, n_spins)


def bond_energy_from_nn(s0, s1, nn0, nn1, n_spins: int) -> torch.Tensor:
    """E per spin from one colour's post-flip spins and their nn sums
    (blocked [..., mr, mc, bs, bs]; per replica for a stack)."""
    local = (site_sum(s0.float() * nn0.float(), 4)
             + site_sum(s1.float() * nn1.float(), 4))
    return per_spin(-local, n_spins)


def blocked_stats(qb, n_spins: Optional[int] = None, kh=None,
                  edges=None) -> tuple:
    """(m, E/spin) of blocked quads [4, mr, mc, bs, bs] (stack or 4-tuple)
    from one white-colour nn recompute on the compact matmul stencil."""
    a, b, c, d = (qb[i] for i in range(4))
    if kh is None:
        kh = L.kernel_compact(a.shape[-1], a.dtype, a.device)
    if edges is None:
        edges = cb.default_edges
    if n_spins is None:
        n_spins = 4 * a.numel()
    nn_b, nn_c = cb.nn_white(a, b, c, d, kh, edges)
    m = magnetization_mean((a, b, c, d), n_spins)
    e = bond_energy_from_nn(b, c, nn_b, nn_c, n_spins)
    return m, e


def sweep_compact_measured(quads, probs, beta, block_size: int = L.MXU_BLOCK,
                           accept: str = "lut", edges=cb.default_edges,
                           field: float = 0.0) -> tuple:
    """One full compact sweep that also streams (m, E/spin), reusing the
    white half-update's nn tensors for the energy. Quads [..., 4, R, C]
    give per-replica (m, E)."""
    p = probs.unbind(-3)
    quads = cb.update_color_compact(quads, p[0], p[1], beta, 0, block_size,
                                    accept, edges, field)
    quads, (new0, new1, nn0, nn1) = cb.update_color_compact(
        quads, p[2], p[3], beta, 1, block_size, accept, edges, field,
        return_stats=True)
    m = site_mean(quads, 3)
    e = bond_energy_from_nn(new0, new1, nn0, nn1,
                            math.prod(quads.shape[-3:]))
    return quads, (m, e)


# ---------------------------------------------------------------------------
# Running moments
# ---------------------------------------------------------------------------


class Moments(NamedTuple):
    """Running sums of the Fig.-4 statistics: f32 tensors from
    :func:`accumulate`, host f32 arrays from :func:`moments_from_series`.

    ``n`` counts accumulated samples; ``m_abs``/``m2``/``m4`` are sums of
    |m|, m^2, m^4. The energy stream is mean-shifted: ``e_ref`` is the
    first kept sample, and ``de``/``de2`` sum (E - e_ref) and its square.
    The ``c_*`` fields carry Kahan compensation for the value sums.
    """
    n: torch.Tensor
    m_abs: torch.Tensor
    m2: torch.Tensor
    m4: torch.Tensor
    e_ref: torch.Tensor
    de: torch.Tensor
    de2: torch.Tensor
    c_m_abs: torch.Tensor
    c_m2: torch.Tensor
    c_m4: torch.Tensor
    c_de: torch.Tensor
    c_de2: torch.Tensor


N_FIELDS = 12


def init_moments(batch_shape=(), device="cpu") -> Moments:
    z = torch.zeros(batch_shape, dtype=torch.float32, device=device)
    return Moments(*([z] * N_FIELDS))


def _kahan_add(s, c, x):
    """One compensated-summation step: returns (new_sum, new_comp)."""
    y = x - c
    t = s + y
    return t, (t - s) - y


def _pow4(m):
    """m**4 as ``lax.integer_pow`` evaluates it: the square of the square."""
    m2 = m * m
    return m2 * m2


def accumulate(mom: Moments, m, e, step=None, measure_every: int = 1,
               burnin: int = 0) -> Moments:
    """Add one sweep's (m, e) sample, thinned to ``measure_every`` and
    skipping the first ``burnin`` sweeps. The thinning grid anchors at
    ``burnin``, matching :func:`moments_from_series`."""
    dev = mom.n.device
    m = torch.as_tensor(m, dtype=torch.float32, device=dev)
    e = torch.as_tensor(e, dtype=torch.float32, device=dev)
    w = torch.ones((), dtype=torch.float32, device=dev)
    if step is not None and (measure_every > 1 or burnin):
        step = torch.as_tensor(step, device=dev)
        keep = ((step - burnin) % measure_every == 0) & (step >= burnin)
        w = keep.to(torch.float32)
    e_ref = torch.where((mom.n == 0) & (w > 0), e, mom.e_ref)
    d = e - e_ref
    am = torch.abs(m)
    s1, c1 = _kahan_add(mom.m_abs, mom.c_m_abs, w * am)
    s2, c2 = _kahan_add(mom.m2, mom.c_m2, w * m * m)
    s3, c3 = _kahan_add(mom.m4, mom.c_m4, w * _pow4(m))
    s4, c4 = _kahan_add(mom.de, mom.c_de, w * d)
    s5, c5 = _kahan_add(mom.de2, mom.c_de2, w * d * d)
    return Moments(mom.n + w, s1, s2, s3, e_ref, s4, s5, c1, c2, c3, c4, c5)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def finalize(mom: Moments) -> dict:
    """Host-side reduction of running sums to the Fig.-4 dict (numpy f64):
    m_abs, m2, m4, U4, E, E2, E_var, n_samples."""
    def total(s, c):
        return _host(s).astype(np.float64) - _host(c).astype(np.float64)

    n = np.maximum(_host(mom.n).astype(np.float64), 1.0)
    m_abs = total(mom.m_abs, mom.c_m_abs) / n
    m2 = total(mom.m2, mom.c_m2) / n
    m4 = total(mom.m4, mom.c_m4) / n
    d = total(mom.de, mom.c_de) / n
    d2 = total(mom.de2, mom.c_de2) / n
    e = _host(mom.e_ref).astype(np.float64) + d
    e_var = d2 - d ** 2
    u4 = 1.0 - m4 / np.maximum(3.0 * m2 ** 2, 1e-300)
    out = {"m_abs": m_abs, "m2": m2, "m4": m4, "U4": u4, "E": e,
           "E2": e_var + e ** 2, "E_var": e_var,
           "n_samples": _host(mom.n).astype(np.float64)}
    if np.ndim(n) == 0:
        out = {k: (int(v) if k == "n_samples" else float(v))
               for k, v in out.items()}
    return out


def moments_from_series(ms, es, burnin: int = 0,
                        measure_every: int = 1) -> Moments:
    """Fold an already-collected per-sweep series into Moments (host numpy
    f32 arrays). Sums in f64 on the host; the energy reference is the first
    kept sample, matching :func:`accumulate`."""
    m = _host(ms).astype(np.float64)[..., burnin::measure_every]
    e = _host(es).astype(np.float64)[..., burnin::measure_every]
    n = np.full(m.shape[:-1], m.shape[-1], np.float32)
    z = np.zeros(m.shape[:-1], np.float32)
    e_ref = (e[..., 0] if e.shape[-1]
             else np.zeros(e.shape[:-1], np.float64))
    d = e - e_ref[..., None] if e.shape[-1] else e
    f32 = np.float32
    return Moments(n,
                   np.abs(m).sum(-1).astype(f32),
                   (m * m).sum(-1).astype(f32),
                   (m ** 4).sum(-1).astype(f32),
                   np.asarray(e_ref).astype(f32),
                   d.sum(-1).astype(f32),
                   (d * d).sum(-1).astype(f32),
                   z, z, z, z, z)
