"""Streaming observable plane: per-sweep (m, E) from quantities the sweep
already computed, plus running-moment accumulation.

The port of ``repro.core.measure``. The energy uses

    E / N  =  -(1/N) * sum_white sigma_w * nn_w

so the white half-update's own neighbour sums give the bond energy of the
post-sweep state. Every per-site product is a small integer and the f32
partial sums stay integer-exact up to 2**24, so the sums do not depend on
the reduction order, nor on how a decomposed lattice splits them: on a
process grid each rank passes ``psum`` (the grid's all-reduce over its
group, :meth:`repro_torch.launch.mesh.DeviceGrid.psum`) where the reference
calls ``lax.psum``.

:class:`Moments` keeps Kahan-compensated running sums of
``(|m|, m^2, m^4)`` and a mean-shifted energy stream. :func:`accumulate`
does the f32 operations in the order the reference's compiled loops do
(``decomp.make_run_chain_fn`` runs it inside ``lax.fori_loop``), which
fuses products into the Kahan subtraction, given the sample (m, e);
:func:`accumulate_totals` is the same step as those loops compile it
from the sweep's global sums (:class:`Totals`), which the mesh, opt and
3-D mesh runners call. The single-device scenarios fold their series on
the host with :func:`moments_from_series`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import checkerboard as cb
from repro_torch.core import lattice as L
from repro_torch.core.xla_f32 import _fma
from repro_torch.kernels import measure as kmeasure
from repro_torch.spans import span

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


def _psum(x: torch.Tensor, psum) -> torch.Tensor:
    return x if psum is None else psum(x)


class Totals(NamedTuple):
    """One sweep's global sums: ``m_sum`` of the spins and ``e_sum`` of
    ``sigma * nn`` over one colour (each bond once), over ``n_spins``
    sites. The compiled loops of the reference accumulate moments from
    these (:func:`accumulate_totals`), not from the rounded means.

    ``m_scale`` (an f32 value) replaces the ``1/n_spins`` that turns
    ``m_sum`` into m, for an order parameter that is not a spin mean (the
    Potts ``num * f32(1/(q-1))``, :func:`repro_torch.potts.state.
    order_parameter_terms`)."""
    m_sum: torch.Tensor
    e_sum: torch.Tensor
    n_spins: int
    m_scale: Optional[float] = None

    def m_factor(self) -> float:
        if self.m_scale is not None:
            return self.m_scale
        return float(np.float32(1.0) / np.float32(self.n_spins))

    def means(self) -> tuple:
        """(m, E/spin)."""
        return (self.m_sum * self.m_factor(),
                per_spin(-self.e_sum, self.n_spins))


def spin_total(quads, psum=None) -> torch.Tensor:
    """Sum of the spins of any local spin tensor (quads, blocked quads, or
    a tuple of quad tensors), over every rank when ``psum`` is given."""
    if isinstance(quads, (tuple, list)):
        s = 0
        for q in quads:
            s = s + torch.sum(q.float())
    else:
        s = torch.sum(quads.float())
    return _psum(s, psum)


def bond_total(s0, s1, nn0, nn1, psum=None) -> torch.Tensor:
    """Sum of ``sigma * nn`` over one colour's post-flip spins (blocked
    [..., mr, mc, bs, bs]; per replica for a stack)."""
    local = (site_sum(s0.float() * nn0.float(), 4)
             + site_sum(s1.float() * nn1.float(), 4))
    return _psum(local, psum)


def magnetization_mean(quads, n_spins: int, psum=None) -> torch.Tensor:
    """Global mean spin from any local spin tensor. ``n_spins`` is the
    global spin count; ``psum`` sums the local total over the ranks (None:
    one device)."""
    return per_spin(spin_total(quads, psum), n_spins)


def bond_energy_from_nn(s0, s1, nn0, nn1, n_spins: int,
                        psum=None) -> torch.Tensor:
    """E per spin from one colour's post-flip spins and their nn sums
    (blocked [..., mr, mc, bs, bs]; per replica for a stack)."""
    return per_spin(-bond_total(s0, s1, nn0, nn1, psum), n_spins)


def blocked_totals(qb, n_spins: Optional[int] = None, kh=None,
                   edges=None, psum=None) -> Totals:
    """:class:`Totals` of blocked quads [4, mr, mc, bs, bs] (stack or
    4-tuple) from one white-colour nn recompute on the compact matmul
    stencil.

    On a process grid pass the halo ``edges`` provider, the global
    ``n_spins`` and the grid's ``psum``; ``n_spins`` defaults to the local
    spin count (one device).

    A CUDA stack on the torus (no ``kh``, default ``edges``) takes the
    measurement kernel (:func:`repro_torch.kernels.measure.blocked_totals`):
    the exact int64 sums, rounded once to f32. Below 2**24 those are the
    bits of the f32 chain, which every other input takes."""
    with span("repro_torch.measure.blocked_totals"):
        if n_spins is None:
            n_spins = 4 * qb[0].numel()
        if (isinstance(qb, torch.Tensor) and qb.is_cuda and kh is None
                and edges in (None, cb.default_edges)):
            m_sum, e_sum = kmeasure.blocked_totals(qb).to(torch.float32)
            return Totals(_psum(m_sum, psum), _psum(e_sum, psum), n_spins)
        a, b, c, d = (qb[i] for i in range(4))
        if kh is None:
            kh = L.kernel_compact(a.shape[-1], a.dtype, a.device)
        if edges is None:
            edges = cb.default_edges
        nn_b, nn_c = cb.nn_white(a, b, c, d, kh, edges)
        return Totals(spin_total((a, b, c, d), psum),
                      bond_total(b, c, nn_b, nn_c, psum), n_spins)


def blocked_stats(qb, n_spins: Optional[int] = None, kh=None,
                  edges=None, psum=None) -> tuple:
    """(m, E/spin) of blocked quads: :func:`blocked_totals` as means."""
    return blocked_totals(qb, n_spins, kh, edges, psum).means()


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


def _kahan_add_y(s, y):
    """A compensated step whose ``y = x - c`` is given."""
    t = s + y
    return t, (t - s) - y


def _kahan_add(s, c, x):
    """One compensated-summation step: returns (new_sum, new_comp)."""
    return _kahan_add_y(s, x - c)


def _pow4(m):
    """m**4 as ``lax.integer_pow`` evaluates it: the square of the square."""
    m2 = m * m
    return m2 * m2


def accumulate(mom: Moments, m, e, step=None, measure_every: int = 1,
               burnin: int = 0) -> Moments:
    """Add one sweep's (m, e) sample, thinned to ``measure_every`` and
    skipping the first ``burnin`` sweeps. The thinning grid anchors at
    ``burnin``, matching :func:`moments_from_series`.

    The f32 operations are those of the reference's ``accumulate`` as
    XLA:CPU compiles it, which contracts a product feeding the Kahan
    subtraction ``x - c`` into one fused multiply-add: ``w*m*m - c`` and
    ``w*d*d - c`` become ``fma(w*m, m, -c)`` and ``fma(w*d, d, -c)``;
    without thinning the weight is the literal 1, which XLA folds away, so
    ``m**4 - c`` becomes ``fma(m*m, m*m, -c)`` as well. Products with the
    weight alone are exact (it is 0 or 1)."""
    dev = mom.n.device
    m = torch.as_tensor(m, dtype=torch.float32, device=dev)
    e = torch.as_tensor(e, dtype=torch.float32, device=dev)
    thinned = step is not None and (measure_every > 1 or burnin)
    w = torch.ones((), dtype=torch.float32, device=dev)
    if thinned:
        step = torch.as_tensor(step, device=dev)
        keep = ((step - burnin) % measure_every == 0) & (step >= burnin)
        w = keep.to(torch.float32)
    e_ref = torch.where((mom.n == 0) & (w > 0), e, mom.e_ref)
    d = e - e_ref
    am = torch.abs(m)
    s1, c1 = _kahan_add(mom.m_abs, mom.c_m_abs, w * am)
    s2, c2 = _kahan_add_y(mom.m2, _fma(w * m, m, -mom.c_m2))
    if thinned:
        s3, c3 = _kahan_add(mom.m4, mom.c_m4, w * _pow4(m))
    else:
        m2 = m * m
        s3, c3 = _kahan_add_y(mom.m4, _fma(m2, m2, -mom.c_m4))
    s4, c4 = _kahan_add(mom.de, mom.c_de, w * d)
    s5, c5 = _kahan_add_y(mom.de2, _fma(w * d, d, -mom.c_de2))
    return Moments(mom.n + w, s1, s2, s3, e_ref, s4, s5, c1, c2, c3, c4, c5)


def _f32(x) -> float:
    return float(np.float32(x))


def accumulate_totals(mom: Moments, tot: Totals, step=None,
                      measure_every: int = 1, burnin: int = 0) -> Moments:
    """:func:`accumulate` of ``m = m_sum / N`` and ``E = -e_sum / N`` in
    the order the reference's compiled loops (``decomp.make_run_chain_fn``)
    evaluate it. XLA rewrites the division into a product with
    ``r = f32(1/N)`` and reassociates the powers of m, so ``m*m`` is
    ``(s*s) * f32(r*r)`` and ``m**4`` is ``((s*s)*(s*s)) * f32(r2*r2)``
    (without thinning; with it, ``w*m*m`` stays ``(w*m)*m``); LLVM then
    contracts every product that feeds a subtraction into a fused
    multiply-add, ``d = E - e_ref`` included. Thinning turns the products
    with the weight into selects. At a power-of-two N (and |s| < 2^12)
    every form gives the plain operation order's bits. A Potts order
    parameter (``tot.m_scale``) takes the same form with its scale in
    place of ``r`` (held on the Potts meshes, q = 2 and 3)."""
    dev = mom.n.device
    s = torch.as_tensor(tot.m_sum, dtype=torch.float32, device=dev)
    t = torch.as_tensor(tot.e_sum, dtype=torch.float32, device=dev)
    r = _f32(np.float32(1.0) / np.float32(tot.n_spins))
    rm = tot.m_factor()
    r2 = _f32(np.float32(rm) * np.float32(rm))
    r4 = _f32(np.float32(r2) * np.float32(r2))
    m = s * rm
    e = -t * r
    ss = s * s
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if step is not None and (measure_every > 1 or burnin):
        step = torch.as_tensor(step, device=dev)
        keep = ((step - burnin) % measure_every == 0) & (step >= burnin)
        e_ref = torch.where((mom.n == 0) & keep, e, mom.e_ref)
        d = _fma(-t, r, -e_ref)
        y1 = torch.where(keep, torch.abs(m), zero) - mom.c_m_abs
        y2 = _fma(torch.where(keep, m, zero), m, -mom.c_m2)
        y3 = torch.where(keep, (ss * ss) * r4, zero) - mom.c_m4
        y4 = torch.where(keep, d, zero) - mom.c_de
        y5 = _fma(torch.where(keep, d, zero), d, -mom.c_de2)
        w = keep.to(torch.float32)
    else:
        e_ref = torch.where(mom.n == 0, e, mom.e_ref)
        d = _fma(-t, r, -e_ref)
        y1 = torch.abs(m) - mom.c_m_abs
        y2 = _fma(ss, r2, -mom.c_m2)
        y3 = _fma(ss * ss, r4, -mom.c_m4)
        y4 = d - mom.c_de
        y5 = _fma(d, d, -mom.c_de2)
        w = 1.0
    s1, c1 = _kahan_add_y(mom.m_abs, y1)
    s2, c2 = _kahan_add_y(mom.m2, y2)
    s3, c3 = _kahan_add_y(mom.m4, y3)
    s4, c4 = _kahan_add_y(mom.de, y4)
    s5, c5 = _kahan_add_y(mom.de2, y5)
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
