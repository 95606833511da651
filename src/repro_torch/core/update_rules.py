"""Pluggable single-site update rules — one registry, every backend.

The port of ``repro.core.update_rules``. Each :class:`UpdateRule` exposes
three forms of the same transition kernel:

``flip_probs(sigma, nn, probs, beta, field=0.0)``
    Float-uniform form (paper pipeline): ``probs`` are uniforms in [0, 1);
    the compare happens in the lattice dtype, as in the JAX package.

``flip_bits(sigma, nn, bits, beta)``
    Raw-bits form (kernel semantics): uint32 bits (an int32 bit pattern),
    top 24 bits -> f32 uniform, f32 select-chain table, f32 compare.

``flip_bits_int(sigma, nn, bits, beta)``
    Integer-threshold form (``pipeline='opt'``): ``u < ceil(p * 2^24)``
    decides exactly as the f32 compare does. ``bits`` are uint32 (int32
    pattern; the top 24 bits) or uint16 (int16 pattern; the thresholds
    rescaled to 2^16 with ceil).

``kernel_form(beta)``
    Returns ``fn(sigma, nn_f32, bits)`` with the table fixed on the host:
    the form the kernels' plain versions run. :func:`kernel_table` gives
    the same five f32 values to the CUDA kernels.

Rules: ``metropolis_lut`` (exact 5-entry table), ``metropolis_exp`` (the
paper's per-site ``exp``; same table on the bits path), ``metropolis_int``
(the integer-threshold path, decisions bitwise those of ``metropolis_lut``)
and ``heat_bath`` (Glauber). Aliases ``lut``, ``exp``, ``metropolis``,
``int`` and ``glauber`` are accepted by :func:`get_rule`.

``beta`` is a Python number (one chain: the reference bakes it into its
compiled loop) or an f32 tensor (replica couplings: the reference traces
them); an [N] tensor gives replica i of an ``[N, ...]`` lattice its own
beta (:func:`per_replica`, tables looked up by :func:`lookup`). Every f32
``exp`` / ``sigmoid`` on data is XLA:CPU's
(:mod:`repro_torch.core.xla_f32`); a table whose inputs are all literals
(:func:`exp_table` of a Python-number beta) is folded at compile time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core import xla_f32

_INV_2_24 = 1.0 / float(1 << 24)

# x = sigma * nn (metropolis) or nn (heat-bath) lattice values, 2-D torus.
_X_VALUES = (-4.0, -2.0, 0.0, 2.0, 4.0)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int32 pattern) -> f32 uniform in [0, 1) from the top 24
    bits, exact in f32."""
    return ((bits >> 8) & 0xFFFFFF).to(torch.float32) * _INV_2_24


def _select5(x: torch.Tensor, t) -> torch.Tensor:
    """5-entry table lookup over x in {-4,-2,0,2,4} as a select chain,
    thresholds ``x <= -3, -1, 1, 3`` as in the reference. ``t`` holds five
    values of x's dtype."""
    t = [torch.as_tensor(v, dtype=x.dtype, device=x.device) for v in t]
    return torch.where(
        x <= -3.0, t[0],
        torch.where(x <= -1.0, t[1],
                    torch.where(x <= 1.0, t[2],
                                torch.where(x <= 3.0, t[3], t[4]))))


def per_replica(v, x: torch.Tensor):
    """A per-replica value (an [N] tensor) shaped to broadcast against
    ``x`` [N, ...]; numbers and 0-d tensors are returned as they are."""
    if isinstance(v, torch.Tensor) and v.dim():
        return v.reshape(tuple(v.shape) + (1,) * (x.dim() - v.dim()))
    return v


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a [K] table, or per replica for tables
    [N, 1, ..., K] (from a :func:`per_replica` beta) against idx [N, ...]."""
    if table.dim() == 1:
        return table[idx]
    return torch.gather(table.expand(idx.shape[:-1] + table.shape[-1:]), -1,
                        idx)


# ---------------------------------------------------------------------------
# Rule definition / registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UpdateRule:
    """One single-site dynamics, in every form a backend needs."""
    name: str
    flip_probs: Callable        # (sigma, nn, probs, beta, field=0.0)
    flip_bits: Callable         # (sigma, nn, bits, beta)  float-compare
    flip_bits_int: Callable     # (sigma, nn, bits, beta)  integer-compare
    kernel_form: Callable       # (beta) -> fn(sigma, nn_f32, bits)
    table: Callable             # (beta) -> five f32 kernel table values
    supports_field: bool = False


_REGISTRY: dict = {}
_ALIASES = {
    "lut": "metropolis_lut",
    "exp": "metropolis_exp",
    "metropolis": "metropolis_lut",
    "int": "metropolis_int",
    "glauber": "heat_bath",
}


def register_rule(rule: UpdateRule) -> UpdateRule:
    _REGISTRY[rule.name] = rule
    return rule


def get_rule(name: str) -> UpdateRule:
    """Look up a rule by canonical name or alias ('lut', 'exp', ...)."""
    key = _ALIASES.get(name, name)
    try:
        return _REGISTRY[key]
    except KeyError:
        raise ValueError(
            f"unknown update rule {name!r}; known: "
            f"{sorted(_REGISTRY)} (aliases {sorted(_ALIASES)})") from None


def rule_names() -> tuple:
    return tuple(sorted(_REGISTRY))


def thresholds_u24(probs_f32) -> list:
    """ceil(p * 2^24) per f32 probability, capped at 2^24: ``u24 < t``
    decides as ``u24 / 2^24 < p`` does (p * 2^24 is exact in f64)."""
    return [min(math.ceil(float(np.float32(p)) * (1 << 24)), 1 << 24)
            for p in probs_f32]


def _select5_int(x: torch.Tensor, ts, lim: int) -> torch.Tensor:
    """int32 threshold per site from x in {-4,-2,0,2,4} (select chain as
    :func:`_select5`; the first three entries capped at ``lim``)."""
    t = [torch.tensor(v, dtype=torch.int32, device=x.device)
         for v in (min(ts[0], lim), min(ts[1], lim), min(ts[2], lim),
                   ts[3], ts[4])]
    return torch.where(
        x <= -3.0, t[0],
        torch.where(x <= -1.0, t[1],
                    torch.where(x <= 1.0, t[2],
                                torch.where(x <= 3.0, t[3], t[4]))))


def _int_compare(bits: torch.Tensor, ts24: list, x: torch.Tensor):
    """True where the integer uniform falls below the per-x threshold.

    uint32 bits (int32 pattern) compare their top 24 bits, a logical
    shift (the arithmetic ``>> 8`` of the pattern, masked). uint16 bits
    (int16 pattern) widen without sign extension and compare against the
    u24 thresholds rescaled to 2^16 with ceil."""
    if bits.dtype == torch.int16:
        ts = [min((t + 255) >> 8, 1 << 16) for t in ts24]
        u = bits.to(torch.int32) & 0xFFFF
        lim = 1 << 16
    elif bits.dtype == torch.int32:
        ts = ts24
        u = (bits >> 8) & 0xFFFFFF
        lim = 1 << 24
    else:
        raise TypeError(f"integer-threshold bits are int32 (uint32 pattern) "
                        f"or int16 (uint16 pattern), got {bits.dtype}")
    return u < _select5_int(x, ts, lim)


def kernel_table(rule: str, beta: float) -> np.ndarray:
    """The five f32 table values a rule's kernel form compares against:
    f64 ``math.exp`` rounded once to f32."""
    return np.asarray(get_rule(rule).table(float(beta)), np.float32)


# ---------------------------------------------------------------------------
# Metropolis probability tables
# ---------------------------------------------------------------------------


def beta_f32(beta, device="cpu") -> torch.Tensor:
    """beta as an f32 scalar tensor on ``device``."""
    if isinstance(beta, torch.Tensor):
        return beta.to(device=device, dtype=torch.float32)
    return torch.tensor(float(beta), dtype=torch.float32, device=device)


def exp_table(beta, coef: float, x_values, device="cpu") -> torch.Tensor:
    """f32 ``exp((coef * beta) * x)`` over a few table points ``x_values``.

    A tensor beta goes through XLA:CPU's compiled ``exp``, as the
    reference's replica ensembles trace it. A Python-number beta makes
    every input a literal in the reference's compiled loop, and XLA folds
    the table at compile time: the f32 products, then ``exp`` in f64
    rounded once."""
    if isinstance(beta, torch.Tensor):
        x = torch.tensor(x_values, dtype=torch.float32, device=device)
        return xla_f32.exp_f32(coef * beta_f32(beta, device) * x)
    arg = (np.float32(coef) * np.float32(beta)) * np.float32(x_values)
    return torch.from_numpy(xla_f32.exp_f32_folded_np(arg)).to(device)


def acceptance_table(beta, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """acc[k] = exp(-2*beta*x) for x = 2k-4, k=0..4 (x = sigma*nn), in f32
    (:func:`exp_table`), cast to ``dtype``."""
    return exp_table(beta, -2.0, _X_VALUES, device).to(dtype)


def metropolis_table_f32(beta) -> list:
    return [np.float32(math.exp(-2.0 * float(beta) * x)) for x in _X_VALUES]


def metropolis_thresholds_u24(beta) -> list:
    """Integer acceptance thresholds: flip iff (bits >> 8) < t[(x+4)/2]."""
    return thresholds_u24(metropolis_table_f32(beta))


def heat_bath_table_f32(beta) -> list:
    """p_up[k] = f32 sigmoid(2*beta*nn) for nn = 2k-4 — P(new spin = +1)."""
    return [np.float32(1.0 / (1.0 + math.exp(-2.0 * float(beta) * nn)))
            for nn in _X_VALUES]


def heat_bath_thresholds_u24(beta) -> list:
    return thresholds_u24(heat_bath_table_f32(beta))


def metropolis_acceptance(nn: torch.Tensor, sigma: torch.Tensor, beta,
                          method: str = "lut",
                          field: float = 0.0) -> torch.Tensor:
    """P(accept flip of sigma) given neighbour sum nn. Same dtype as sigma.

    A field h forces the per-site exp path: acceptance is
    exp(-2*beta*(x + s*h)) with x = sigma*nn.
    """
    beta = per_replica(beta, sigma)
    x = nn * sigma  # in {-4,-2,0,2,4}, exact in bf16
    b = beta_f32(beta, sigma.device)
    if field:
        arg = x.float() + sigma.float() * np.float32(field)
        return xla_f32.exp_f32(-2.0 * b * arg).to(sigma.dtype)
    if method == "exp":
        return xla_f32.exp_f32(-2.0 * b * x.float()).to(sigma.dtype)
    if method == "lut":
        table = acceptance_table(beta, sigma.dtype, sigma.device)
        idx = ((x.float() + 4.0) * 0.5).to(torch.int64)
        return lookup(table, idx)
    raise ValueError(f"unknown acceptance method {method!r}")


# ---------------------------------------------------------------------------
# Metropolis forms
# ---------------------------------------------------------------------------


def _metropolis_flip_probs(method):
    def flip(sigma, nn, probs, beta, field: float = 0.0):
        acc = metropolis_acceptance(nn, sigma, beta, method, field)
        flips = probs.to(acc.dtype) < acc
        return torch.where(flips, -sigma, sigma)
    return flip


def _metropolis_kernel_form(beta: float):
    t = metropolis_table_f32(beta)

    def flip(sigma, nn, bits):
        x = nn * sigma.float()
        acc = _select5(x, t)
        flips = bits_to_uniform(bits) < acc
        return torch.where(flips, -sigma, sigma)

    return flip


def _metropolis_flip_bits(sigma, nn, bits, beta):
    return _metropolis_kernel_form(float(beta))(sigma, nn.float(), bits)


def _metropolis_flip_bits_int(sigma, nn, bits, beta):
    x = nn * sigma  # lattice dtype, exact
    flips = _int_compare(bits, metropolis_thresholds_u24(beta), x)
    return torch.where(flips, -sigma, sigma)


# ---------------------------------------------------------------------------
# Heat-bath (Glauber) forms
# ---------------------------------------------------------------------------


def _heat_bath_flip_probs(sigma, nn, probs, beta, field: float = 0.0):
    """Draw the new spin from the exact conditional, ignoring the old one:
    P(+1) = sigmoid(2*beta*(nn + h)), compared in the lattice dtype."""
    arg = nn.float()
    if field:
        arg = arg + np.float32(field)
    b = beta_f32(per_replica(beta, sigma), sigma.device)
    p_up = xla_f32.sigmoid_f32(2.0 * b * arg).to(sigma.dtype)
    up = probs.to(p_up.dtype) < p_up
    one = torch.ones((), dtype=sigma.dtype, device=sigma.device)
    return torch.where(up, one, -one)


def _heat_bath_kernel_form(beta: float):
    t = heat_bath_table_f32(beta)

    def draw(sigma, nn, bits):
        p_up = _select5(nn, t)                     # keyed on nn, not sigma*nn
        up = bits_to_uniform(bits) < p_up
        one = torch.ones((), dtype=sigma.dtype, device=sigma.device)
        return torch.where(up, one, -one)

    return draw


def _heat_bath_flip_bits(sigma, nn, bits, beta):
    return _heat_bath_kernel_form(float(beta))(sigma, nn.float(), bits)


def _heat_bath_flip_bits_int(sigma, nn, bits, beta):
    up = _int_compare(bits, heat_bath_thresholds_u24(beta),
                      nn.to(sigma.dtype))
    one = torch.ones((), dtype=sigma.dtype, device=sigma.device)
    return torch.where(up, one, -one)


# ---------------------------------------------------------------------------
# Registry contents
# ---------------------------------------------------------------------------

metropolis_lut = register_rule(UpdateRule(
    name="metropolis_lut",
    flip_probs=_metropolis_flip_probs("lut"),
    flip_bits=_metropolis_flip_bits,
    flip_bits_int=_metropolis_flip_bits_int,
    kernel_form=_metropolis_kernel_form,
    table=metropolis_table_f32,
    supports_field=True,        # field forces the exp path internally
))

metropolis_exp = register_rule(UpdateRule(
    name="metropolis_exp",
    flip_probs=_metropolis_flip_probs("exp"),
    flip_bits=_metropolis_flip_bits,
    flip_bits_int=_metropolis_flip_bits_int,
    kernel_form=_metropolis_kernel_form,
    table=metropolis_table_f32,
    supports_field=True,
))

metropolis_int = register_rule(UpdateRule(
    name="metropolis_int",
    flip_probs=_metropolis_flip_probs("lut"),
    flip_bits=_metropolis_flip_bits,
    flip_bits_int=_metropolis_flip_bits_int,
    kernel_form=_metropolis_kernel_form,
    table=metropolis_table_f32,
))

heat_bath = register_rule(UpdateRule(
    name="heat_bath",
    flip_probs=_heat_bath_flip_probs,
    flip_bits=_heat_bath_flip_bits,
    flip_bits_int=_heat_bath_flip_bits_int,
    kernel_form=_heat_bath_kernel_form,
    table=heat_bath_table_f32,
    supports_field=True,
))
