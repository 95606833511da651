"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427): the
port of ``repro.models.rglru``.

Block: two parallel projections d_model -> d_rnn; branch 1 goes through a
width-4 causal conv then the Real-Gated LRU; branch 2 is a GeLU gate; the
product is projected back. Training computes the affine recurrence
h_t = a_t h_{t-1} + b_t with a log-depth scan (:func:`associative_scan`,
the odd/even recursion of ``jax.lax.associative_scan``, so the f32
products associate as the reference's do); decode is the O(1) step and
updates its state in place.

Under tensor parallelism every weight but ``out`` is per channel over
"rnn" and a rank holds its block of the channels: ``wx``, ``wy``, ``w_r``
and ``w_i`` are column-parallel, the conv, the gates and the scan run on
its channels, and ``out`` is row-parallel (one ``sum_over``). The gates
read every channel of the conv's output, gathered over the ring.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.lattice import torch_dtype
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as nn
from repro_torch.models.mamba2 import causal_conv, conv_step

_C = 8.0  # Griffin's gate sharpness constant


def init_rglru(gen, cfg, device, lead=()) -> dict:
    d = cfg.d_model
    d_rnn = d  # RecurrentGemma-2B: d_rnn == d_model (2560)
    dt = torch_dtype(cfg.dtype)
    f32 = torch.float32

    def dense(shape):
        return nn.dense_init(gen, shape, dt, device, lead=lead)

    return {
        "wx": dense((d, d_rnn)),
        "wy": dense((d, d_rnn)),
        "conv_w": dense((cfg.conv_width, d_rnn)),
        "conv_b": nn._zeros((d_rnn,), dt, device, lead),
        "w_r": dense((d_rnn, d_rnn)),
        "b_r": nn._zeros((d_rnn,), f32, device, lead),
        "w_i": dense((d_rnn, d_rnn)),
        "b_i": nn._zeros((d_rnn,), f32, device, lead),
        "lam": torch.full(tuple(lead) + (d_rnn,), 0.65, dtype=f32,
                          device=device),
        "out": dense((d_rnn, d)),
    }


def rglru_specs(cfg) -> dict:
    return {
        "wx": ("embed", "rnn"), "wy": ("embed", "rnn"),
        "conv_w": (None, "rnn"), "conv_b": ("rnn",),
        "w_r": ("embed", "rnn"), "b_r": ("rnn",),
        "w_i": ("embed", "rnn"), "b_i": ("rnn",),
        "lam": ("rnn",), "out": ("rnn", "embed"),
    }


def _gates(p, u, u_all=None):
    """Returns (a, gated input b) in f32 for the recurrence; ``u_all``,
    the gates' input over every channel where ``u`` holds this rank's
    (default ``u``)."""
    uf = u.float()
    ua = uf if u_all is None else u_all.float()
    r = torch.sigmoid(ua @ p["w_r"].float() + p["b_r"])
    i = torch.sigmoid(ua @ p["w_i"].float() + p["b_i"])
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) input normalization keeps the state bounded
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * uf)
    return a, b


def _combine(x, y):
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd, dim: int):
    """[e0, o0, e1, o1, ...] along ``dim``; ``even`` may be one longer."""
    n = odd.shape[dim]
    both = torch.stack([even.narrow(dim, 0, n), odd], dim + 1).flatten(
        dim, dim + 1)
    if even.shape[dim] == n:
        return both
    return torch.cat([both, even.narrow(dim, n, 1)], dim)


def associative_scan(fn, elems: tuple, dim: int) -> tuple:
    """Inclusive scan of the associative ``fn`` over a tuple of tensors
    along ``dim`` (>= 0), by ``jax.lax.associative_scan``'s recursion:
    combine adjacent pairs, scan the pairs, then fill in the even
    positions."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(e, start, stop=None, step=1):
        idx = [slice(None)] * e.dim()
        idx[dim] = slice(start, stop, step)
        return e[tuple(idx)]

    reduced = fn(tuple(sl(e, 0, -1, 2) for e in elems),
                 tuple(sl(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, -1) for e in odd),
                  tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def rglru_scan(p, u, u_all=None):
    """u: [B, S, d_rnn] -> hidden states [B, S, d_rnn] (f32) by the
    log-depth scan."""
    return associative_scan(_combine, _gates(p, u, u_all), 1)[1]


def rglru_reference(p, u):
    """Sequential oracle for tests."""
    a, b = _gates(p, u)
    hs = []
    h = torch.zeros_like(a[:, 0])
    for t in range(u.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def rglru_forward(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full recurrent block over [B, S, d] (train / prefill)."""
    return _block(p, cfg, x)[0]


def _tp(p, cfg):
    """The tensor-parallel grid when ``p`` holds this rank's channels."""
    blk = SH.model_block(p["wx"].shape[-1], cfg.d_model)
    return None if blk is None else blk[0]


def _block(p: dict, cfg, x: torch.Tensor):
    """(block output, the raw pre-conv branch, the hidden states f32), the
    latter two of this rank's channels."""
    grid = _tp(p, cfg)
    if grid is not None:
        x = SH.replicated_over(x, grid, "model")
    branch = x @ p["wx"]
    gate = F.gelu(x @ p["wy"], approximate="tanh")
    u = causal_conv(branch, p["conv_w"], p["conv_b"])
    u_all = (None if grid is None
             else SH.gather_block(u, grid, "model", u.dim() - 1))
    h = rglru_scan(p, u, u_all)
    y = (h.to(x.dtype) * gate) @ p["out"]
    return (y if grid is None else SH.sum_over(y, grid, "model")), branch, h


def init_rglru_state(cfg, batch: int, device="cpu") -> dict:
    d_rnn = cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, d_rnn),
                            dtype=torch_dtype(cfg.dtype), device=device),
        "h": torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
    }


def rglru_state_specs(cfg) -> dict:
    return {"conv": ("batch", None, "rnn"), "h": ("batch", "rnn")}


def rglru_decode(p: dict, cfg, state: dict, x: torch.Tensor):
    """x: [B, 1, d] -> (y [B, 1, d], state), the state's ``conv`` and
    ``h`` updated in place."""
    grid = _tp(p, cfg)
    branch = x[:, 0] @ p["wx"]
    gate = F.gelu(x[:, 0] @ p["wy"], approximate="tanh")
    conv_out, window = conv_step(state["conv"], branch, p["conv_w"],
                                 p["conv_b"])
    u_all = None if grid is None else grid.all_gather(conv_out, "model", -1)
    a, b = _gates(p, conv_out, u_all)
    h = a * state["h"] + b
    y = (h.to(x.dtype) * gate) @ p["out"]
    if grid is not None:
        y = SH.sum_over(y, grid, "model")
    state["conv"].copy_(window)
    state["h"].copy_(h)
    return y[:, None], state
