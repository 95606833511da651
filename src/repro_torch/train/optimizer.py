"""Optimizers as functions on tensor trees (the port of
``repro.train.optimizer``): AdamW and Adafactor.

Not ``torch.optim``: the state is a tree beside the parameters with the
reference's names (``m``, ``v``, ``count``; ``v/{vr, vc}`` for
Adafactor's factored moments), so a checkpoint of the port and one of the
reference hold the same leaves. Updates return new trees and compute in
f32 in the reference's order. :func:`state_logical_dims` gives the
state's logical dims (ZeRO-1: each moment inherits its parameter's), which
``distributed.sharding`` resolves to the blocks a rank holds.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import tree
from repro_torch.core.lattice import torch_dtype


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    state_dtype: str = "float32"


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up; ``step`` an int32 tensor, the result f32."""
    warm = torch.clamp_max((step + 1).float() / max(cfg.warmup_steps, 1),
                           1.0)
    return cfg.lr * warm


def global_norm(grads, whole=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (in f32), summed leaf
    by leaf in the reference's order. ``whole`` maps the list of the
    leaves' sums to the whole tensors' (when the leaves are blocks)."""
    sums = [torch.sum(torch.square(g.float())) for g in tree.leaves(grads)]
    total = 0
    for s in (sums if whole is None else whole(sums)):
        total = total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, whole=None):
    """(grads scaled to a global norm of at most ``max_norm``, in f32;
    the norm before clipping)."""
    norm = global_norm(grads, whole)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree.map(lambda g: g.float() * scale, grads), norm


# --- AdamW -------------------------------------------------------------------


def adamw_init(params, cfg: OptimizerConfig):
    dt = torch_dtype(cfg.state_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": tree.map(zeros, params), "v": tree.map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=_device(params))}


def adamw_update(grads, state, params, cfg: OptimizerConfig):
    count = state["count"] + 1
    lr = schedule(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, count.float())
    bc2 = 1 - torch.pow(b2, count.float())

    def upd(g, m, v, p):
        gf = g.float()
        m2 = b1 * m.float() + (1 - b1) * gf
        v2 = b2 * v.float() + (1 - b2) * gf * gf
        step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        new_p = p.float() - lr * step
        return new_p.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)

    out = tree.map(upd, grads, state["m"], state["v"], params)
    pick = _picker(grads, out)
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}


# --- Adafactor ---------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params, cfg: OptimizerConfig):
    def one(p):
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      device=p.device)}
        return {"v": torch.zeros(p.shape, device=p.device)}

    return {"v": tree.map(one, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=_device(params))}


class WholeStats:
    """Adafactor's statistics of a whole tensor. A tensor held as blocks
    (``train.train_step``) replaces these per leaf: its means sum over
    the ring of the reduced dims, and its column moment ``vc``, which the
    rules may split unlike the gradient's columns, is moved between the
    two layouts."""

    @staticmethod
    def mean(x, dim=None, pdim=None):
        """The mean of ``x`` over ``dim`` (None: every element); ``pdim``
        is the parameter's dim that ``dim`` reduces."""
        return torch.mean(x) if dim is None else x.mean(dim)

    @staticmethod
    def columns(vc):
        """The stored ``vc`` in the gradient's layout."""
        return vc

    @staticmethod
    def stored(vc):
        """A ``vc`` in the gradient's layout as it is stored."""
        return vc


def adafactor_update(grads, state, params, cfg: OptimizerConfig,
                     stats=None):
    """``stats``: a tree of the params' structure whose leaves replace
    :class:`WholeStats` for that leaf."""
    count = state["count"] + 1
    lr = schedule(cfg, count)
    decay = 1.0 - torch.pow(count.float() + 1.0, -0.8)

    def upd(g, v, p, st):
        gf = g.float()
        g2 = gf * gf + 1e-30
        n = p.dim()
        mean = st.mean
        if "vr" in v:       # factored (a block's shape may not say so)
            vr = decay * v["vr"] + (1 - decay) * mean(g2, -1, n - 1)
            vc = (decay * st.columns(v["vc"])
                  + (1 - decay) * mean(g2, -2, n - 2))
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp_min(mean(vr, -1, n - 2)[..., None, None],
                                       1e-30))
            step = gf * torch.rsqrt(denom + 1e-30)
            new_v = {"vr": vr, "vc": st.stored(vc)}
        else:
            vf = decay * v["v"] + (1 - decay) * g2
            step = gf * torch.rsqrt(vf + 1e-30)
            new_v = {"v": vf}
        # update clipping (Adafactor's RMS-1 rule)
        rms = torch.sqrt(mean(step * step) + 1e-30)
        step = step / torch.clamp_min(rms, 1.0)
        new_p = (p.float() - lr * step
                 - lr * cfg.weight_decay * p.float())
        return new_p.to(p.dtype), new_v

    if stats is None:
        stats = tree.map(lambda _: WholeStats, params)
    out = tree.map(upd, grads, state["v"], params, stats)
    pick = _picker(grads, out)
    return pick(0), {"v": pick(1), "count": count}


# --- helpers and dispatch ----------------------------------------------------


def _device(params):
    return tree.leaves(params)[0].device


def _picker(like, out):
    """``pick(i)``: the tree of ``like``'s structure holding item ``i`` of
    each tuple leaf of ``out``."""
    return lambda i: tree.map(lambda _, t: t[i], like, out)


def init_fn(kind: str) -> Callable:
    return {"adamw": adamw_init, "adafactor": adafactor_init}[kind]


def update_fn(kind: str) -> Callable:
    return {"adamw": adamw_update, "adafactor": adafactor_update}[kind]


def state_logical_dims(kind: str, param_specs, params):
    """Logical dims for the optimizer state tree (ZeRO-1: same as params;
    factored stats inherit the matching prefix of the param's dims)."""
    if kind == "adamw":
        return {"m": param_specs, "v": param_specs, "count": None}
    if kind == "adafactor":
        def one(p, spec):
            spec = tuple(spec) if spec is not None else (None,) * p.dim()
            if _factored(p.shape):
                return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
            return {"v": spec}
        return {"v": tree.map(one, params, param_specs), "count": None}
    raise ValueError(kind)
