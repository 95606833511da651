"""Token-dropping Mixture-of-Experts with expert parallelism: the port of
``repro.models.moe``.

Sort-based dispatch (no [T, E, cap] one-hots): the T*k routed slots are
sorted by expert (stable), positioned within their expert group by a
cumulative-count offset, dropped beyond ``capacity``, written into an
``[E, cap, d]`` buffer, transformed by a batched per-expert FFN, and
combined back with the router weights. Capacity is static:
cap = ceil(cf * T * k / E) rounded up to a multiple of 4.

Deterministic on the card: every index write and gather of the dispatch
is a permutation or hits unique rows (dropped slots go to a sink row that
is sliced off), and the combine sums each token's k contributions in a
fixed order (the reference's: ascending expert) instead of a scatter-add,
so neither the forward nor the backward needs atomics whose order varies.

Inside ``distributed.sharding.activation_sharding`` (the tokens are this
rank's rows over the batch axes) the reference's two grid forms apply:
:func:`moe_forward_ep` dispatches the local tokens to this rank's block of
experts over "model" and sums the partial outputs with one all-reduce;
:func:`moe_forward_gspmd` routes the whole microbatch, as GSPMD computes
it, gathering the other ranks' tokens and keeping its own rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.lattice import torch_dtype
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as nn


def init_moe(gen, cfg, device, lead=()) -> dict:
    d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    dt = torch_dtype(cfg.dtype)
    params = {
        "router": nn.dense_init(gen, (d, e), torch.float32, device,
                                lead=lead),
        "wi": nn.dense_init(gen, (e, d, ff), dt, device, in_axes=(1,),
                            lead=lead),
        "wo": nn.dense_init(gen, (e, ff, d), dt, device, in_axes=(1,),
                            lead=lead),
    }
    if cfg.activation in ("swiglu", "geglu"):
        params["wg"] = nn.dense_init(gen, (e, d, ff), dt, device,
                                     in_axes=(1,), lead=lead)
    if cfg.n_shared_experts:
        params["shared"] = nn.init_mlp(gen, cfg, device,
                                       d_ff=ff * cfg.n_shared_experts,
                                       lead=lead)
    return params


def moe_specs(cfg) -> dict:
    specs = {
        "router": ("embed", None),
        "wi": ("experts", "embed", "ffn"),
        "wo": ("experts", "ffn", "embed"),
    }
    if cfg.activation in ("swiglu", "geglu"):
        specs["wg"] = ("experts", "embed", "ffn")
    if cfg.n_shared_experts:
        specs["shared"] = nn.mlp_specs(cfg)
    return specs


def _expert_act(cfg, ebuf, p):
    """Per-expert FFN: [E, cap, d] -> [E, cap, d]."""
    hi = torch.bmm(ebuf, p["wi"])
    if cfg.activation in ("swiglu", "geglu"):
        g = torch.bmm(ebuf, p["wg"])
        gate = (F.silu(g) if cfg.activation == "swiglu"
                else F.gelu(g, approximate="tanh"))
        h = gate * hi
    elif cfg.activation == "squared_relu":
        r = F.relu(hi)
        h = r * r
    else:
        h = F.gelu(hi, approximate="tanh")
    return torch.bmm(h, p["wo"])


def capacity(cfg, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.experts_per_token
              / cfg.n_experts)
    return max(4, -(-cap // 4) * 4)  # round up to a multiple of 4


def top_k(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest f32 logits per row, as
    ``lax.top_k``: IEEE total order (+0 above -0) and ties to the lower
    index (a stable descending sort of the order-preserving int keys)."""
    bits = logits.view(torch.int32)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(keys, dim=-1, descending=True, stable=True)[1][..., :k]
    return logits.gather(-1, idx), idx


def route(cfg, logits: torch.Tensor, e_lo: int, e_local: int, cap: int):
    """The dispatch plan of experts [e_lo, e_lo + e_local) for logits
    [T, E]: a dict of ``gate_idx`` [T, k], ``weights`` [T, k] (softmax of
    the top-k logits), ``order`` (the slots t*k + j sorted by local
    expert, stable; other experts' slots last), ``keep`` and ``dest``
    (buffer row of each sorted slot), and ``counts`` [E] (slots per
    expert, over all experts)."""
    t = logits.shape[0]
    k = cfg.experts_per_token
    dev = logits.device
    gate_vals, gate_idx = top_k(logits, k)
    weights = torch.softmax(gate_vals, dim=-1)
    flat_e = gate_idx.reshape(-1)
    ones = torch.ones_like(flat_e)
    counts = torch.zeros(cfg.n_experts, dtype=flat_e.dtype,
                         device=dev).index_add_(0, flat_e, ones)
    loc = flat_e - e_lo
    is_local = (loc >= 0) & (loc < e_local)
    loc = torch.where(is_local, loc, e_local)             # OOB sentinel
    order = torch.argsort(loc, stable=True)               # locals first
    sorted_e = loc[order]
    local_counts = torch.zeros(e_local + 1, dtype=loc.dtype,
                               device=dev).index_add_(0, loc, ones)[:e_local]
    offsets = torch.cumsum(local_counts, 0) - local_counts
    safe_e = torch.clamp(sorted_e, 0, e_local - 1)
    pos_in_e = torch.arange(t * k, device=dev) - offsets[safe_e]
    keep = (sorted_e < e_local) & (pos_in_e < cap)
    dest = safe_e * cap + torch.clamp(pos_in_e, 0, cap - 1)
    return {"gate_idx": gate_idx, "weights": weights, "order": order,
            "keep": keep, "dest": dest, "counts": counts}


def _dispatch_combine(cfg, xf, logits, wi, wg, wo, e_lo: int, e_local: int,
                      cap: int):
    """Sort-based dispatch restricted to experts [e_lo, e_lo + e_local).

    xf: [T, d]; logits: [T, E_total]. Returns (y [T, d], counts [E_total])
    where y holds only the local experts' contributions (a partial sum: the
    expert-parallel caller sums it over the expert axis).
    """
    t, d = xf.shape
    k = cfg.experts_per_token
    r = route(cfg, logits, e_lo, e_local, cap)
    order, keep = r["order"], r["keep"]
    sink = e_local * cap
    slot = torch.where(keep, r["dest"], sink)   # buffer row, or the sink
    # the token of each sorted slot: a permutation of the k-fold copy, so
    # the gather's gradient sums k rows per token by the expand, in order
    xs = xf[:, None].expand(t, k, d).reshape(t * k, d)[order]
    buf = xf.new_zeros((sink + 1, d)).index_put((slot,), xs)[:sink]
    p_local = {"wi": wi, "wo": wo}
    if wg is not None:
        p_local["wg"] = wg
    out = _expert_act(cfg, buf.reshape(e_local, cap, d), p_local)
    out = torch.cat([out.reshape(sink, d), out.new_zeros((1, d))])
    w_sorted = r["weights"].reshape(-1)[order]
    contrib = out[slot] * (w_sorted * keep).to(out.dtype)[:, None]
    # combine: each token's k contributions summed from zero in sorted
    # order (ascending expert, the order of the reference's scatter-add),
    # in the model's dtype
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=order.device)
    per_tok = contrib[torch.sort(rank.reshape(t, k), dim=-1).values]
    y = xf.new_zeros((t, d))
    for j in range(k):
        y = y + per_tok[:, j].to(xf.dtype)
    return y, r["counts"]


def moe_forward_ep(p: dict, cfg, x: torch.Tensor, grid):
    """Expert-parallel MoE (the reference's shard_map form). ``x`` [b, s,
    d] is this rank's rows over the batch axes of the activation context,
    held whole along "model"; the rank dispatches them to its block of
    n_experts / model experts (capacity from the local tokens) and the
    partial outputs are summed over "model". When the experts do not
    divide the model axis every rank runs all of them (no sum). Returns
    (y, aux), aux averaged over the batch axes."""
    b, s, d = x.shape
    batch_axes = SH.current_batch_axes()
    e_par = grid.axis_size("model") if "model" in grid.axes else 1
    if cfg.n_experts % e_par:
        e_par = 1  # indivisible: run experts replicated (local dispatch)
    e_local = cfg.n_experts // e_par
    t = b * s
    cap = capacity(cfg, t)
    xf = x.reshape(t, d)
    logits = xf.float() @ p["router"]
    wg = p.get("wg")
    e_lo = 0
    if e_par > 1:
        # the dispatch's tokens and logits are replicated over "model" and
        # each rank's share of their cotangents partial; the weights are
        # this rank's experts (given as its blocks under tensor
        # parallelism, else cut from the whole weights)
        e_lo = grid.axis_index("model") * e_local
        xd = SH.replicated_over(xf, grid, "model")
        ld = SH.replicated_over(logits, grid, "model")
        mine = SH.model_block(p["wi"].shape[0], cfg.n_experts) is not None
        wi, wo, wg = ((w if w is None or mine else
                       SH.block_over(w, grid, "model"))
                      for w in (p["wi"], p["wo"], wg))
    else:
        xd, ld = xf, logits
        wi, wg, wo = _whole_experts(p, cfg)
    y, counts = _dispatch_combine(cfg, xd, ld, wi, wg, wo, e_lo, e_local,
                                  cap)
    if e_par > 1:
        y = SH.sum_over(y, grid, "model")
    # Switch aux loss: the same on every model rank (same tokens, same
    # router), different per batch shard -> averaged over the batch axes
    probs = torch.softmax(logits, dim=-1)
    frac = counts.float() / (t * cfg.experts_per_token)
    aux = cfg.n_experts * torch.sum(frac * probs.mean(0))
    n = grid.axis_size(batch_axes)
    if n > 1:   # lax.pmean: each rank's cotangent to its own term, / n
        aux = SH.sum_over(aux, grid, batch_axes) / n
    y = y.reshape(x.shape)
    if cfg.n_shared_experts:
        y = y + _shared(p, cfg, xf).reshape(x.shape)
    return y, aux


def _shared(p, cfg, x):
    """The shared experts' MLP (tensor-parallel over its ffn columns like
    any MLP)."""
    return nn.mlp_forward(p["shared"], cfg, x,
                          cfg.moe_d_ff * cfg.n_shared_experts)


def _whole_experts(p, cfg):
    """(wi, wg, wo) whole: gathered over "model" where they are this
    rank's block of the experts or of their ffn columns (every rank of the
    ring then computes the same dispatch, so each keeps its block's share
    of their gradient)."""
    out = []
    for name, ffn_dim in (("wi", 2), ("wg", 2), ("wo", 1)):
        w = p.get(name)
        for dim, n in ((0, cfg.n_experts), (ffn_dim, cfg.moe_d_ff)):
            blk = None if w is None else SH.model_block(w.shape[dim], n)
            if blk is not None:
                w = SH.gather_block(w, blk[0], "model", dim, summed=False)
        out.append(w)
    return tuple(out)


def moe_forward(p: dict, cfg, x: torch.Tensor):
    """x: [B, S, d] -> (y, aux_load_balance_loss).

    Expert-parallel (:func:`moe_forward_ep`) when ``cfg.moe_impl == "ep"``
    inside an activation context whose grid has a model axis, and the
    microbatch holds at least 2 tokens an expert (EP pays one all-reduce
    and a dispatch per rank a layer: a loss for single-token decode);
    otherwise :func:`moe_forward_gspmd`.
    """
    grid, _ = SH.current_mesh_and_rules()
    if cfg.moe_impl == "ep" and grid is not None and "model" in grid.axes:
        n_tokens = x.shape[0] * x.shape[1] \
            * grid.axis_size(SH.current_batch_axes())
        if n_tokens >= 2 * cfg.n_experts:
            return moe_forward_ep(p, cfg, x, grid)
    return moe_forward_gspmd(p, cfg, x)


def _whole_microbatch(x: torch.Tensor):
    """Inside an activation context: (the microbatch's tokens [B*s, d]
    gathered over the batch axes, this rank's rows of them) -- the other
    ranks' rows as constants, so gradients reach this rank's tokens only.
    Outside one: (x's tokens, all rows)."""
    grid, _ = SH.current_mesh_and_rules()
    axes = SH.current_batch_axes()
    xf = x.reshape(-1, x.shape[-1])
    if grid is None or grid.axis_size(axes) == 1:
        return xf, slice(None)
    whole = grid.all_gather(xf, axes, 0)
    lo = grid.axis_index(axes) * xf.shape[0]
    rows = slice(lo, lo + xf.shape[0])
    return torch.cat([whole[:lo], xf, whole[rows.stop:]]), rows


def moe_forward_gspmd(p: dict, cfg, x: torch.Tensor):
    """The sort-based dispatch over all experts and the whole microbatch
    (global capacity and positions), plus the shared expert and the
    Switch-style load-balance aux loss."""
    b, s, d = x.shape
    e = cfg.n_experts
    xf, rows = _whole_microbatch(x)
    t = xf.shape[0]
    logits = xf.float() @ p["router"]                          # [T, E]
    if rows != slice(None):
        # the router's gradient from this rank's tokens only
        logits = torch.cat([logits[:rows.start].detach(), logits[rows],
                            logits[rows.stop:].detach()])
    wi, wg, wo = _whole_experts(p, cfg)
    y, counts = _dispatch_combine(cfg, xf, logits, wi, wg, wo, 0, e,
                                  capacity(cfg, t))
    y, xl = y[rows], xf[rows]
    if cfg.n_shared_experts:
        y = y + _shared(p, cfg, xl)
    # load-balance aux (Switch-style): E * sum_e f_e * p_e
    probs = torch.softmax(logits, dim=-1)
    frac = counts.float() / (t * cfg.experts_per_token)
    aux = e * torch.sum(frac * probs.mean(0))
    return y.reshape(b, s, d), aux


def moe_forward_dense(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Reference: every expert over every token (tests only, O(E))."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    logits = xf.float() @ p["router"]
    gate_vals, gate_idx = top_k(logits, cfg.experts_per_token)
    weights = torch.softmax(gate_vals, dim=-1)
    all_out = _expert_act(cfg, xf.expand((cfg.n_experts,) + xf.shape), p)
    rows = torch.arange(xf.shape[0], device=x.device)
    y = torch.zeros_like(xf)
    for j in range(cfg.experts_per_token):
        sel = all_out[gate_idx[:, j], rows]                    # [T, d]
        y = y + weights[:, j:j + 1].to(xf.dtype) * sel
    if cfg.n_shared_experts:
        y = y + _shared(p, cfg, xf)
    return y.reshape(b, s, d)
