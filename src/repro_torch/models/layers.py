"""Building blocks of the decoder LM: norms, rotary embeddings, GQA
attention (flash-style chunked softmax), sliding-window attention, KV
caches, MLPs, embeddings.

The port of ``repro.models.layers``. Parameters are plain trees (nested
dicts of tensors) with the reference's names and shapes; every ``init_*``
takes an explicit ``torch.Generator`` and device and draws the same
distributions as the reference (not the same numbers). Beside each
``init_*`` a ``*_specs(cfg)`` gives the reference's logical-axis tree for
the same parameters (``distributed.sharding`` resolves it to placements).

Under tensor parallelism (``distributed.sharding.tp_grid``) a layer is
given this rank's blocks of its weights along "model" and computes its
share, as GSPMD partitions the reference: the attention its heads, the
MLP its ffn columns, the embeddings their vocab rows. Each block's shape
is its local count (``sharding.model_block``); the input enters through
``sharding.replicated_over`` (its gradient summed over the ring) and a
row-parallel output leaves through one ``sharding.sum_over``.

Products whose operands are bf16 but whose result the reference takes in
f32 (``preferred_element_type=jnp.float32``: the attention scores and
P @ V) go through :func:`matmul_f32`: on the card a bf16-in, f32-out
GEMM (``torch.bmm(..., out_dtype=torch.float32)``), on the CPU an f32
product of the widened operands. Both are exact per product and
accumulate in f32; neither rounds the scores to bf16.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.core.lattice import torch_dtype
from repro_torch.distributed import sharding as SH

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _normal(gen, shape, dtype, scale, device):
    """N(0, scale^2) drawn in f32, scaled in place (one f32 temporary),
    then cast (the reference's ``_normal``)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def dense_init(gen, shape, dtype, device, in_axes=(0,), lead=()):
    """Fan-in init of a ``shape`` weight; ``lead`` prepends stacked axes
    (the layer axis) that do not count towards the fan-in."""
    fan_in = math.prod(shape[a] for a in in_axes)
    return _normal(gen, tuple(lead) + tuple(shape), dtype,
                   1.0 / math.sqrt(fan_in), device)


def _ones(shape, dtype, device, lead=()):
    return torch.ones(tuple(lead) + tuple(shape), dtype=dtype, device=device)


def _zeros(shape, dtype, device, lead=()):
    return torch.zeros(tuple(lead) + tuple(shape), dtype=dtype,
                       device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (standard + multimodal M-RoPE)
# ---------------------------------------------------------------------------


def _inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a tensor base: CUDA's pow of a Python-number base is not the CPU's
    # f32 pow, and the card's rope angles would drift from the CPU's
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple = ()) -> tuple:
    """cos/sin tables [..., head_dim/2].

    positions: [...]. For M-RoPE, positions is [..., 3] (temporal, h, w)
    and ``sections`` splits head_dim/2 across the three channels (text
    tokens carry the same coordinate in all three, which reduces M-RoPE to
    standard RoPE).
    """
    inv = _inv_freq(head_dim, theta, positions.device)
    if sections:
        if positions.shape[-1] != len(sections):
            raise ValueError(f"positions [..., {positions.shape[-1]}] do not "
                             f"match M-RoPE sections {sections}")
        parts, start = [], 0
        for ch, sec in enumerate(sections):
            parts.append(positions[..., ch, None].float()
                         * inv[start:start + sec])
            start += sec
        angles = torch.cat(parts, dim=-1)
    else:
        angles = positions[..., None].float() * inv
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, hd]; cos/sin: [B, S, hd/2] (broadcast over heads)."""
    half = x.shape[-1] // 2
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention — flash-style chunked GQA (never materializes [S, S])
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in f32 for operands of any float dtype: [..., m, k] @
    [..., k, n] with equal leading dims. bf16/f16 operands on the card go
    through one bf16-in, f32-out batched GEMM (on ``meta`` too, so that a
    dry-run counts the card's program); elsewhere the operands are
    widened to f32 (exact) first."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if (a.is_cuda or a.is_meta) and a.dtype == b.dtype:
        lead = a.shape[:-2]
        out = torch.bmm(a.reshape((-1,) + a.shape[-2:]),
                        b.reshape((-1,) + b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.view(lead + out.shape[-2:])
    return torch.matmul(a.float(), b.float())


def _chunk_mask(qi, ki, q_chunk: int, kv_chunk: int, causal: bool,
                window: int, device):
    """[q_chunk, kv_chunk] keep-mask of one chunk pair, or None (all kept)."""
    if not causal and not window:
        return None
    qpos = qi * q_chunk + torch.arange(q_chunk, device=device)
    kpos = ki * kv_chunk + torch.arange(kv_chunk, device=device)
    ok = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window:
        ok &= qpos[:, None] - kpos[None, :] < window
    return ok


def _chunk_live(qi, ki, q_chunk: int, kv_chunk: int, causal: bool,
                window: int) -> bool:
    """False iff the (qi, ki) chunk pair is fully masked: causal attention
    skips about half of all pairs, a window every pair outside it."""
    live = True
    if causal:
        live &= ki * kv_chunk <= qi * q_chunk + (q_chunk - 1)
    if window:
        live &= (ki + 1) * kv_chunk - 1 > qi * q_chunk - window
    return live


class _Chunks:
    """The operands of one attention call in chunk-friendly layouts.

    q [B, S, H, hd] becomes [B*KV, S*G, hd] (rows in (position, group)
    order, so a q chunk is a contiguous run of rows and the G query heads
    of one KV head share its keys without a broadcast); k and v become
    [B*KV, T, hd].
    """

    def __init__(self, q, k, q_chunk: int, kv_chunk: int):
        b, s, h, hd = q.shape
        t, kv = k.shape[1], k.shape[2]
        self.b, self.s, self.h, self.hd, self.t, self.kv = b, s, h, hd, t, kv
        self.g = h // kv
        self.qc, self.kc = q_chunk, kv_chunk
        self.nq, self.nk = s // q_chunk, t // kv_chunk
        self.scale = 1.0 / math.sqrt(hd)

    def q_rows(self, x):
        """[B, S, H, hd] -> [B*KV, S*G, hd] (a copy)."""
        b, s, kv, g, hd = self.b, self.s, self.kv, self.g, self.hd
        return (x.reshape(b, s, kv, g, hd).permute(0, 2, 1, 3, 4)
                .reshape(b * kv, s * g, hd))

    def q_unrows(self, x):
        """[B*KV, S*G, hd] -> [B, S, H, hd]."""
        b, s, kv, g, hd = self.b, self.s, self.kv, self.g, self.hd
        return (x.reshape(b, kv, s, g, hd).permute(0, 2, 1, 3, 4)
                .reshape(b, s, self.h, hd))

    def kv_rows(self, x):
        """[B, T, KV, hd] -> [B*KV, T, hd] (a copy)."""
        return x.permute(0, 2, 1, 3).reshape(self.b * self.kv, self.t,
                                             self.hd)

    def kv_unrows(self, x):
        return x.reshape(self.b, self.kv, self.t, self.hd).permute(0, 2, 1, 3)

    def qs(self, qi):
        """Row slice of q chunk ``qi``."""
        return slice(qi * self.qc * self.g, (qi + 1) * self.qc * self.g)

    def ks(self, ki):
        return slice(ki * self.kc, (ki + 1) * self.kc)

    def live(self, qi, ki, causal, window) -> bool:
        return _chunk_live(qi, ki, self.qc, self.kc, causal, window)

    def scores(self, qb, kb, qi, ki, causal, window):
        """Masked f32 scores [B*KV, qc*G, kc] of one chunk pair."""
        sc = matmul_f32(qb, kb.transpose(-1, -2)) * self.scale
        ok = _chunk_mask(qi, ki, self.qc, self.kc, causal, window, qb.device)
        if ok is None:
            return sc
        ok = ok[:, None, :].expand(self.qc, self.g, self.kc).reshape(
            self.qc * self.g, self.kc)
        return torch.where(ok, sc, NEG_INF)


def _flash_fwd_impl(q, k, v, causal: bool, window: int, q_chunk: int,
                    kv_chunk: int):
    """Streaming softmax forward. Returns (out [B, S, H, hd], lse
    [B*KV, S*G] log-sum-exp rows for the backward)."""
    c = _Chunks(q, k, q_chunk, kv_chunk)
    qr, kr, vr = c.q_rows(q), c.kv_rows(k), c.kv_rows(v)
    rows = c.qc * c.g
    out = torch.empty_like(qr)
    lse = torch.empty(qr.shape[:2], dtype=torch.float32, device=q.device)
    for qi in range(c.nq):
        qb = qr[:, c.qs(qi)]
        m = torch.full((qr.shape[0], rows), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l_ = torch.zeros_like(m)
        o = torch.zeros((qr.shape[0], rows, c.hd), dtype=torch.float32,
                        device=q.device)
        for ki in range(c.nk):
            if not c.live(qi, ki, causal, window):
                continue
            sc = c.scores(qb, kr[:, c.ks(ki)], qi, ki, causal, window)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_ = l_ * corr + p.sum(-1)
            vb = vr[:, c.ks(ki)]
            o = o * corr[..., None] + matmul_f32(p.to(vb.dtype), vb)
            m = m_new
        l_safe = torch.clamp_min(l_, 1e-30)
        out[:, c.qs(qi)] = (o / l_safe[..., None]).to(q.dtype)
        lse[:, c.qs(qi)] = m + torch.log(l_safe)
    return c.q_unrows(out), lse


def _flash_bwd_impl(q, k, v, out, lse, do, causal: bool, window: int,
                    q_chunk: int, kv_chunk: int):
    """FlashAttention-2-style backward: the scores of each live chunk pair
    are recomputed from the saved LSE, so nothing quadratic is kept. The
    reference's two passes (dq over q chunks, dk/dv over kv chunks) become
    one loop over the live pairs, q chunks outer: each pair's
    probabilities are recomputed once, and every accumulator still sums
    its chunks in the reference's order."""
    c = _Chunks(q, k, q_chunk, kv_chunk)
    qr, kr, vr = c.q_rows(q), c.kv_rows(k), c.kv_rows(v)
    dor = c.q_rows(do).float()
    # D_i = rowsum(do * o)
    dmat = (dor * c.q_rows(out).float()).sum(-1)
    qf, kf, vf = qr.float(), kr.float(), vr.float()
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for qi in range(c.nq):
        qs = c.qs(qi)
        for ki in range(c.nk):
            if not c.live(qi, ki, causal, window):
                continue
            ks = c.ks(ki)
            sc = c.scores(qr[:, qs], kr[:, ks], qi, ki, causal, window)
            p = torch.exp(sc - lse[:, qs, None])          # [BKV, qc*G, kc]
            dob = dor[:, qs]
            dp = torch.matmul(dob, vf[:, ks].transpose(-1, -2))
            ds = p * (dp - dmat[:, qs, None]) * c.scale
            dq[:, qs] += torch.matmul(ds, kf[:, ks])
            dv[:, ks] += torch.matmul(p.transpose(-1, -2), dob)
            dk[:, ks] += torch.matmul(ds.transpose(-1, -2), qf[:, qs])
    return (c.q_unrows(dq.to(q.dtype)), c.kv_unrows(dk.to(k.dtype)),
            c.kv_unrows(dv.to(v.dtype)))


class _Flash(torch.autograd.Function):
    """Flash attention with the reference's custom VJP: saves
    ``(q, k, v, out, lse)`` and recomputes the scores in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk):
        out, lse = _flash_fwd_impl(q, k, v, causal, window, q_chunk,
                                   kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, do.contiguous(),
                                     *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_chunk: int = 1024,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention with a flash-style backward.

    q: [B, S, H, hd]; k, v: [B, T, KV, hd]; H % KV == 0. Returns
    [B, S, H, hd]. window > 0 limits attention to the trailing ``window``
    keys ('l' layers).
    """
    s, t = q.shape[1], k.shape[1]
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, t)
    if s % q_chunk or t % kv_chunk:
        raise ValueError(f"chunks ({q_chunk}, {kv_chunk}) do not tile the "
                         f"sequence lengths ({s}, {t})")
    return _Flash.apply(q, k, v, causal, window, q_chunk, kv_chunk)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *, window: int = 0,
                     layout: str = "btkh") -> torch.Tensor:
    """Single-token attention against a cache.

    q: [B, 1, H, hd]; caches: [B, T, KV, hd] ("btkh") or [B, KV, T, hd]
    ("bkth"). pos: index of the new token. For window > 0 the cache is a
    ring buffer of size ``window`` and validity is derived from pos.
    """
    b, _, h, hd = q.shape
    if layout == "btkh":   # -> [B, KV, T, hd] views
        k_cache, v_cache = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    kv, t = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    qr = q.reshape(b, kv, g, hd)
    sc = matmul_f32(qr, k_cache.transpose(-1, -2)) / math.sqrt(hd)
    idx = torch.arange(t, device=q.device)
    valid = idx < min(pos + 1, t) if window else idx <= pos
    sc = torch.where(valid, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = matmul_f32(p.to(v_cache.dtype), v_cache)
    return o.reshape(b, 1, h, hd).to(q.dtype)


def cache_update(cache: torch.Tensor, new: torch.Tensor, pos: int,
                 window: int = 0, layout: str = "btkh") -> torch.Tensor:
    """Write [B, 1, KV, hd] into the cache at pos (mod window if a ring),
    in place; returns the cache."""
    slot = pos % window if window else pos
    if layout == "bkth":
        cache[:, :, slot] = new[:, 0].to(cache.dtype)
    else:
        cache[:, slot] = new[:, 0].to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# attention block (params + apply)
# ---------------------------------------------------------------------------


def init_attention(gen, cfg, device, lead=()) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    dt = torch_dtype(cfg.dtype)
    params = {
        "wq": dense_init(gen, (d, h, hd), dt, device, lead=lead),
        "wk": dense_init(gen, (d, kvh, hd), dt, device, lead=lead),
        "wv": dense_init(gen, (d, kvh, hd), dt, device, lead=lead),
        "wo": dense_init(gen, (h, hd, d), dt, device, in_axes=(0, 1),
                         lead=lead),
    }
    if cfg.qk_norm:
        params["q_norm"] = _ones((hd,), dt, device, lead)
        params["k_norm"] = _ones((hd,), dt, device, lead)
    if cfg.attn_bias:
        params["bq"] = _zeros((h, hd), dt, device, lead)
        params["bk"] = _zeros((kvh, hd), dt, device, lead)
        params["bv"] = _zeros((kvh, hd), dt, device, lead)
    return params


def attention_specs(cfg) -> dict:
    specs = {
        "wq": ("embed", "heads", "head"),
        "wk": ("embed", "kv_heads", "head"),
        "wv": ("embed", "kv_heads", "head"),
        "wo": ("heads", "head", "embed"),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ("head",)
        specs["k_norm"] = ("head",)
    if cfg.attn_bias:
        specs["bq"] = ("heads", "head")
        specs["bk"] = ("kv_heads", "head")
        specs["bv"] = ("kv_heads", "head")
    return specs


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _out(o, w):
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = w.shape
    return o.flatten(-2) @ w.reshape(h * k, d)


class _AttnShare:
    """How this rank computes an attention layer. ``grid`` None: whole
    heads (one rank, heads that do not divide the model axis, or a
    fallback), the layer's own weights. Else the rank's q heads
    ``[h_lo, h_lo + h)`` over "model" and ``p`` the weights it computes
    with: wq, bq and wo its heads; wk, wv, bk and bv its kv heads, or,
    when the kv heads are whole (they do not divide the axis: GQA with
    more ranks than kv heads), the one kv head its q heads read
    (``h_lo // G``, shared by ``spread`` ranks), cut from the whole
    weights; weights the ring holds whole enter through ``replicated_over``
    (their gradients summed over the ring)."""

    def __init__(self, p, cfg):
        self.p, self.grid, self.spread = p, None, 0
        h = p["wq"].shape[-2]
        blk = SH.model_block(h, cfg.n_heads)
        if blk is None:
            return
        grid, self.h_lo = blk
        g = cfg.n_heads // cfg.n_kv_heads
        if SH.model_block(p["wk"].shape[-2], cfg.n_kv_heads) is None:
            if g % h:
                # this rank's q heads read kv heads unevenly: the whole
                # heads, computed alike on every rank of the ring
                self.p = {k: (SH.gather_block(w, grid, "model", w.dim() - 3
                                              if k == "wo" else w.dim() - 2,
                                              summed=False)
                              if k in ("wq", "bq", "wo") else w)
                          for k, w in p.items()}
                return
            self.spread = g // h
        self.grid = grid
        out = dict(p)
        for name in ("wk", "wv", "bk", "bv", "q_norm", "k_norm"):
            if name not in p:
                continue
            if self.spread or name in ("q_norm", "k_norm"):
                out[name] = SH.replicated_over(p[name], grid, "model")
            if self.spread and name[0] in "wb":
                out[name] = out[name].narrow(-2, self.h_lo // g, 1)
        self.p = out

    def enter(self, x):
        """The layer's input as this rank computes with it."""
        return x if self.grid is None else SH.replicated_over(x, self.grid,
                                                              "model")

    def out(self, o):
        """The output projection of this rank's heads, summed over the
        ring."""
        y = _out(o, self.p["wo"])
        return y if self.grid is None else SH.sum_over(y, self.grid,
                                                       "model")

    def whole_kv(self, t, dim: int):
        """The whole kv heads of a [..., 1 kv head, ...] piece along
        ``dim`` (kv heads cut from whole weights): the ring's pieces
        gathered, one of each ``spread`` ranks that share a head."""
        if not self.spread:
            return t
        gathered = self.grid.all_gather(t, "model", dim)
        idx = torch.arange(0, gathered.shape[dim], self.spread,
                           device=t.device)
        return gathered.index_select(dim, idx)

    def own_kv(self, cache, dim: int, cfg):
        """The kv heads of a whole cache this rank's q heads read."""
        if not self.spread:
            return cache
        g = cfg.n_heads // cfg.n_kv_heads
        return cache.narrow(dim, self.h_lo // g, 1)


def _qkv(p, cfg, x, cos, sin):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.attn_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_style != "none":
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def attention_forward(p: dict, cfg, x: torch.Tensor, cos, sin,
                      window: int = 0) -> torch.Tensor:
    """Training/prefill attention over [B, S, d]."""
    share = _AttnShare(p, cfg)
    q, k, v = _qkv(share.p, cfg, share.enter(x), cos, sin)
    o = flash_attention(q, k, v, causal=True, window=window)
    return share.out(o)


def attention_prefill(p: dict, cfg, x: torch.Tensor, cos, sin,
                      window: int = 0, max_len: int = 0):
    """Like forward but also returns a decode-ready cache.

    Non-windowed: the cache is zero-padded out to ``max_len`` so decode can
    append at pos >= s (validity masking hides the padding). Windowed: the
    cache is the last ``window`` keys ROLLED so token p sits at ring slot
    p % window, the slot decode's ``pos % window`` writes rely on.
    """
    s = x.shape[1]
    share = _AttnShare(p, cfg)
    q, k, v = _qkv(share.p, cfg, share.enter(x), cos, sin)
    o = flash_attention(q, k, v, causal=True, window=window)
    k, v = share.whole_kv(k, 2), share.whole_kv(v, 2)
    if window:
        if s >= window:
            shift = s % window      # roll right: slot of the oldest kept key
            k = torch.roll(k[:, -window:], shift, dims=1)
            v = torch.roll(v[:, -window:], shift, dims=1)
        else:  # partial ring: token p already at slot p; pad to window
            k = F.pad(k, (0, 0, 0, 0, 0, window - s))
            v = F.pad(v, (0, 0, 0, 0, 0, window - s))
    elif max_len and max_len > s:
        k = F.pad(k, (0, 0, 0, 0, 0, max_len - s))
        v = F.pad(v, (0, 0, 0, 0, 0, max_len - s))
    if cfg.cache_layout == "bkth":
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    return share.out(o), (k.contiguous(), v.contiguous())


def attention_decode(p: dict, cfg, x: torch.Tensor, cache: tuple, pos: int,
                     cos, sin, window: int = 0):
    """x: [B, 1, d]; cache: (k, v) in cfg.cache_layout, updated in place
    (this rank's kv heads, or all of them where the rules keep the cache
    whole). Returns (out, cache)."""
    share = _AttnShare(p, cfg)
    q, k_new, v_new = _qkv(share.p, cfg, share.enter(x), cos, sin)
    k_cache, v_cache = cache
    lay = cfg.cache_layout
    k_cache = cache_update(k_cache, share.whole_kv(k_new, 2), pos, window,
                           lay)
    v_cache = cache_update(v_cache, share.whole_kv(v_new, 2), pos, window,
                           lay)
    kv_dim = 1 if lay == "bkth" else 2
    o = decode_attention(q, share.own_kv(k_cache, kv_dim, cfg),
                         share.own_kv(v_cache, kv_dim, cfg), pos,
                         window=window, layout=lay)
    return share.out(o), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg, device, d_ff: int = 0, lead=()) -> dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    params = {"wi": dense_init(gen, (d, ff), dt, device, lead=lead),
              "wo": dense_init(gen, (ff, d), dt, device, lead=lead)}
    if cfg.activation in ("swiglu", "geglu"):
        params["wg"] = dense_init(gen, (d, ff), dt, device, lead=lead)
    return params


def mlp_specs(cfg) -> dict:
    specs = {"wi": ("embed", "ffn"), "wo": ("ffn", "embed")}
    if cfg.activation in ("swiglu", "geglu"):
        specs["wg"] = ("embed", "ffn")
    return specs


def mlp_forward(p: dict, cfg, x: torch.Tensor, d_ff: int = 0
                ) -> torch.Tensor:
    """The MLP of ``d_ff`` (default ``cfg.d_ff``) columns; wi and wg
    column-parallel, wo row-parallel when they are blocks over "model"."""
    act = cfg.activation
    blk = SH.model_block(p["wi"].shape[-1], d_ff or cfg.d_ff)
    grid = None if blk is None else blk[0]
    if grid is not None:
        x = SH.replicated_over(x, grid, "model")
    hi = x @ p["wi"]
    if act == "swiglu":
        h = F.silu(x @ p["wg"]) * hi
    elif act == "geglu":            # jax.nn.gelu's default is the tanh form
        h = F.gelu(x @ p["wg"], approximate="tanh") * hi
    elif act == "squared_relu":     # nemotron-4
        r = F.relu(hi)
        h = r * r
    elif act == "gelu":
        h = F.gelu(hi, approximate="tanh")
    else:
        raise ValueError(act)
    y = h @ p["wo"]
    return y if grid is None else SH.sum_over(y, grid, "model")


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


def init_embeddings(gen, cfg, device) -> dict:
    v, d = cfg.padded_vocab, cfg.d_model
    dt = torch_dtype(cfg.dtype)
    n_emb = max(cfg.n_codebooks, 1)
    return {"tok": _normal(gen, (n_emb, v, d), dt, 1.0, device),
            "out": dense_init(gen, (d, n_emb * v), dt, device),
            "ln_f": _ones((d,), dt, device)}


def embeddings_specs(cfg) -> dict:
    return {"tok": (None, "vocab", "embed"), "out": ("embed", "vocab"),
            "ln_f": ("embed",)}


def embed_tokens(p: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: [B, S] (or [B, S, n_codebooks] for audio). Returns
    [B, S, d]. ``F.embedding``, whose backward on the card sums each
    row's gradients in a fixed order (a resumed run repeats a straight
    one bitwise). With this rank's block of the vocab rows over "model",
    the ids outside it look up zeros and the ring's lookups are summed."""
    blk = SH.model_block(p["tok"].shape[1], cfg.padded_vocab)
    if blk is not None:
        grid, lo = blk
        n = p["tok"].shape[1]

        def lookup(ids, table):
            local = ids - lo
            inside = (local >= 0) & (local < n)
            e = F.embedding(torch.where(inside, local, 0), table)
            return torch.where(inside[..., None], e, 0)

        if cfg.n_codebooks:
            x = functools.reduce(torch.add, [
                lookup(tokens[..., i], p["tok"][i])
                for i in range(cfg.n_codebooks)])
        else:
            x = lookup(tokens, p["tok"][0])
        return SH.sum_over(x, grid, "model")
    if cfg.n_codebooks:
        # sum of per-codebook embeddings (MusicGen-style)
        embs = [F.embedding(tokens[..., i], p["tok"][i])
                for i in range(cfg.n_codebooks)]
        return functools.reduce(torch.add, embs)
    return F.embedding(tokens, p["tok"][0])


def unembed(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Returns logits [B, S, n_emb * padded_vocab] in f32 (the product in
    the model's dtype, then widened, as the reference); with this rank's
    block of ``out``'s columns over "model", that block of the logits."""
    blk = SH.model_block(p["out"].shape[1],
                         max(cfg.n_codebooks, 1) * cfg.padded_vocab)
    if blk is not None:
        x = SH.replicated_over(x, blk[0], "model")
    logits = (x @ p["out"]).float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
