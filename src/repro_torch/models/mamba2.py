"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) mixer: the port of
``repro.models.mamba2``.

Training and prefill use the chunked SSD algorithm: within a chunk the
recurrence is a masked quadratic form, and the states pass between chunks
in a short loop over the chunks. Decode carries the ``[B, nh, hd,
dstate]`` recurrent state plus a causal-conv window, O(1) per token, and
updates both in place (as the attention caches are).

The reference's multi-operand einsums become explicit batched matmuls
whose intermediates stay at the size of their operands: the largest
tensor is one ``[B, nc, nh, Q, Q]`` f32 decay matrix per layer.
:func:`ssd_reference` is the sequential oracle of the tests.

Under tensor parallelism (the heads split over "model") a rank computes
its heads: its columns of z, x and dt, all of B and C (shared by every
head), its channels of the conv, the gated norm (its sum of squares
summed over the ring) and its rows of ``out_proj`` (one ``sum_over``).
``in_proj``'s columns concatenate z, x, B, C and dt, so a block of them
is no block of each part: the rank gathers the layer's whole ``in_proj``
and conv weights over the ring and takes its columns of each part (their
gradients summed over the ring into its block). The conv state is held as
the rules split it, a block of the x|B|C columns: a decode step gathers
the window and writes its block of the next one back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.lattice import torch_dtype
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as nn


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state   # x, B, C share the conv
    return d_inner, nheads, conv_dim


def init_mamba2(gen, cfg, device, lead=()) -> dict:
    d = cfg.d_model
    d_inner, nheads, conv_dim = dims(cfg)
    dt = torch_dtype(cfg.dtype)
    f32 = torch.float32
    d_in_proj = 2 * d_inner + 2 * cfg.ssm_state + nheads  # z, x, B, C, dt
    return {
        "in_proj": nn.dense_init(gen, (d, d_in_proj), dt, device, lead=lead),
        "conv_w": nn.dense_init(gen, (cfg.conv_width, conv_dim), dt, device,
                                lead=lead),
        "conv_b": nn._zeros((conv_dim,), dt, device, lead),
        "a_log": nn._zeros((nheads,), f32, device, lead),
        "d_skip": nn._ones((nheads,), f32, device, lead),
        "dt_bias": nn._zeros((nheads,), f32, device, lead),
        "norm": nn._ones((d_inner,), dt, device, lead),
        "out_proj": nn.dense_init(gen, (d_inner, d), dt, device, lead=lead),
    }


def mamba2_specs(cfg) -> dict:
    return {
        "in_proj": ("embed", "ssm_inner"),
        "conv_w": (None, "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "a_log": ("ssm_heads",),
        "d_skip": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "norm": ("ssm_inner",),
        "out_proj": ("ssm_inner", "embed"),
    }


def _split_proj(cfg, zxbcdt, d_inner=None):
    """(z, x, B, C, dt) of the projection; ``d_inner`` the channels of z
    and x it holds (default all)."""
    d_inner = d_inner or dims(cfg)[0]
    ns = cfg.ssm_state
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner:2 * d_inner]
    b = zxbcdt[..., 2 * d_inner:2 * d_inner + ns]
    c = zxbcdt[..., 2 * d_inner + ns:2 * d_inner + 2 * ns]
    dt = zxbcdt[..., 2 * d_inner + 2 * ns:]
    return z, x, b, c, dt


def conv_tail(raw: torch.Tensor, w: int) -> torch.Tensor:
    """Last ``w`` pre-conv inputs (a copy), zero-padded at the front if
    s < w."""
    s = raw.shape[1]
    if s >= w:
        return raw[:, -w:].clone()
    return F.pad(raw, (0, 0, w - s, 0))


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over [B, S, C] with kernel [W, C], then silu;
    the taps summed in the reference's order."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out + bias)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive sum along the last axis in f32 adds, in XLA:CPU's order
    for ``jnp.cumsum``: sequential within blocks of 16, each block's
    exclusive prefix (the block totals summed the same way) added after.
    The same on the card and the CPU (``torch.cumsum`` accumulates in f64
    on the CPU and scans in parallel on the card, and the chunk's decays
    exp(cs_i - cs_j) carry the difference of the orders to the logits)."""
    n = x.shape[-1]
    if n <= 16:
        outs = [x[..., 0]]
        for i in range(1, n):
            outs.append(outs[-1] + x[..., i])
        return torch.stack(outs, -1)
    blocks = F.pad(x, (0, (-n) % 16)).unflatten(-1, (-1, 16))
    inner = cumsum(blocks)
    prefix = F.pad(cumsum(inner[..., -1])[..., :-1], (1, 0))
    return (inner + prefix[..., None]).flatten(-2)[..., :n]


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise sums: out[..., i, j] = sum_{j<k<=i} dA[k]."""
    return _segsum_of(cumsum(dA))


def _segsum_of(cs: torch.Tensor) -> torch.Tensor:
    """:func:`_segsum` from the cumulative sums."""
    q = cs.shape[-1]
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=cs.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, a, b, c, chunk: int, h0=None):
    """SSD forward.

    x: [B, S, nh, hd]; dt: [B, S, nh] (post-softplus); a: [nh] (negative);
    b, c: [B, S, ns]. Returns (y [B, S, nh, hd] f32, h_final
    [B, nh, hd, ns] f32).
    """
    bsz, s, nh, hd = x.shape
    ns = b.shape[-1]
    pad = (-s) % chunk
    if pad:  # zero-pad the tail: dt=0 steps leave h untouched (decay=1, b=0)
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    s_pad = s + pad
    nc = s_pad // chunk
    f32 = torch.float32

    xr = x.reshape(bsz, nc, chunk, nh, hd).to(f32)
    dtr = dt.reshape(bsz, nc, chunk, nh).to(f32)
    br = b.reshape(bsz, nc, chunk, ns).to(f32)
    cr = c.reshape(bsz, nc, chunk, ns).to(f32)

    dAh = (dtr * a).transpose(2, 3)                  # [B, nc, nh, Q]
    cum = cumsum(dAh)
    # within-chunk quadratic (diagonal) term:
    # einsum("bnhqt,bnth,bnthd->bnqhd", C.B * L, dt, x)
    lmat = torch.exp(_segsum_of(cum))                # [B, nc, nh, Q, Q]
    cb = cr @ br.transpose(-1, -2)                   # [B, nc, Q, Q]
    scores = cb[:, :, None] * lmat
    xdt = (xr * dtr[..., None]).transpose(2, 3)      # [B, nc, nh, Q, hd]
    y_diag = (scores @ xdt).transpose(2, 3)          # [B, nc, Q, nh, hd]

    # chunk states: S_n = sum_t exp(cum_end - cum_t) dt_t x_t B_t^T
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    xw = xr * (decay_to_end.transpose(2, 3) * dtr)[..., None]
    states = (xw.reshape(bsz, nc, chunk, nh * hd).transpose(-1, -2)
              @ br).reshape(bsz, nc, nh, hd, ns)

    # inter-chunk recurrence (the reference's lax.scan over chunks)
    chunk_decay = torch.exp(cum[..., -1])[..., None, None]   # [B, nc, nh, 1, 1]
    h = (torch.zeros((bsz, nh, hd, ns), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    h_prevs = []
    for n in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, n] + states[:, n]
    h_prev = torch.stack(h_prevs, 1)                 # [B, nc, nh, hd, ns]

    # cross-chunk (off-diagonal) term: y_t += exp(cum_t) C_t . h_prev
    hp = h_prev.permute(0, 1, 4, 2, 3).reshape(bsz, nc, ns, nh * hd)
    y_off = ((cr @ hp).reshape(bsz, nc, chunk, nh, hd)
             * torch.exp(cum).transpose(2, 3)[..., None])
    y = (y_diag + y_off).reshape(bsz, s_pad, nh, hd)[:, :s]
    return y, h


def ssd_reference(x, dt, a, b, c, h0=None):
    """Sequential recurrence oracle (tests): h_t = h*exp(dt a) + dt x B."""
    bsz, s, nh, hd = x.shape
    ns = b.shape[-1]
    f32 = torch.float32
    h = (torch.zeros((bsz, nh, hd, ns), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    ys = []
    for t in range(s):
        dtt = dt[:, t].to(f32)                           # [B, nh]
        decay = torch.exp(dtt * a)
        upd = _outer(dtt, x[:, t].to(f32), b[:, t].to(f32))
        h = h * decay[..., None, None] + upd
        ys.append(h @ c[:, t].to(f32)[:, None, :, None])
    return torch.stack(ys, dim=1)[..., 0], h


def _outer(dt, x, b):
    """einsum("bh,bhd,bs->bhds", dt, x, b)."""
    return (dt[..., None] * x)[..., None] * b[:, None, None, :]


class _Share:
    """How this rank computes a mixer: ``p`` the weights it computes with,
    ``d_inner`` / ``nheads`` its channels and heads. ``grid`` None: the
    whole heads (one rank, or heads that do not divide the model axis:
    then any block is gathered and every rank computes alike); else its
    heads ``[h_lo, h_lo + nheads)`` over "model" (see the module's
    docstring). ``conv_grid``: the conv state is this rank's block of the
    x|B|C columns, from ``conv_lo``."""

    def __init__(self, p, cfg):
        d_inner, nh, conv_dim = dims(cfg)
        ns, hd = cfg.ssm_state, cfg.ssm_head_dim
        self.full_inner, self.ns = d_inner, ns
        self.grid, self.d_inner, self.nheads = None, d_inner, nh
        blk = SH.model_block(p["conv_w"].shape[-1], conv_dim)
        self.conv_grid, self.conv_lo = blk or (None, 0)
        total = {"in_proj": (1, 2 * d_inner + 2 * ns + nh),
                 "conv_w": (1, conv_dim), "conv_b": (0, conv_dim),
                 "norm": (0, d_inner), "out_proj": (0, d_inner)}
        q = dict(p)
        blk = SH.model_block(p["a_log"].shape[-1], nh)
        if blk is None:
            for name, (dim, n) in total.items():
                b = SH.model_block(q[name].shape[dim], n)
                if b is not None:
                    q[name] = SH.gather_block(q[name], b[0], "model", dim,
                                              summed=False)
            self.p = q
            return
        self.grid, h_lo = blk
        self.nheads = p["a_log"].shape[-1]
        self.d_inner = di = self.nheads * hd
        self.x_lo = x0 = h_lo * hd

        def whole(name):
            dim, n = total[name]
            if SH.model_block(q[name].shape[dim], n) is None:
                return SH.replicated_over(q[name], self.grid, "model")
            return SH.gather_block(q[name], self.grid, "model", dim)

        w = whole("in_proj")
        dt0 = 2 * d_inner + 2 * ns + h_lo
        q["in_proj"] = torch.cat(
            [w[:, x0:x0 + di], w[:, d_inner + x0:d_inner + x0 + di],
             w[:, 2 * d_inner:2 * d_inner + 2 * ns],
             w[:, dt0:dt0 + self.nheads]], -1)
        for name in ("conv_w", "conv_b"):
            q[name] = self.own_columns(whole(name))
        self.p = q

    def own_columns(self, t):
        """This rank's x channels and all of B and C of x|B|C columns."""
        if self.grid is None:
            return t
        x0, d0 = self.x_lo, self.full_inner
        return torch.cat([t[..., x0:x0 + self.d_inner], t[..., d0:]], -1)

    def enter(self, x):
        return x if self.grid is None else SH.replicated_over(x, self.grid,
                                                              "model")

    def out(self, y):
        return y if self.grid is None else SH.sum_over(y, self.grid,
                                                       "model")

    def norm(self, y, scale, eps):
        """The gated RMS norm over all ``d_inner`` channels."""
        if self.grid is None:
            return nn.rms_norm(y, scale, eps)
        xf = y.float()
        ss = SH.reduce_over((xf * xf).sum(-1, keepdim=True), self.grid,
                            "model")
        out = xf * torch.rsqrt(ss / self.full_inner + eps) * scale.float()
        return out.to(y.dtype)

    def whole_raw(self, raw):
        """x|B|C pre-conv columns of every channel from this rank's."""
        if self.grid is None:
            return raw
        di = self.d_inner
        x = self.grid.all_gather(raw[..., :di], "model", raw.dim() - 1)
        return torch.cat([x, raw[..., di:]], -1)

    def stored(self, window):
        """A whole conv window as the state holds it."""
        if self.conv_grid is None:
            return window
        n = window.shape[-1] // self.conv_grid.axis_size("model")
        return window[..., self.conv_lo:self.conv_lo + n]

    def whole_state(self, conv):
        """The whole conv window of the state's block."""
        if self.conv_grid is None:
            return conv
        return self.conv_grid.all_gather(conv, "model", conv.dim() - 1)


def _mixer(p: dict, cfg, xin: torch.Tensor):
    """The full mixer over [B, S, d]: (y [B, S, d], the raw pre-conv
    x|B|C inputs, the final SSM state, the rank's share), the latter of
    this rank's channels and heads."""
    sh = _Share(p, cfg)
    p, d_inner, nheads = sh.p, sh.d_inner, sh.nheads
    ns = cfg.ssm_state
    z, x, b, c, dt = _split_proj(cfg, sh.enter(xin) @ p["in_proj"], d_inner)
    xbc_raw = torch.cat([x, b, c], -1)
    xbc = causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    x, b, c = (xbc[..., :d_inner], xbc[..., d_inner:d_inner + ns],
               xbc[..., d_inner + ns:])
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    bsz, s = xin.shape[:2]
    xh = x.reshape(bsz, s, nheads, cfg.ssm_head_dim)
    y, h_final = ssd_chunked(xh, dt, a, b, c, min(cfg.ssm_chunk, s))
    y = y + p["d_skip"][:, None] * xh.float()
    y = y.reshape(bsz, s, d_inner).to(xin.dtype)
    y = sh.norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return sh.out(y @ p["out_proj"]), xbc_raw, h_final, sh


def mamba2_forward(p: dict, cfg, xin: torch.Tensor) -> torch.Tensor:
    """Full mixer over [B, S, d] (train / prefill)."""
    return _mixer(p, cfg, xin)[0]


def mamba2_prefill(p: dict, cfg, xin: torch.Tensor):
    """The mixer that also returns the final (conv, ssm) state, each as
    the rules place it."""
    y, xbc_raw, h_final, sh = _mixer(p, cfg, xin)
    tail = sh.whole_raw(conv_tail(xbc_raw, cfg.conv_width - 1))
    return y, {"conv": sh.stored(tail).contiguous(), "ssm": h_final}


def init_mamba2_state(cfg, batch: int, device="cpu") -> dict:
    _, nheads, conv_dim = dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=torch_dtype(cfg.dtype), device=device),
        "ssm": torch.zeros((batch, nheads, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def mamba2_state_specs(cfg) -> dict:
    return {"conv": ("batch", None, "ssm_inner"),
            "ssm": ("batch", "ssm_heads", None, "state")}


def conv_step(state_conv, new, w, bias):
    """One causal-conv step: (silu(window . w + bias), the next window).
    The window is the last W-1 raw inputs and ``new`` [B, C]; the taps
    are summed in f32 and rounded once, as XLA's einsum."""
    window = torch.cat([state_conv, new[:, None]], 1)           # [B, W, C]
    out = (window.float() * w.float()).sum(1).to(new.dtype)
    return F.silu(out + bias), window[:, 1:]


def mamba2_decode(p: dict, cfg, state: dict, xin: torch.Tensor):
    """Single-token step. xin: [B, 1, d]. Returns (y [B, 1, d], state),
    the state's ``conv`` and ``ssm`` updated in place."""
    sh = _Share(p, cfg)
    p, d_inner, nheads = sh.p, sh.d_inner, sh.nheads
    ns = cfg.ssm_state
    z, x, b, c, dt = _split_proj(cfg, xin[:, 0] @ p["in_proj"], d_inner)
    raw = torch.cat([x, b, c], -1)
    whole = sh.whole_state(state["conv"])
    conv_out, window = conv_step(sh.own_columns(whole), raw, p["conv_w"],
                                 p["conv_b"])
    if sh.grid is not None or sh.conv_grid is not None:
        window = sh.stored(torch.cat([whole[:, 1:],
                                      sh.whole_raw(raw)[:, None]], 1))
    x, b, c = (conv_out[..., :d_inner], conv_out[..., d_inner:d_inner + ns],
               conv_out[..., d_inner + ns:])
    dt = F.softplus(dt.float() + p["dt_bias"])                  # [B, nh]
    a = -torch.exp(p["a_log"])
    xt = x.reshape(-1, nheads, cfg.ssm_head_dim).float()
    h = (state["ssm"] * torch.exp(dt * a)[..., None, None]
         + _outer(dt, xt, b.float()))
    y = (h @ c.float()[:, None, :, None])[..., 0]                # [B, nh, hd]
    y = y + p["d_skip"][:, None] * xt
    y = y.reshape(-1, 1, d_inner).to(xin.dtype)
    y = sh.norm(y * F.silu(z[:, None]), p["norm"], cfg.norm_eps)
    state["conv"].copy_(window)
    state["ssm"].copy_(h)
    return sh.out(y @ p["out_proj"]), state
