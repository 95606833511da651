"""The decoder: one forward implementation over the per-layer ``pattern``
string, the port of ``repro.models.transformer`` for every layer kind:

  'a' global GQA attention, 'l' sliding-window attention,
  'r' RG-LRU recurrent block, 's' Mamba2 SSD mixer.

The channel mixer is a dense MLP or, with ``n_experts > 0``, a
token-dropping MoE (its aux loss is discarded, as the reference discards
it); 's' layers are self-contained (no ``ln2`` or channel mixer), as in
Mamba2. That covers all ten registered architectures: dense, moe, vlm (a
vision-embed stub and ``positions [B, S, 3]`` for M-RoPE), audio
(codebooks), hybrid and ssm.

Homogeneous patterns keep the reference's stacked layer parameters (a
leading ``[L, ...]`` axis on every leaf, where the reference runs
``lax.scan``) and loop over the layers; heterogeneous patterns, or
``scan_layers=False``, keep a list of per-layer trees. Decode states
follow the same layout: one dict of stacked ``[L, ...]`` leaves, or a list
of per-layer dicts (``k``/``v`` caches, ``conv``/``h`` or ``conv``/``ssm``
recurrent states). With ``cfg.remat`` each layer's forward is recomputed
in the backward (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint``.
"""
from __future__ import annotations

import torch
from torch import nn as tnn
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.core.lattice import torch_dtype
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import shard_hint
from repro_torch.models import layers as nn
from repro_torch.models import mamba2, moe, rglru

KINDS = ("a", "l", "r", "s")


def check_supported(cfg) -> None:
    """Raise :class:`ValueError` for a layer kind the decoder lacks."""
    for kind in sorted(set(cfg.pattern)):
        if kind not in KINDS:
            raise ValueError(f"unknown layer kind {kind!r}")


def stacked(cfg) -> bool:
    """Whether the layers' parameters are stacked [L, ...] (the
    reference's scan layout)."""
    return cfg.scan_layers and len(set(cfg.pattern)) == 1


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------


def init_layer(gen, cfg, kind: str, device, lead=()) -> dict:
    dt = torch_dtype(cfg.dtype)
    d = cfg.d_model
    params = {"ln1": nn._ones((d,), dt, device, lead)}
    if kind in ("a", "l"):
        params["attn"] = nn.init_attention(gen, cfg, device, lead)
    elif kind == "r":
        params["rec"] = rglru.init_rglru(gen, cfg, device, lead)
    elif kind == "s":
        params["ssm"] = mamba2.init_mamba2(gen, cfg, device, lead)
    else:
        raise ValueError(kind)
    if kind != "s":
        params["ln2"] = nn._ones((d,), dt, device, lead)
        if cfg.n_experts:
            params["moe"] = moe.init_moe(gen, cfg, device, lead)
        else:
            params["mlp"] = nn.init_mlp(gen, cfg, device, lead=lead)
    return params


def layer_specs(cfg, kind: str) -> dict:
    """The logical dims of :func:`init_layer`'s tree (no leading axis)."""
    specs = {"ln1": ("embed",)}
    if kind in ("a", "l"):
        specs["attn"] = nn.attention_specs(cfg)
    elif kind == "r":
        specs["rec"] = rglru.rglru_specs(cfg)
    elif kind == "s":
        specs["ssm"] = mamba2.mamba2_specs(cfg)
    else:
        raise ValueError(kind)
    if kind != "s":
        specs["ln2"] = ("embed",)
        if cfg.n_experts:
            specs["moe"] = moe.moe_specs(cfg)
        else:
            specs["mlp"] = nn.mlp_specs(cfg)
    return specs


def _stacked_dims(specs):
    """Every leaf's dims with the leading "layers" dim."""
    if isinstance(specs, dict):
        return {k: _stacked_dims(v) for k, v in specs.items()}
    return ("layers",) + tuple(specs)


def _window(cfg, kind: str) -> int:
    return cfg.window if kind == "l" else 0


def _channel_mix(p, cfg, x):
    """x + the MLP or MoE of ``rms_norm(x)`` (the aux loss discarded)."""
    h = nn.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        h, _ = moe.moe_forward(p["moe"], cfg, h)
    else:
        h = nn.mlp_forward(p["mlp"], cfg, h)
    return x + h


def apply_layer(p: dict, cfg, kind: str, x, cos, sin):
    """Full-sequence layer application (train / prefill)."""
    h = nn.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ("a", "l"):
        h = nn.attention_forward(p["attn"], cfg, h, cos, sin,
                                 _window(cfg, kind))
    elif kind == "r":
        h = rglru.rglru_forward(p["rec"], cfg, h)
    else:
        h = mamba2.mamba2_forward(p["ssm"], cfg, h)
    x = x + h
    x = x if kind == "s" else _channel_mix(p, cfg, x)
    return shard_hint(x, ("batch", "seq", "embed"))


def apply_layer_prefill(p, cfg, kind, x, cos, sin, max_len: int = 0):
    """Layer application that also returns the layer's decode state."""
    h = nn.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ("a", "l"):
        h, (k, v) = nn.attention_prefill(p["attn"], cfg, h, cos, sin,
                                         _window(cfg, kind), max_len)
        state = {"k": k, "v": v}
    elif kind == "r":
        # the decode window carries the RAW pre-conv inputs
        h, branch_raw, hs = rglru._block(p["rec"], cfg, h)
        state = {"conv": mamba2.conv_tail(branch_raw, cfg.conv_width - 1),
                 "h": hs[:, -1].clone()}
    else:
        h, state = mamba2.mamba2_prefill(p["ssm"], cfg, h)
    x = x + h
    x = x if kind == "s" else _channel_mix(p, cfg, x)
    return shard_hint(x, ("batch", "seq", "embed")), state


def apply_layer_decode(p, cfg, kind, state, x, pos, cos, sin):
    """Single-token layer step. x: [B, 1, d]; the state's tensors are
    updated in place."""
    h = nn.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ("a", "l"):
        h, (k, v) = nn.attention_decode(p["attn"], cfg, h,
                                        (state["k"], state["v"]), pos, cos,
                                        sin, _window(cfg, kind))
        state = {"k": k, "v": v}
    elif kind == "r":
        h, state = rglru.rglru_decode(p["rec"], cfg, state, h)
    else:
        h, state = mamba2.mamba2_decode(p["ssm"], cfg, state, h)
    x = x + h
    return (x if kind == "s" else _channel_mix(p, cfg, x)), state


def init_layer_state(cfg, kind: str, batch: int, max_len: int,
                     device="cpu") -> dict:
    if kind == "r":
        return rglru.init_rglru_state(cfg, batch, device)
    if kind == "s":
        return mamba2.init_mamba2_state(cfg, batch, device)
    if kind not in ("a", "l"):
        raise ValueError(kind)
    t = min(cfg.window, max_len) if kind == "l" and cfg.window else max_len
    if cfg.cache_layout == "bkth":
        shape = (batch, cfg.n_kv_heads, t, cfg.head_dim)
    else:
        shape = (batch, t, cfg.n_kv_heads, cfg.head_dim)
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def layer_state_specs(cfg, kind: str) -> dict:
    if kind in ("a", "l"):
        dims = (("batch", "kv_heads", None, "head")
                if cfg.cache_layout == "bkth"
                else ("batch", None, "kv_heads", "head"))
        return {"k": dims, "v": dims}
    if kind == "r":
        return rglru.rglru_state_specs(cfg)
    if kind == "s":
        return mamba2.mamba2_state_specs(cfg)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# whole-model init / apply
# ---------------------------------------------------------------------------


def init_model(cfg, generator=None, device="cpu") -> dict:
    """The parameter tree ``{"emb": ..., "layers": ...}``: stacked
    ``[L, ...]`` leaves for a homogeneous pattern, else a list of per-layer
    trees. ``generator`` (a ``torch.Generator`` on ``device``) draws the
    weights; on the ``meta`` device it may be None (shapes only)."""
    check_supported(cfg)
    emb = nn.init_embeddings(generator, cfg, device)
    if stacked(cfg):
        layers = init_layer(generator, cfg, cfg.pattern[0], device,
                            lead=(cfg.n_layers,))
    else:
        layers = [init_layer(generator, cfg, kind, device)
                  for kind in cfg.pattern]
    return {"emb": emb, "layers": layers}


def model_specs(cfg) -> dict:
    """The reference's logical-dim tree of :func:`init_model`'s parameters
    (its ``init_model(key, cfg)[1]``): stacked leaves lead with "layers",
    per-layer trees are listed."""
    check_supported(cfg)
    emb = nn.embeddings_specs(cfg)
    if stacked(cfg):
        return {"emb": emb,
                "layers": _stacked_dims(layer_specs(cfg, cfg.pattern[0]))}
    return {"emb": emb,
            "layers": [layer_specs(cfg, kind) for kind in cfg.pattern]}


class _Unstack(torch.autograd.Function):
    """The layers of a stacked ``[L, ...]`` leaf as L views; their
    gradients come back stacked into one ``[L, ...]`` tensor (indexing
    each layer instead would give each its own zero ``[L, ...]`` gradient
    and a sum of L of them)."""

    @staticmethod
    def forward(ctx, a):
        return a.unbind(0)

    @staticmethod
    def backward(ctx, *grads):
        return torch.stack(grads)


def _layer_params(params, cfg):
    """[(kind, per-layer tree, its placements)] for either layout (views
    of a stack): the placements of this rank's blocks when the model is
    given blocks (``sharding.param_placements``), else None."""
    places = SH.param_placements()
    if stacked(cfg):
        kind = cfg.pattern[0]
        leaves = [_Unstack.apply(a) for a in tree.leaves(params["layers"])]
        per_layer = [tree.unflatten(params["layers"],
                                    [views[i] for views in leaves])
                     for i in range(cfg.n_layers)]
        lp_places = (None if places is None else tree.map(
            lambda _, p: p[1:], params["layers"], places["layers"]))
        return [(kind, lp, lp_places) for lp in per_layer]
    return [(kind, lp, None if places is None else places["layers"][i])
            for i, (kind, lp) in enumerate(zip(cfg.pattern,
                                               params["layers"]))]


def _emb_params(params):
    """The embeddings' parameters this rank computes with."""
    places = SH.param_placements()
    return (params["emb"] if places is None
            else SH.layer_params(params["emb"], places["emb"]))


def _run_layer(lp, lp_places, cfg, kind, x, cos, sin):
    """:func:`apply_layer` of one layer's blocks (gathered here, so that
    remat's recompute gathers them again)."""
    if lp_places is not None:
        lp = SH.layer_params(lp, lp_places)
    return apply_layer(lp, cfg, kind, x, cos, sin)


def _rope_tables(cfg, positions):
    if cfg.rope_style == "none":
        return None, None
    sections = cfg.mrope_sections if cfg.rope_style == "mrope" else ()
    return nn.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, sections)


def _embed_inputs(emb, cfg, batch: dict) -> torch.Tensor:
    x = nn.embed_tokens(emb, cfg, batch["tokens"])
    if "vision_embeds" in batch:   # VLM stub frontend: precomputed patches
        mask = batch["vision_mask"][..., None]
        x = torch.where(mask, batch["vision_embeds"].to(x.dtype), x)
    return shard_hint(x, ("batch", "seq", "embed"))


def _positions(batch, b: int, s: int, device):
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=device)[None, :].expand(b, s)
    return positions


def forward(params: dict, cfg, batch: dict) -> torch.Tensor:
    """Full-sequence forward -> f32 logits [B, S, n_emb * padded_vocab]."""
    check_supported(cfg)
    emb = _emb_params(params)
    x = _embed_inputs(emb, cfg, batch)
    b, s = batch["tokens"].shape[:2]
    cos, sin = _rope_tables(cfg, _positions(batch, b, s, x.device))
    for kind, lp, lp_places in _layer_params(params, cfg):
        if cfg.remat:
            x = checkpoint(_run_layer, lp, lp_places, cfg, kind, x, cos, sin,
                           use_reentrant=False,
                           context_fn=SH.checkpoint_contexts)
        else:
            x = _run_layer(lp, lp_places, cfg, kind, x, cos, sin)
    x = nn.rms_norm(x, emb["ln_f"], cfg.norm_eps)
    return shard_hint(nn.unembed(emb, cfg, x), ("batch", "seq", "vocab"))


def prefill(params: dict, cfg, batch: dict, max_len: int = 0):
    """Forward + decode-state construction. Returns (logits, states), the
    states stacked [L, ...] or listed as the parameters are."""
    check_supported(cfg)
    emb = _emb_params(params)
    x = _embed_inputs(emb, cfg, batch)
    b, s = batch["tokens"].shape[:2]
    cos, sin = _rope_tables(cfg, _positions(batch, b, s, x.device))
    states = []
    for kind, lp, lp_places in _layer_params(params, cfg):
        if lp_places is not None:
            lp = SH.layer_params(lp, lp_places)
        x, st = apply_layer_prefill(lp, cfg, kind, x, cos, sin, max_len)
        states.append(st)
    if stacked(cfg):
        states = {name: torch.stack([st[name] for st in states])
                  for name in states[0]}
    x = nn.rms_norm(x, emb["ln_f"], cfg.norm_eps)
    return nn.unembed(emb, cfg, x), states


def decode_step(params: dict, cfg, states, batch: dict):
    """One token for every sequence. batch: tokens [B, 1], pos (an int or
    a 0-d tensor). The states' tensors are updated in place.

    Returns (logits [B, 1, V], states).
    """
    check_supported(cfg)
    emb = _emb_params(params)
    x = _embed_inputs(emb, cfg, batch)
    pos = int(batch["pos"])
    b = batch["tokens"].shape[0]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.full((b, 1), pos, device=x.device)
    cos, sin = _rope_tables(cfg, positions)
    layer_states = ([{name: leaf[i] for name, leaf in states.items()}
                     for i in range(cfg.n_layers)] if stacked(cfg)
                    else states)
    new_states = []
    for (kind, lp, lp_places), st in zip(_layer_params(params, cfg),
                                         layer_states):
        if lp_places is not None:
            lp = SH.layer_params(lp, lp_places)
        x, st = apply_layer_decode(lp, cfg, kind, st, x, pos, cos, sin)
        new_states.append(st)
    x = nn.rms_norm(x, emb["ln_f"], cfg.norm_eps)
    return nn.unembed(emb, cfg, x), (states if stacked(cfg)
                                     else new_states)


def init_states(cfg, batch: int, max_len: int, device="cpu"):
    """Zero decode states: stacked [L, ...] leaves for a homogeneous
    pattern, else one dict per layer."""
    check_supported(cfg)
    if stacked(cfg):
        one = init_layer_state(cfg, cfg.pattern[0], batch, max_len, device)
        return {name: torch.zeros((cfg.n_layers,) + a.shape, dtype=a.dtype,
                                  device=device)
                for name, a in one.items()}
    return [init_layer_state(cfg, k, batch, max_len, device)
            for k in cfg.pattern]


def state_specs(cfg):
    """The logical dims of :func:`init_states`' tree."""
    check_supported(cfg)
    if stacked(cfg):
        return _stacked_dims(layer_state_specs(cfg, cfg.pattern[0]))
    return [layer_state_specs(cfg, k) for k in cfg.pattern]


# ---------------------------------------------------------------------------
# the model as a module
# ---------------------------------------------------------------------------


class LanguageModel(tnn.Module):
    """The parameter tree held as ``nn.Parameter``s under the reference's
    paths (``state_dict`` keys ``emb.tok``, ``layers.attn.wq``, or
    ``layers.0.attn.wq`` for a per-layer list: the reference's ``/``
    paths with ``.``), with the functional entry points as methods.
    :meth:`tree` gives the tree the functions above take."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        self.params = _Node(params)

    @classmethod
    def init(cls, cfg, generator=None, device="cuda") -> "LanguageModel":
        """A model with fresh weights on ``device``: the card by default,
        failing when there is none (pass ``device="cpu"`` for the CPU)."""
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError("LanguageModel.init builds on the CUDA device "
                               "by default and none is available; pass "
                               "device='cpu' to build on the CPU")
        return cls(cfg, init_model(cfg, generator, device))

    def tree(self) -> dict:
        return self.params.tree()

    def forward(self, batch: dict) -> torch.Tensor:
        return forward(self.tree(), self.cfg, batch)

    def prefill(self, batch: dict, max_len: int = 0):
        return prefill(self.tree(), self.cfg, batch, max_len)

    def decode_step(self, states, batch: dict):
        return decode_step(self.tree(), self.cfg, states, batch)


class _Node(tnn.Module):
    """One dict or list of a parameter tree: leaves as parameters,
    subtrees as child modules, named by their keys or indices."""

    def __init__(self, node):
        super().__init__()
        self.is_list = isinstance(node, (list, tuple))
        self.names = [str(k) for k in (range(len(node)) if self.is_list
                                       else node)]
        for name, v in zip(self.names, node if self.is_list
                           else node.values()):
            if isinstance(v, (dict, list, tuple)):
                self.add_module(name, _Node(v))
            else:
                self.register_parameter(name, tnn.Parameter(v))

    def tree(self):
        out = [getattr(self, n) for n in self.names]
        out = [v.tree() if isinstance(v, _Node) else v for v in out]
        return out if self.is_list else dict(zip(self.names, out))
