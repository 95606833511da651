"""Public model API: the loss, the step functions, and the abstract input
batch of every (architecture x shape) cell with its logical dims (the
port of ``repro.models.model``). Abstract tensors live on the ``meta``
device: shapes and dtypes, no storage."""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core.lattice import torch_dtype
from repro_torch.models import transformer


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean CE over [B, S]; logits are f32 [B, S, V_padded]. The padded
    tail (ids that never appear in labels) is masked to -1e30, so it adds
    nothing to the partition function."""
    v = logits.shape[-1]
    if v != vocab_size:
        pad_mask = torch.arange(v, device=logits.device) >= vocab_size
        logits = torch.where(pad_mask, -1e30, logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def loss_fn(params: dict, cfg, batch: dict) -> torch.Tensor:
    logits = transformer.forward(params, cfg, batch)
    labels = batch["labels"]
    if cfg.n_codebooks:
        b, s, _ = logits.shape
        logits = logits.reshape(b, s, cfg.n_codebooks, cfg.padded_vocab)
        losses = [cross_entropy(logits[:, :, i], labels[..., i],
                                cfg.vocab_size)
                  for i in range(cfg.n_codebooks)]
        return torch.mean(torch.stack(losses))
    return cross_entropy(logits, labels, cfg.vocab_size)


# ---------------------------------------------------------------------------
# input specs (meta tensors, no allocation) + logical dims
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape) -> dict:
    """Abstract input batch for one cell (``shape``: a ShapeConfig)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    tok_shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta(tok_shape, i32)}
        if shape.kind == "train":
            batch["labels"] = _meta(tok_shape, i32)
        if cfg.family == "vlm":
            batch["vision_embeds"] = _meta((b, s, cfg.d_model),
                                           torch_dtype(cfg.dtype))
            batch["vision_mask"] = _meta((b, s), torch.bool)
            batch["positions"] = _meta((b, s, 3), i32)
        return batch
    if shape.kind == "decode":
        tok1 = (b, 1, cfg.n_codebooks) if cfg.n_codebooks else (b, 1)
        batch = {"tokens": _meta(tok1, i32), "pos": _meta((), i32)}
        if cfg.family == "vlm":
            batch["positions"] = _meta((b, 1, 3), i32)
        return batch
    raise ValueError(shape.kind)


def batch_logical_dims(cfg, shape) -> dict:
    """Logical axes for each input tensor (resolved by the sharding
    rules)."""
    tok = ("batch", "seq", None) if cfg.n_codebooks else ("batch", "seq")
    if shape.kind in ("train", "prefill"):
        dims = {"tokens": tok}
        if shape.kind == "train":
            dims["labels"] = tok
        if cfg.family == "vlm":
            dims["vision_embeds"] = ("batch", "seq", "embed")
            dims["vision_mask"] = ("batch", "seq")
            dims["positions"] = ("batch", "seq", None)
        return dims
    tok1 = ("batch", None, None) if cfg.n_codebooks else ("batch", None)
    dims = {"tokens": tok1, "pos": None}
    if cfg.family == "vlm":
        dims["positions"] = ("batch", None, None)
    return dims


def decode_state_specs(cfg, shape):
    """(meta decode-state tree, logical-dims tree) for the decode cache."""
    states = transformer.init_states(cfg, shape.global_batch, shape.seq_len,
                                     device="meta")
    return states, transformer.state_specs(cfg)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


def make_train_loss(cfg) -> Callable:
    return functools.partial(loss_fn, cfg=cfg)


def make_prefill(cfg, max_len: int = 0) -> Callable:
    """``fn(params, batch) -> (last logits [B, 1, V], states)``; with
    ``max_len`` the caches are padded for decode up to that length."""
    @torch.no_grad()
    def fn(params, batch):
        logits, states = transformer.prefill(params, cfg, batch, max_len)
        return logits[:, -1:], states
    return fn


def make_decode_step(cfg) -> Callable:
    """``fn(params, states, batch) -> (logits, states)``; the states'
    caches are updated in place."""
    @torch.no_grad()
    def fn(params, states, batch):
        return transformer.decode_step(params, cfg, states, batch)
    return fn
