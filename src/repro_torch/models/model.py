"""Public model API: the loss and the step functions (the port of
``repro.models.model``). The abstract input specs and logical dims of the
dry-run wait for the dry-run slice."""
from __future__ import annotations

import functools
from typing import Callable

import torch

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
