"""Public model API: the loss, the step functions, and the abstract input
batch of every (architecture x shape) cell with its logical dims (the
port of ``repro.models.model``). Abstract tensors live on the ``meta``
device: shapes and dtypes, no storage.

:func:`make_sharded_prefill` and :func:`make_sharded_decode_step` are the
serving functions on a process grid, in the pattern of
``train.train_step.make_sharded_train_step``: the counterpart of the
reference's jitted ``make_prefill`` / ``make_decode_step`` with sharded
parameters, batch and decode states (``repro.launch.dryrun_lib``). A rank
holds its blocks of the parameters under the resolved placements, takes
its rows of the batch over the batch axes, and runs the body inside
``distributed.sharding.activation_sharding`` with those placements: each
layer gathers its FSDP blocks as it runs and computes its share along
"model" (tensor parallelism; the MoE takes its grid forms there). Decode
states are this rank's blocks under :func:`decode_state_placements`: its
rows over the batch axes, and its kv heads, channels or heads along
"model" where that splits them, which its layers read and update in place.
The last logits are gathered over the vocab once, for the caller. On a
one-rank grid each is the unsharded function, bitwise."""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch import tree
from repro_torch.core.lattice import torch_dtype
from repro_torch.distributed import sharding as SH
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


def _cross_entropy_block(logits, labels, vocab_size: int, lo: int, grid):
    """:func:`cross_entropy` of the padded vocab's columns ``[lo, lo + n)``
    held by this rank (``n`` may be 0), the ring of "model" holding the
    rest: the rows' maxima by a pmax (a shift the result does not depend
    on), the exp-sums and the label's logit (from the rank holding it)
    by one psum."""
    n = logits.shape[-1]
    cols = lo + torch.arange(n, device=logits.device)
    logits = torch.where(cols >= vocab_size, -1e30, logits)
    m = (logits.amax(-1) if n else
         torch.full(labels.shape, -1e30, device=logits.device))
    m = grid.pmax(m, "model")
    local = labels.long() - lo
    inside = (local >= 0) & (local < n)
    gold = (torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])
            [..., 0] if n else torch.zeros_like(m))
    sums = torch.stack([torch.exp(logits - m[..., None]).sum(-1),
                        torch.where(inside, gold, 0)])
    sums = SH.sum_over(sums, grid, "model")
    return torch.mean(m + torch.log(sums[0]) - sums[1])


def loss_fn(params: dict, cfg, batch: dict) -> torch.Tensor:
    """Mean CE of the logits (of each codebook, then their mean). Where the
    logits are this rank's block of the vocab over "model", each codebook
    takes the columns of the block that fall in it."""
    logits = transformer.forward(params, cfg, batch)
    labels = batch["labels"]
    v = cfg.padded_vocab
    n_emb = max(cfg.n_codebooks, 1)
    blk = SH.model_block(logits.shape[-1], n_emb * v)
    if blk is not None:
        grid, lo = blk
        hi = lo + logits.shape[-1]
        losses = []
        for i in range(n_emb):
            a, b = max(lo, i * v), min(hi, (i + 1) * v)
            if b <= a:      # no column of codebook i on this rank
                a = b = lo
            lab = labels[..., i] if cfg.n_codebooks else labels
            losses.append(_cross_entropy_block(
                logits[..., a - lo:b - lo], lab, cfg.vocab_size, a - i * v,
                grid))
        return (torch.mean(torch.stack(losses)) if cfg.n_codebooks
                else losses[0])
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


# ---------------------------------------------------------------------------
# sharded serving (a process grid)
# ---------------------------------------------------------------------------


def decode_state_placements(cfg, grid, batch: int, max_len: int,
                            rules=None):
    """The placement of every decode-state leaf of a ``batch`` x
    ``max_len`` cache on ``grid`` (a grid or a layout), resolved from
    ``meta`` templates by the rules."""
    states = transformer.init_states(cfg, batch, max_len, device="meta")
    return SH.resolve_tree(grid, transformer.state_specs(cfg), states,
                           rules or SH.rules_for(cfg))


def _check_rows(cfg, states, placements, batch_axes) -> None:
    """Every decode-state leaf must split its batch dim over the batch
    axes, as the batch does."""
    def one(_, dims, p):
        got = SH.as_axes(p[dims.index("batch")])
        if got != batch_axes:
            raise ValueError(f"a decode state placed {p} splits its batch "
                             f"over {got}, the batch over {batch_axes}")
    tree.map(one, states, transformer.state_specs(cfg), placements)


def make_sharded_prefill(cfg, grid, placements, batch_axes,
                         state_placements, rules=None,
                         max_len: int = 0) -> Callable:
    """``fn(param_blocks, batch) -> (last logits, state blocks)``: the
    prefill on ``grid``. ``placements`` are the parameters' (the model
    specs resolved by ``rules``); ``batch`` holds this rank's rows over
    ``batch_axes`` (``distributed.sharding.batch_rows``); the states come
    back as this rank's blocks under ``state_placements``
    (:func:`decode_state_placements` of the cache, ``max_len`` long)."""
    prefill = make_prefill(cfg, max_len)
    rules = rules or SH.rules_for(cfg)
    batch_axes = SH.as_axes(batch_axes)

    def fn(blocks, batch):
        with SH.activation_sharding(grid, rules, batch_axes, placements):
            logits, states = prefill(blocks, batch)
            logits = _whole_vocab(cfg, logits)
        _check_rows(cfg, states, state_placements, batch_axes)
        return logits, states

    return fn


def _whole_vocab(cfg, logits):
    """The logits over the whole vocab, gathered over "model" where they
    are this rank's block of it (once, for the caller)."""
    blk = SH.model_block(logits.shape[-1],
                         max(cfg.n_codebooks, 1) * cfg.padded_vocab)
    return logits if blk is None else blk[0].all_gather(logits, "model", -1)


def make_sharded_decode_step(cfg, grid, placements, batch_axes,
                             state_placements, rules=None) -> Callable:
    """``fn(param_blocks, state_blocks, batch) -> (logits, state_blocks)``:
    one decode step on ``grid``. The state blocks are gathered along the
    axes other than the batch's, stepped, and updated in place (the
    returned blocks are the arguments)."""
    decode = make_decode_step(cfg)
    rules = rules or SH.rules_for(cfg)
    batch_axes = SH.as_axes(batch_axes)

    def fn(blocks, states, batch):
        _check_rows(cfg, states, state_placements, batch_axes)
        with SH.activation_sharding(grid, rules, batch_axes, placements):
            logits, states = decode(blocks, states, batch)
            return _whole_vocab(cfg, logits), states

    return fn
