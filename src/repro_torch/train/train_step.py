"""Train step: microbatched gradient accumulation and the optimizer update
(the port of ``repro.train.train_step``).

``step(state, batch) -> (state, metrics)`` takes and returns the
reference's state tree ``{"params", "opt", "step"}``; the gradients come
from ``torch.autograd.grad`` through the parameter leaves (detached views,
so the state never holds a graph).

:func:`make_sharded_train_step` is the same function on a process grid.
At rest every leaf of the state is this rank's block under the placements
the sharding rules resolve (the reference's ``NamedSharding``s). A step
gathers the parameters whole, runs the forward and backward on the
rank's rows of each microbatch (``distributed.sharding.batch_rows``),
all-reduces the f32 gradients over the batch axes only (ranks along
"model" hold replicas), takes the mean, the global-norm clip and
Adafactor's row and column statistics over the whole gradient, and
updates the rank's blocks. Compute that the reference partitions along
"model" (tensor-parallel matmuls) runs replicated; only the MoE splits
its experts there (``models.moe.moe_forward_ep``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.distributed import sharding as SH
from repro_torch.models import model as M
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt


def init_train_state(cfg, opt_cfg: opt.OptimizerConfig, generator=None,
                     device="cpu") -> dict:
    params = transformer.init_model(cfg, generator, device)
    return {"params": params,
            "opt": opt.init_fn(opt_cfg.kind)(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def state_logical_dims(cfg, opt_cfg, param_specs, params):
    return {
        "params": param_specs,
        "opt": opt.state_logical_dims(opt_cfg.kind, param_specs, params),
        "step": None,
    }


def state_placements(cfg, opt_cfg: opt.OptimizerConfig, grid,
                     rules=None) -> dict:
    """The placement of every leaf of the train state on ``grid`` (a grid
    or a layout), resolved from ``meta`` templates."""
    meta = init_train_state(cfg, opt_cfg, None, "meta")
    dims = state_logical_dims(cfg, opt_cfg, transformer.model_specs(cfg),
                              meta["params"])
    return SH.resolve_tree(grid, dims, meta, rules or SH.rules_for(cfg))


def value_and_grad(cfg) -> Callable:
    """``fn(params, batch) -> (loss, grads)``, the grads in the params'
    dtypes."""
    def fn(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        with torch.enable_grad():
            loss = M.loss_fn(tree.unflatten(params, leaves), cfg, batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree.unflatten(params, grads)
    return fn


def _accumulate(grad_fn, params, batch, microbatches: int):
    """(the loss, the grads) of one batch, or with several microbatches
    (rows ``[i B/m, (i+1) B/m)`` each) their sums, the grads accumulated
    in f32 in order."""
    if microbatches == 1:
        return grad_fn(params, batch)
    mb_batch = {k: x.reshape((microbatches, -1) + x.shape[1:])
                for k, x in batch.items()}
    grads = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    lsum = 0.0
    for i in range(microbatches):
        loss_i, g = grad_fn(params, {k: x[i] for k, x in mb_batch.items()})
        for acc, gi in zip(tree.leaves(grads), tree.leaves(g)):
            acc.add_(gi)           # exact widening, f32 add
        lsum = lsum + loss_i
        del g
    return lsum, grads


def make_train_step(cfg, opt_cfg: opt.OptimizerConfig,
                    microbatches: int = 1) -> Callable:
    update = opt.update_fn(opt_cfg.kind)
    grad_fn = value_and_grad(cfg)

    def train_step(state, batch):
        params = state["params"]
        loss_val, grads = _accumulate(grad_fn, params, batch, microbatches)
        if microbatches > 1:
            grads = tree.map(lambda g: g / microbatches, grads)
            loss_val = loss_val / microbatches

        with torch.no_grad():
            grads, gnorm = opt.clip_by_global_norm(grads, opt_cfg.grad_clip)
            new_params, new_opt = update(grads, state["opt"], params,
                                         opt_cfg)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = {"loss": loss_val, "grad_norm": gnorm,
                   "step": new_state["step"]}
        return new_state, metrics

    return train_step


def make_sharded_train_step(cfg, opt_cfg: opt.OptimizerConfig, grid,
                            placements: dict, batch_axes, rules=None,
                            microbatches: int = 1) -> Callable:
    """The train step on ``grid``: the state holds this rank's blocks under
    ``placements`` (:func:`state_placements`), the batch this rank's rows
    of each microbatch over ``batch_axes``, in microbatch order (``data.
    synthetic.sharded_batch``). On a one-rank grid every gather and
    all-reduce is the identity, and the step is :func:`make_train_step`'s,
    bitwise."""
    update = opt.update_fn(opt_cfg.kind)
    grad_fn = value_and_grad(cfg)
    rules = rules or SH.rules_for(cfg)
    batch_axes = SH.as_axes(batch_axes)
    n = grid.axis_size(batch_axes)

    def train_step(state, batch):
        blocks = state["params"]
        params = SH.gather_tree(grid, blocks, placements["params"])
        with SH.activation_sharding(grid, rules, batch_axes):
            loss_val, grads = _accumulate(grad_fn, params, batch,
                                          microbatches)
        # the mean over the microbatches and the batch shards
        d = microbatches * n
        grads = tree.map(lambda g: grid.psum(g.float(), batch_axes), grads)
        loss_val = grid.psum(loss_val, batch_axes)
        if d > 1:
            grads = tree.map(lambda g: g / d, grads)
            loss_val = loss_val / d

        with torch.no_grad():
            grads, gnorm = opt.clip_by_global_norm(grads, opt_cfg.grad_clip)
            if opt_cfg.kind == "adafactor":
                # factored moments and the update's RMS clip read whole
                # rows, columns and tensors: update the whole tensors,
                # keep this rank's blocks
                new_params, new_opt = update(
                    grads, SH.gather_tree(grid, state["opt"],
                                          placements["opt"]), params,
                    opt_cfg)
                new_params = SH.local_blocks(grid, new_params,
                                             placements["params"])
                new_opt = SH.local_blocks(grid, new_opt, placements["opt"])
            else:   # elementwise: the blocks alone
                new_params, new_opt = update(
                    SH.local_blocks(grid, grads, placements["params"]),
                    state["opt"], blocks, opt_cfg)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = {"loss": loss_val, "grad_norm": gnorm,
                   "step": new_state["step"]}
        return new_state, metrics

    return train_step
