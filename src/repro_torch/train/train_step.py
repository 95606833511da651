"""Train step: microbatched gradient accumulation and the optimizer update
(the port of ``repro.train.train_step``).

``step(state, batch) -> (state, metrics)`` takes and returns the
reference's state tree ``{"params", "opt", "step"}``; the gradients come
from ``torch.autograd.grad`` through the parameter leaves (detached views,
so the state never holds a graph).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.models import model as M
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt


def init_train_state(cfg, opt_cfg: opt.OptimizerConfig, generator=None,
                     device="cpu") -> dict:
    params = transformer.init_model(cfg, generator, device)
    return {"params": params,
            "opt": opt.init_fn(opt_cfg.kind)(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


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


def make_train_step(cfg, opt_cfg: opt.OptimizerConfig,
                    microbatches: int = 1) -> Callable:
    update = opt.update_fn(opt_cfg.kind)
    grad_fn = value_and_grad(cfg)

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            loss_val, grads = grad_fn(params, batch)
        else:
            # grads accumulated in f32 over the microbatches, in order
            mb_batch = {k: x.reshape((microbatches, -1) + x.shape[1:])
                        for k, x in batch.items()}
            grads = tree.map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            lsum = 0.0
            for i in range(microbatches):
                loss_i, g = grad_fn(params, {k: x[i] for k, x in
                                             mb_batch.items()})
                for acc, gi in zip(tree.leaves(grads), tree.leaves(g)):
                    acc.add_(gi)           # exact widening, f32 add
                lsum = lsum + loss_i
                del g
            grads = tree.map(lambda g: g / microbatches, grads)
            loss_val = lsum / microbatches

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
