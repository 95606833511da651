"""Train step: microbatched gradient accumulation and the optimizer update
(the port of ``repro.train.train_step``).

``step(state, batch) -> (state, metrics)`` takes and returns the
reference's state tree ``{"params", "opt", "step"}``; the gradients come
from ``torch.autograd.grad`` through the parameter leaves (detached views,
so the state never holds a graph).

:func:`make_sharded_train_step` is the same function on a process grid.
At rest every leaf of the state is this rank's block under the placements
the sharding rules resolve (the reference's ``NamedSharding``s). A step
runs the forward and backward on the rank's rows of each microbatch
(``distributed.sharding.batch_rows``) and on its blocks of the
parameters, as GSPMD partitions the reference: each layer gathers its
FSDP blocks as it runs and computes its share along "model" (tensor
parallelism, ``models.layers``; the MoE's experts split as ``models.moe.
moe_forward_ep``). A gather over batch axes gives its gradient back as
a reduce-scatter, this rank's block of the ring's sum
(``DeviceGrid.reduce_scatter``). Each block's gradient is then
all-reduced over the batch axes its placement does not hold, the global
norm is the whole model's (each block's sum of squares summed over its
ring), Adafactor's row, column and RMS statistics are the whole
tensor's (the blocks' sums over their rings), and the rank updates its
blocks.
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
    bitwise. The gradients' collectives follow the dict order of
    ``state["params"]``: a state in :func:`init_train_state`'s order
    issues them as the dry-run records them, one in another order (the
    sorted dicts ``bridge`` carries from the reference) in that one."""
    update = opt.update_fn(opt_cfg.kind)
    grad_fn = value_and_grad(cfg)
    rules = rules or SH.rules_for(cfg)
    batch_axes = SH.as_axes(batch_axes)
    n = grid.axis_size(batch_axes)
    places = placements["params"]
    template = transformer.init_model(cfg, None, "meta")
    leaf_places = tree.leaves(tree.map(lambda _, p: _Placed(p), template,
                                       places))
    kw = ({"stats": tree.map(lambda _, p, v: _BlockStats(grid, p, v),
                             template, places, placements["opt"]["v"])}
          if opt_cfg.kind == "adafactor" else {})

    def whole(sums):
        """Each leaf's sum of squares over the whole tensor: the blocks'
        summed over the ring of their axes, one all-reduce an axis set."""
        groups: dict = {}
        for i, pl in enumerate(leaf_places):
            axes = tuple(a for a in grid.axes if a in SH.placed_axes(pl.p))
            if grid.axis_size(axes) > 1:
                groups.setdefault(axes, []).append(i)
        sums = list(sums)
        for axes, idx in groups.items():
            total = grid.psum(torch.stack([sums[i] for i in idx]), axes)
            for j, i in enumerate(idx):
                sums[i] = total[j]
        return sums

    def train_step(state, batch):
        blocks = state["params"]
        with SH.activation_sharding(grid, rules, batch_axes, places):
            loss_val, grads = _accumulate(grad_fn, blocks, batch,
                                          microbatches)
        # the mean over the microbatches and the batch shards; a gather
        # over a batch axis already summed the gradient over it
        d = microbatches * n
        grads = tree.map(lambda g, p: grid.psum(g.float(), tuple(
            a for a in batch_axes if a not in SH.placed_axes(p))),
            grads, places)
        loss_val = grid.psum(loss_val, batch_axes)
        if d > 1:
            grads = tree.map(lambda g: g / d, grads)
            loss_val = loss_val / d

        with torch.no_grad():
            grads, gnorm = opt.clip_by_global_norm(grads, opt_cfg.grad_clip,
                                                   whole)
            new_params, new_opt = update(grads, state["opt"], blocks,
                                         opt_cfg, **kw)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = {"loss": loss_val, "grad_norm": gnorm,
                   "step": new_state["step"]}
        return new_state, metrics

    return train_step


class _Placed:
    """A placement held as one leaf (``tree.leaves`` walks into
    tuples)."""

    def __init__(self, p):
        self.p = p


class _BlockStats(opt.WholeStats):
    """Adafactor's statistics of a block under ``placement`` (the
    optimizer's :class:`~repro_torch.train.optimizer.WholeStats`): a mean
    sums over the ring of the reduced dims' axes; ``vc``'s last dim, which
    the rules resolve on its own dims (where the parameter's next-to-last
    dim no longer holds an axis), is gathered and cut between its stored
    placement and the gradient's columns."""

    def __init__(self, grid, placement, v_places):
        self.grid, self.placement = grid, placement
        self.vc = v_places.get("vc") if isinstance(v_places, dict) else None

    def mean(self, x, dim=None, pdim=None):
        grid = self.grid
        if dim is None:
            axes = tuple(a for a in grid.axes
                         if a in SH.placed_axes(self.placement))
        else:
            axes = SH.as_axes(self.placement[pdim])
        n = grid.axis_size(axes)
        if n == 1:
            return opt.WholeStats.mean(x, dim)
        if dim is None:
            return grid.psum(torch.sum(x), axes) / (x.numel() * n)
        return grid.psum(x.sum(dim), axes) / (x.shape[dim] * n)

    def _move(self, vc, src, dst):
        src, dst = SH.as_axes(src), SH.as_axes(dst)
        if src == dst:
            return vc
        vc = self.grid.all_gather(vc, src, -1)
        if self.grid.axis_size(dst) > 1:
            n = vc.shape[-1] // self.grid.axis_size(dst)
            vc = vc.narrow(-1, self.grid.axis_index(dst) * n, n)
        return vc

    def columns(self, vc):
        return self._move(vc, self.vc[-1], self.placement[-1])

    def stored(self, vc):
        return self._move(vc, self.placement[-1], self.vc[-1])
