"""Logical-axis sharding rules (MaxText-style) with divisibility fallback:
the port of ``repro.distributed.sharding``.

Params and activations are annotated with *logical* axis names; rules map
them to grid axes. A dim is sharded only if its size divides the product
of the grid axes **and** those axes are not already used by an earlier dim
of the same tensor. A placement is what :class:`DeviceGrid` takes: one
entry per dim, None, an axis name or a tuple of names (the reference's
``PartitionSpec``). The rules read only axis names and sizes, so they
resolve on a :class:`~repro_torch.launch.mesh.Layout` (the production
16 x 16 and 2 x 16 x 16 with no ranks) as on a grid.

Example: llama4's 40 q-heads don't divide the 16-way model axis, so the
"heads" rule falls back to replicated for that tensor while its "ffn"/
"experts" dims still shard, tensor by tensor.

:func:`activation_sharding` marks a region in which the model's
activations are this rank's rows of the global batch over
``batch_axes``; inside it :func:`shard_hint` checks that the reference
would place those rows there, and the MoE takes its grid forms. Given
the parameters' placements too, the model is handed this rank's blocks:
each layer gathers its FSDP blocks as it runs (:func:`layer_params`)
and computes its block along "model" (:func:`tp_grid`,
:func:`model_block`: tensor parallelism, as GSPMD partitions the
reference). The differentiable collectives at the end are the ones
those forms need: Megatron's pair :func:`replicated_over` /
:func:`sum_over`, :func:`reduce_over`, :func:`gather_block` and
:func:`block_over`.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.launch.mesh import as_axes

# logical axis -> tuple of candidate grid-axis groups, tried in order.
# Each candidate is a tuple of grid axis names used together.
DEFAULT_RULES: dict = {
    "batch": (("pod", "data"), ("data",)),
    "vocab": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "head": (),                      # head_dim: never sharded
    "ffn": (("model",),),
    "experts": (("model",),),
    "embed": (),                     # sharded only under FSDP (see below)
    "rnn": (("model",),),
    "ssm_inner": (("model",),),
    "ssm_heads": (("model",),),
    "state": (),
    "seq": (),                       # sequence kept local (halo-free archs)
    "layers": (),                    # stacked-layer leading dim
    None: (),
}

# Under FSDP the embed/replicated dims additionally shard over data.
FSDP_RULES: dict = dict(DEFAULT_RULES)
FSDP_RULES["embed"] = (("data",),)
FSDP_RULES["ffn"] = (("model",), ("data",))
FSDP_RULES["experts"] = (("model",), ("data",))


def rules_for(cfg) -> dict:
    """The rules an arch trains under (``repro.launch.dryrun_lib``): FSDP's
    for ``cfg.fsdp``, and the batch over (data, model) first for
    ``cfg.batch_over_model``."""
    rules = dict(FSDP_RULES if cfg.fsdp else DEFAULT_RULES)
    if cfg.batch_over_model:
        rules["batch"] = (("pod", "data", "model"), ("data", "model"),
                          ("pod", "data"), ("data",))
    return rules


def _axes_size(sizes: dict, axes: tuple) -> int:
    size = 1
    for a in axes:
        if a not in sizes:
            return 0
        size *= sizes[a]
    return size


def resolve_spec(grid, dims: tuple, shape: tuple,
                 rules: Optional[dict] = None) -> tuple:
    """Map logical dims of one tensor to a placement.

    grid: a ``DeviceGrid`` or ``Layout`` (its ``shape`` and ``axes``).
    dims: logical names (or None), one per tensor dim.
    shape: the global dim sizes (for divisibility checks).
    """
    rules = rules or DEFAULT_RULES
    sizes = dict(zip(grid.axes, grid.shape))
    used: set = set()
    out = []
    for dim_name, size in zip(dims, shape):
        assigned = None
        for cand in rules.get(dim_name, ()):
            axes_size = _axes_size(sizes, cand)
            if axes_size <= 1:
                continue
            if any(a in used for a in cand):
                continue
            if size % axes_size != 0:
                continue
            assigned = cand if len(cand) > 1 else cand[0]
            used.update(cand)
            break
        out.append(assigned)
    return tuple(out)


def resolve_tree(grid, spec_tree, param_tree, rules=None):
    """Logical specs + tensors (or ``meta`` templates) -> a placement per
    leaf, in ``param_tree``'s structure (a None spec: replicated, ``()``)."""
    def one(leaf, dims):
        if dims is None:
            return ()
        return resolve_spec(grid, tuple(dims), tuple(leaf.shape), rules)
    return tree.map(one, param_tree, spec_tree)


def batch_rows(grid, rules, global_batch: int, microbatches: int = 1):
    """(the axes a microbatch's rows are split over, the global rows this
    rank computes on). Microbatch i is rows [i B/m, (i+1) B/m) and its
    batch dim resolves as the reference's activations do; the rank takes
    the contiguous block of each at its index along those axes, so with
    m > 1 its rows are not one block of the global batch."""
    per_mb = global_batch // microbatches
    axes = as_axes(resolve_spec(grid, ("batch",), (per_mb,), rules)[0])
    n = per_mb // grid.axis_size(axes)
    lo = grid.axis_index(axes) * n
    return axes, [i * per_mb + lo + r for i in range(microbatches)
                  for r in range(n)]


def local_blocks(grid, full_tree, placements):
    """This rank's block of every leaf of ``full_tree``."""
    return tree.map(lambda a, p: grid.local_block(a, p), full_tree,
                    placements)


def placed_axes(placement) -> tuple:
    """Every grid axis a placement splits some dim over, in dim order."""
    return tuple(a for e in placement for a in as_axes(e))


# ---------------------------------------------------------------------------
# activation context
# ---------------------------------------------------------------------------

_CTX = threading.local()


@contextlib.contextmanager
def activation_sharding(grid, rules: Optional[dict] = None,
                        batch_axes=(), params=None):
    """While active, activations are this rank's rows of the global batch
    over ``batch_axes`` of ``grid`` (held whole along every other axis);
    :func:`shard_hint` checks them and the MoE takes its grid forms.
    ``params``, the placements of the parameter tree, says that the model
    is given this rank's blocks of its parameters: it then gathers each
    layer's blocks as it runs it (:func:`layer_params`), except along
    "model" where that axis is tensor-parallel (:func:`tp_grid`)."""
    with _entered((grid, rules or DEFAULT_RULES, as_axes(batch_axes),
                   params) if grid is not None else None):
        yield


def checkpoint_contexts():
    """``context_fn`` of ``torch.utils.checkpoint``: the forward runs in the
    current context, and the recompute, which the backward may run on
    another thread (the card's), enters it again."""
    return contextlib.nullcontext(), _entered(getattr(_CTX, "cfg", None))


@contextlib.contextmanager
def _entered(cfg):
    prev = getattr(_CTX, "cfg", None)
    _CTX.cfg = cfg
    try:
        yield
    finally:
        _CTX.cfg = prev


def current_mesh_and_rules():
    """The (grid, rules) of the enclosing :func:`activation_sharding`, or
    (None, None)."""
    cfg = getattr(_CTX, "cfg", None)
    if cfg is None:
        return None, None
    return cfg[0], cfg[1]


def current_batch_axes() -> tuple:
    """The axes the activations' batch rows are split over (``()`` outside
    a context)."""
    cfg = getattr(_CTX, "cfg", None)
    return () if cfg is None else cfg[2]


def param_placements():
    """The parameters' placements when the model is given rank blocks
    (:func:`activation_sharding`'s ``params``), else None."""
    cfg = getattr(_CTX, "cfg", None)
    return None if cfg is None else cfg[3]


# ---------------------------------------------------------------------------
# tensor-parallel compute along "model"
# ---------------------------------------------------------------------------


def tp_grid():
    """The grid whose "model" axis splits the compute of the enclosing
    context tensor by tensor (Megatron's tensor parallelism: GSPMD's
    partitioning of the dims the rules place over "model"), or None: no
    context, no parameter blocks, a one-rank "model" axis, or one that
    carries batch rows (``batch_over_model``: there the weights are
    gathered and the rows computed)."""
    cfg = getattr(_CTX, "cfg", None)
    if cfg is None or cfg[3] is None:
        return None
    grid, _, batch_axes, _ = cfg
    if ("model" not in grid.axes or "model" in batch_axes
            or grid.axis_size("model") == 1):
        return None
    return grid


def model_block(n_local: int, n_global: int):
    """Where a dim of ``n_global`` entries that a layer holds ``n_local``
    of lies: None when it is whole, else (the tensor-parallel grid, the
    first global index of this rank's block over "model"). A weight's
    local counts (heads, kv heads, ffn, vocab rows, rnn, ssm heads) are
    its block's shape; the rules split a dim over "model" only into equal
    blocks."""
    if n_local == n_global:
        return None
    grid = tp_grid()
    if grid is None or n_local * grid.axis_size("model") != n_global:
        raise ValueError(f"a dim of {n_global} held as {n_local} is not a "
                         "block over a tensor-parallel model axis")
    return grid, grid.axis_index("model") * n_local


def layer_params(blocks, placements):
    """One layer's (or the embeddings') parameters from this rank's blocks
    under ``placements``: each dim placed over other axes than the
    tensor-parallel "model" gathered over its ring (FSDP's "data", and
    "model" where it carries rows), the blocks along "model" kept. A
    gather over a batch axis reduce-scatters the ring's gradients into
    this rank's block (the rows differ there); over any other axis the
    compute is the same on the ring and the gradient is the block's
    share. Outside a context with parameter blocks, ``blocks`` as they
    are."""
    cfg = getattr(_CTX, "cfg", None)
    if cfg is None or cfg[3] is None:
        return blocks
    grid, _, batch_axes, _ = cfg
    keep = ("model",) if tp_grid() is not None else ()

    def one(w, placement):
        for dim, entry in enumerate(placement):
            axes = as_axes(entry)
            if axes and axes != keep and grid.axis_size(axes) > 1:
                w = gather_block(w, grid, axes, dim,
                                 summed=set(axes) <= set(batch_axes))
        return w
    return tree.map(one, blocks, placements)


def shard_hint(x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """Check an activation with logical dims against the reference's
    placement; the identity. Inside a context, the global tensor whose
    rows ``x`` holds must resolve its "batch" dim to the context's batch
    axes (it raises otherwise); outside one it checks nothing."""
    cfg = getattr(_CTX, "cfg", None)
    if cfg is None or "batch" not in dims:
        return x
    grid, rules, batch_axes = cfg[:3]
    i = dims.index("batch")
    shape = list(x.shape)
    shape[i] *= grid.axis_size(batch_axes)
    got = as_axes(resolve_spec(grid, dims, shape, rules)[i])
    if got != batch_axes:
        raise ValueError(f"an activation {tuple(shape)} of dims {dims} "
                         f"places its batch over {got}, but the rows are "
                         f"split over {batch_axes}")
    return x


# ---------------------------------------------------------------------------
# differentiable collectives (the transposes shard_map gives its
# replicated inputs and summed outputs)
# ---------------------------------------------------------------------------


class _SumForward(torch.autograd.Function):
    """psum over ``axes`` in the forward; the cotangent, replicated over
    the ring, passes through."""

    @staticmethod
    def forward(ctx, x, grid, axes):
        return grid.psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBackward(torch.autograd.Function):
    """The identity in the forward (an input replicated over ``axes``);
    the partial cotangents of the ring are summed in the backward."""

    @staticmethod
    def forward(ctx, x, grid, axes):
        ctx.grid, ctx.axes = grid, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.psum(g, ctx.axes), None, None


class _Block(torch.autograd.Function):
    """This rank's block of ``w`` along dim 0 over ``axes``; its gradient
    comes back whole, the ring's blocks gathered."""

    @staticmethod
    def forward(ctx, w, grid, axes):
        ctx.grid, ctx.axes = grid, axes
        n = w.shape[0] // grid.axis_size(axes)
        return w.narrow(0, grid.axis_index(axes) * n, n)

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.all_gather(g, ctx.axes, 0), None, None


class _Reduce(torch.autograd.Function):
    """psum over ``axes`` in the forward and in the backward: a sum whose
    result each rank uses on its own block (a norm over channels split
    over the ring)."""

    @staticmethod
    def forward(ctx, x, grid, axes):
        ctx.grid, ctx.axes = grid, axes
        return grid.psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.psum(g, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    """The ring's blocks of ``x`` along ``dim`` over ``axes``; the
    gradient of this rank's block is its slice of the gathered gradient,
    or its block of the ring's sum (a reduce-scatter) when ``summed``."""

    @staticmethod
    def forward(ctx, x, grid, axes, dim, summed):
        ctx.grid, ctx.axes, ctx.dim, ctx.summed = grid, axes, dim, summed
        ctx.n = x.shape[dim]
        return grid.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        grid = ctx.grid
        if ctx.summed:
            g = grid.reduce_scatter(g, ctx.axes, ctx.dim)
        else:
            g = g.narrow(ctx.dim, grid.axis_index(ctx.axes) * ctx.n, ctx.n)
        return g.contiguous(), None, None, None, None


def _alone(grid, axes) -> bool:
    return not grid.distributed or grid.axis_size(axes) == 1


def sum_over(x: torch.Tensor, grid, axes) -> torch.Tensor:
    """``x`` summed over the ring of ``axes`` (backward: the identity)."""
    return x if _alone(grid, axes) else _SumForward.apply(x, grid, axes)


def replicated_over(x: torch.Tensor, grid, axes) -> torch.Tensor:
    """``x`` as it is (backward: summed over the ring of ``axes``)."""
    return x if _alone(grid, axes) else _SumBackward.apply(x, grid, axes)


def block_over(w: torch.Tensor, grid, axes) -> torch.Tensor:
    """This rank's dim-0 block of ``w`` over ``axes`` (backward: the whole
    gradient, gathered)."""
    return w if _alone(grid, axes) else _Block.apply(w, grid, axes)


def reduce_over(x: torch.Tensor, grid, axes) -> torch.Tensor:
    """``x`` summed over the ring of ``axes`` (backward: summed too)."""
    return x if _alone(grid, axes) else _Reduce.apply(x, grid, axes)


def gather_block(x: torch.Tensor, grid, axes, dim: int = 0,
                 summed: bool = True) -> torch.Tensor:
    """The ring's blocks of ``x`` along ``dim`` over ``axes``, whole
    (backward: this rank's block of the gradient, reduce-scattered over
    the ring when ``summed``: the ring's ranks used the whole on
    different rows or different parts of it)."""
    if _alone(grid, axes):
        return x
    return _Gather.apply(x, grid, as_axes(axes), dim, summed)
