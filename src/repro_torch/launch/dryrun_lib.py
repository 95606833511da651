"""Dry-run machinery: count one rank's program of every (arch x shape x
layout) cell with production shardings, and derive its memory and
three-term roofline (the port of ``repro.launch.dryrun_lib``).

The reference lowers and compiles each cell for 512 placeholder devices
and reads XLA's memory and cost analyses. Here nothing compiles and no
rank exists: a cell is one chosen rank of a production
:class:`~repro_torch.launch.mesh.Layout` as a rankless grid
(``launch.mesh.rankless_grid``), its state blocks and batch rows are
``meta`` tensors with the shapes the rules give that rank, and the cell's
function (the sharded train step, prefill or decode step, or the
decomposed Ising sweep) runs once on them under
:class:`~repro_torch.analysis.op_cost.OpCounter`. No array is allocated
and no process group is initialised; the collectives are recorded, not
sent. A record's ``trace_s`` (the time of that run) takes the place of
the reference's ``lower_s`` / ``compile_s``, and ``fits`` says whether the
rank's peak fits one H100's 80 GB.
"""
from __future__ import annotations

import math
import time
import traceback
from typing import Optional

import torch

from repro_torch import random as jr
from repro_torch import tree
from repro_torch.analysis import op_cost
from repro_torch.analysis import roofline as RL
from repro_torch.configs import get_config, get_ising_config, list_configs
from repro_torch.configs.base import LM_SHAPES
from repro_torch.core.lattice import torch_dtype
from repro_torch.distributed import ising as dising
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.models import transformer
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

# device memory of one H100 SXM (NVIDIA data sheet), the bound of ``fits``
DEVICE_GB = 80.0

# per-arch gradient-accumulation defaults for train_4k (the reference's)
MICROBATCHES = {
    "kimi-k2-1t-a32b": 8, "llama4-maverick-400b-a17b": 8,
    "command-r-35b": 16, "nemotron-4-15b": 8, "qwen2-vl-7b": 1,
    "qwen3-4b": 8, "recurrentgemma-2b": 4, "qwen3-0.6b": 4,
    "musicgen-medium": 1, "mamba2-780m": 4,
}

def _blocks(grid, full_tree, placements):
    """``meta`` tensors of this rank's block shapes (fresh storages, so
    each argument counts at its block's size)."""
    def one(a, p):
        shape = list(a.shape)
        for dim, axes in enumerate(p):
            shape[dim] //= grid.axis_size(axes)
        return torch.empty(shape, dtype=a.dtype, device="meta")
    return tree.map(one, full_tree, placements)


def batch_blocks(cfg, shape, grid, rules, microbatches: int = 1):
    """(this rank's rows of the cell's batch on ``meta``, the axes they are
    split over). Decode's ``pos`` is the reference's int32 scalar, here on
    the host (the step reads it as a static index): the cache's last
    slot."""
    axes, rows = SH.batch_rows(grid, rules, shape.global_batch,
                               microbatches)
    batch = {}
    for k, v in M.input_specs(cfg, shape).items():
        batch[k] = (torch.tensor(shape.seq_len - 1, dtype=torch.int32)
                    if k == "pos" else
                    torch.empty((len(rows),) + tuple(v.shape[1:]),
                                dtype=v.dtype, device="meta"))
    return batch, axes


# ---------------------------------------------------------------------------
# cell builders: return (fn, args); the state and parameters are
# ``meta`` templates of the global trees cut to this rank's blocks
# ---------------------------------------------------------------------------


def build_train_cell(cfg, shape, grid, microbatches: Optional[int] = None):
    rules = SH.rules_for(cfg)
    opt_cfg = OPT.OptimizerConfig(kind=cfg.optimizer)
    micro = microbatches or MICROBATCHES.get(cfg.name, 4)
    state = TS.init_train_state(cfg, opt_cfg, None, "meta")
    places = TS.state_placements(cfg, opt_cfg, grid, rules)
    batch, axes = batch_blocks(cfg, shape, grid, rules, micro)
    fn = TS.make_sharded_train_step(cfg, opt_cfg, grid, places, axes, rules,
                                    micro)
    return fn, (_blocks(grid, state, places), batch)


def _param_blocks(cfg, grid, rules):
    params = transformer.init_model(cfg, None, "meta")
    places = SH.resolve_tree(grid, transformer.model_specs(cfg), params,
                             rules)
    return _blocks(grid, params, places), places


def build_prefill_cell(cfg, shape, grid):
    rules = SH.rules_for(cfg)
    blocks, places = _param_blocks(cfg, grid, rules)
    batch, axes = batch_blocks(cfg, shape, grid, rules)
    sp = M.decode_state_placements(cfg, grid, shape.global_batch,
                                   shape.seq_len, rules)
    fn = M.make_sharded_prefill(cfg, grid, places, axes, sp, rules)
    return fn, (blocks, batch)


def build_decode_cell(cfg, shape, grid):
    rules = SH.rules_for(cfg)
    blocks, places = _param_blocks(cfg, grid, rules)
    batch, axes = batch_blocks(cfg, shape, grid, rules)
    states, _ = M.decode_state_specs(cfg, shape)
    sp = M.decode_state_placements(cfg, grid, shape.global_batch,
                                   shape.seq_len, rules)
    fn = M.make_sharded_decode_step(cfg, grid, places, axes, sp, rules)
    return fn, (blocks, _blocks(grid, states, sp), batch)


def build_ising_cell(icfg, grid, pipeline: str = "paper",
                     bits_dtype: str = "uint32", rng: str = "threefry"):
    """The paper's own architecture: one multi-rank sweep step, each rank
    holding ``height_blocks x width_blocks`` tiles of each quad."""
    dcfg = dising.DistIsingConfig(
        beta=icfg.beta, block_size=icfg.block_size,
        row_axes=mesh_lib.data_axes(grid), col_axes=("model",),
        backend="xla", prob_dtype="bfloat16", pipeline=pipeline,
        bits_dtype=bits_dtype, rng=rng)
    bs = icfg.block_size
    quad = (icfg.height_blocks, icfg.width_blocks, bs, bs)
    quads = tuple(torch.empty(quad, dtype=torch_dtype(icfg.dtype),
                              device="meta")
                  for _ in range(4))
    fn = dising.make_sweep_tuple_fn(grid, dcfg)
    return fn, quads + (jr.PRNGKey(0), 0)


# ---------------------------------------------------------------------------
# run one cell
# ---------------------------------------------------------------------------


def skip_reason(cfg, shape) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: 512k dense-cache decode excluded by "
                "design (see DESIGN.md §7)")
    return None


def build_cell(arch: str, shape_name: str, grid,
               microbatches: Optional[int] = None):
    """(fn, args, model FLOPs) of one cell on ``grid``. Ising cells run
    the production pipeline (opt, uint16 bits, rbg)."""
    n_dev = grid.size
    if arch.startswith("ising"):
        icfg = get_ising_config(arch)
        fn, args = build_ising_cell(icfg, grid, pipeline="opt",
                                    bits_dtype="uint16", rng="rbg")
        return fn, args, RL.ising_model_flops(
            icfg.height_blocks, icfg.width_blocks, icfg.block_size, n_dev)
    cfg = get_config(arch)
    shape = LM_SHAPES[shape_name]
    if shape.kind == "train":
        fn, args = build_train_cell(cfg, shape, grid, microbatches)
    else:
        builder = {"prefill": build_prefill_cell,
                   "decode": build_decode_cell}[shape.kind]
        fn, args = builder(cfg, shape, grid)
    return fn, args, RL.lm_model_flops(cfg, shape)


def run_cell(arch: str, shape_name: str, layout, layout_name: str,
             microbatches: Optional[int] = None) -> dict:
    """Count one cell; returns a JSON-able record."""
    n_dev = math.prod(layout.shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": layout_name,
           "n_devices": int(n_dev), "ok": False}
    try:
        if not arch.startswith("ising"):
            reason = skip_reason(get_config(arch), LM_SHAPES[shape_name])
            if reason:
                rec.update(ok=True, skipped=True, reason=reason)
                return rec
        grid = mesh_lib.rankless_grid(layout, 0)
        fn, args, model_flops = build_cell(arch, shape_name, grid,
                                           microbatches)
        t0 = time.time()
        out, counter = op_cost.count(fn, *args, records=grid.records)
        trace_s = time.time() - t0
        mem = counter.memory(out)
        rl = RL.from_cost(counter.cost(), n_dev, model_flops)
        rec.update(ok=True, trace_s=round(trace_s, 2), memory=mem,
                   fits=mem["peak_gb"] <= DEVICE_GB, roofline=rl.to_dict())
    except Exception as e:  # noqa: BLE001 — a failed cell is a result
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def default_cells() -> list[tuple[str, str]]:
    """Every registered arch at every LM shape, and the two production
    Ising cells."""
    return ([(a, s) for a in list_configs() for s in LM_SHAPES]
            + [("ising-640x128", "sweep"), ("ising-pod", "sweep")])
