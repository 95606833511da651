"""The port's dry-run on reduced layouts (the full run is ``python -m
repro_torch.launch.dryrun --mesh both``): the mirrors of
``tests/test_dryrun.py`` on a rankless (2, 4) data x model layout with 2
microbatches, and the Ising cell on (2, 2, 2) pod x data x model; and
each cell's argument bytes against the reference's per-device shard sizes
of the same state and batch, exactly, on (2, 4) and 16 x 16. Every cell
runs on ``meta`` tensors with no process group."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.compat import abstract_mesh  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.configs.base import LM_SHAPES as JSHAPES  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch import dryrun_lib as jlib  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.analysis import roofline as JRL  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch.analysis import op_cost as OC  # noqa: E402
from repro_torch.launch import dryrun_lib as lib  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402

SMALL = mesh_lib.Layout((2, 4), ("data", "model"))
POD3 = mesh_lib.Layout((2, 2, 2), ("pod", "data", "model"))
CELLS = [("qwen3-0.6b", "train_4k"), ("mamba2-780m", "train_4k"),
         ("qwen3-0.6b", "prefill_32k"), ("qwen3-0.6b", "decode_32k"),
         ("recurrentgemma-2b", "long_500k"), ("qwen3-4b", "long_500k"),
         ("kimi-k2-1t-a32b", "decode_32k")]


@pytest.fixture(scope="module")
def records():
    """Each mirrored cell's record, run once (2 microbatches, as the
    reference's tests)."""
    out = {cell: lib.run_cell(*cell, SMALL, "test", microbatches=2)
           for cell in CELLS}
    out[("ising-20x128", "sweep")] = lib.run_cell(
        "ising-20x128", "sweep", POD3, "test")
    return out


def _ok(rec):
    assert rec["ok"], (rec.get("error"), rec.get("traceback"))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-780m"])
def test_train_cells_count_small_layout(records, arch):
    rec = records[(arch, "train_4k")]
    _ok(rec)
    assert not rec.get("skipped")
    assert rec["roofline"]["flops_per_device"] > 0


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_prefill_and_decode_cells_count(records, shape):
    rec = records[("qwen3-0.6b", shape)]
    _ok(rec)
    # decode updates its caches in place: aliased outputs
    if shape == "decode_32k":
        assert rec["memory"]["alias_gb"] > 0


def test_long500k_runs_for_subquadratic_skips_for_dense(records):
    rg = records[("recurrentgemma-2b", "long_500k")]
    dense = records[("qwen3-4b", "long_500k")]
    _ok(rg)
    assert not rg.get("skipped")
    assert dense["ok"] and dense["skipped"]
    want = jlib.skip_reason(jget_config("qwen3-4b"), JSHAPES["long_500k"])
    assert dense["reason"] == want


def test_ising_cell_counts_multi_pod_axes(records):
    rec = records[("ising-20x128", "sweep")]
    _ok(rec)
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    # the halo exchange: collective-permutes along both lattice axes
    assert rec["roofline"]["coll_by_kind"]["collective-permute"] > 0


def test_moe_cell_counts(records):
    _ok(records[("kimi-k2-1t-a32b", "decode_32k")])


def test_roofline_record_fields(records):
    """The reference's record with ``trace_s`` in place of ``lower_s`` /
    ``compile_s``, and ``fits``."""
    rec = records[("qwen3-0.6b", "prefill_32k")]
    _ok(rec)
    assert set(rec) == {"arch", "shape", "mesh", "n_devices", "ok",
                        "trace_s", "memory", "fits", "roofline"}
    rl = rec["roofline"]
    want = JRL.Roofline(1.0, 1.0, 1.0, 1.0, 1.0, 1.0).to_dict()
    assert set(rl) == set(want)
    assert rl["compute_s"] > 0 and rl["memory_s"] > 0
    mem = rec["memory"]
    assert set(mem) == {"argument_gb", "output_gb", "temp_gb", "alias_gb",
                        "peak_gb"}
    assert mem["peak_gb"] > 0
    assert rec["fits"] == (mem["peak_gb"] <= 80.0)


# ---------------------------------------------------------------------------
# argument bytes against the reference's shard sizes
# ---------------------------------------------------------------------------

ARG_ARCHS = list_configs()
ARG_LAYOUTS = [((2, 4), ("data", "model")), ((16, 16), ("data", "model"))]


def _shard_bytes(mesh, dims_tree, struct_tree, rules) -> int:
    """Sum over leaves of the reference's per-device shard bytes."""
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    is_dims = lambda x: isinstance(x, tuple) or x is None  # noqa: E731
    total = []

    def one(dims, a):
        spec = (() if dims is None else
                tuple(JSH.resolve_spec(mesh, tuple(dims), a.shape, rules)))
        shape = list(a.shape)
        for i, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            shape[i] //= math.prod(sizes[x] for x in axes)
        total.append(math.prod(shape) * np.dtype(a.dtype).itemsize)

    jax.tree.map(one, dims_tree, struct_tree, is_leaf=is_dims)
    return sum(total)


def _reference_argument_bytes(arch, shape_name, mesh) -> int:
    cfg = jget_config(arch)
    shape = JSHAPES[shape_name]
    rules = jlib.rules_for(cfg)
    batch = _shard_bytes(mesh, JM.batch_logical_dims(cfg, shape),
                         JM.input_specs(cfg, shape), rules)
    if shape.kind == "train":
        ocfg = jopt.OptimizerConfig(kind=cfg.optimizer)
        struct, specs = jlib.abstract_train_state(cfg, ocfg)
        dims = JTS.state_logical_dims(cfg, ocfg, specs, struct["params"])
        return batch + _shard_bytes(mesh, dims, struct, rules)
    struct, specs = jlib.abstract_params(cfg)
    params = _shard_bytes(mesh, specs, struct, rules)
    if shape.kind == "prefill":
        return batch + params
    states, dims = JM.decode_state_specs(cfg, shape)
    return batch + params + _shard_bytes(mesh, dims, states, rules)


@pytest.mark.parametrize("arch", ARG_ARCHS)
def test_argument_bytes_equal_reference_shards(arch):
    """A cell's ``argument_gb`` (this rank's state blocks and batch rows)
    is the sum of the reference's per-device shard sizes of the same
    state and batch, byte for byte, for train, prefill and decode."""
    for shape, axes in ARG_LAYOUTS:
        mesh = abstract_mesh(shape, axes)
        layout = mesh_lib.Layout(shape, axes)
        for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
            grid = mesh_lib.rankless_grid(layout)
            _, args, _ = lib.build_cell(arch, shape_name, grid)
            got = OC.OpCounter(args).argument_bytes
            want = _reference_argument_bytes(arch, shape_name, mesh)
            assert got == want, (arch, shape, shape_name, got, want)
