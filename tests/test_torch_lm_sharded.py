"""The LM sharding engine of the port against the JAX package on a 2 x 2
(data, model) grid: the expert-parallel MoE, the GSPMD MoE under a grid,
the sharded train step of three archs (two steps, two microbatches) and
the rows each rank trains on.

The port runs on 4 gloo ranks (one spawn for every case) while one JAX
subprocess on 4 virtual devices computes the references from the same
inputs (the reference's weights, carried over). f32 configs, the LM
tests' bounds: 1e-5 absolute on losses and outputs, 1e-4 of each leaf's
largest entry on grads, parameters and optimizer state; routing exactly.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import REPO, SRC, small_config  # noqa: E402
from repro.models import moe as JE  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import moe as E  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from test_torch_lm_moe import _jax_route  # noqa: E402

REL, ABS = 1e-4, 1e-5
GRID, AXES = (2, 2), ("data", "model")
ARCHS = ["qwen3-0.6b", "kimi-k2-1t-a32b", "musicgen-medium"]
SEQ, BATCH, MICRO, STEPS = 16, 8, 2, 2
SHAPE = ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")
MOE_ARCH = "kimi-k2-1t-a32b"
# name -> (overrides of kimi's small config, expert parallel or GSPMD)
EP_CASES = {"ep": ({}, True), "ep_indivisible": ({"n_experts": 3}, True),
            "gspmd": ({}, False)}
EP_X = (4, 16)                     # [B, S] of the MoE layer's input
DATA_CASES = [(a, m) for a in ("qwen3-0.6b", "musicgen-medium",
                               "qwen2-vl-7b") for m in (1, 2, 4)]


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


def _ep_cfg(name):
    return small_config(MOE_ARCH, dtype="float32", **EP_CASES[name][0])


def _ocfg(mod, cfg):
    return mod.OptimizerConfig(kind=cfg.optimizer, lr=1e-3, warmup_steps=1)


def _inputs() -> dict:
    """The reference's initial states and MoE weights, and the MoE input."""
    out = {"train": {}, "ep": {}}
    for arch in ARCHS:
        jcfg = small_config(arch, dtype="float32")
        state, _ = JTS.init_train_state(jax.random.PRNGKey(0), jcfg,
                                        _ocfg(jopt, jcfg))
        out["train"][arch] = jax.tree.map(np.asarray, state)
    for name in EP_CASES:
        jcfg = _ep_cfg(name)
        p, _ = JE.init_moe(jax.random.PRNGKey(0), jcfg)
        x = np.random.default_rng(1).standard_normal(
            EP_X + (jcfg.d_model,)).astype(np.float32)
        out["ep"][name] = (jax.tree.map(np.asarray, p), x)
    return out


_JAX_RUNS = """
import pickle, sys
sys.path.insert(0, "tests")
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from conftest import small_config
from repro.configs.base import ShapeConfig
from repro.data import synthetic as syn
from repro.distributed import sharding as SH
from repro.launch import dryrun_lib as lib
from repro.launch import mesh as mesh_lib
from repro.models import moe
from repro.train import optimizer as OPT
from repro.train import train_step as TS

mesh = mesh_lib.make_mesh((2, 2), ("data", "model"))
with open(PATH + ".in", "rb") as f:
    inp = pickle.load(f)
out = {"device_ids": [[d.id for d in row] for row in mesh.devices]}
for name, (over, ep) in EP_CASES.items():
    cfg = small_config(MOE_ARCH, dtype="float32", **over)
    p = jax.tree.map(jnp.asarray, inp["ep"][name][0])
    x = jnp.asarray(inp["ep"][name][1])

    def f(p_, x_):
        if ep:
            return moe.moe_forward_ep(p_, cfg, x_, mesh)
        return moe.moe_forward_gspmd(p_, cfg, x_)

    def loss(p_, x_):
        y, aux = f(p_, x_)
        return jnp.sum(y * y) + 0.01 * aux

    with SH.activation_sharding(mesh):
        y, aux = jax.jit(f)(p, x)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
    out[("ep", name)] = (np.asarray(y), np.asarray(aux),
                         jax.tree.map(np.asarray, gp), np.asarray(gx))

shape = ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")
for arch in ARCHS:
    cfg = small_config(arch, dtype="float32")
    rules = lib.rules_for(cfg)
    ocfg = OPT.OptimizerConfig(kind=cfg.optimizer, lr=1e-3, warmup_steps=1)
    state = jax.tree.map(jnp.asarray, inp["train"][arch])
    _, specs = lib.abstract_params(cfg)
    dims = TS.state_logical_dims(cfg, ocfg, specs, state["params"])
    sh = SH.resolve_tree(mesh, dims, state, rules)
    state = jax.device_put(state, sh)
    bsh = {k: v.sharding
           for k, v in lib.batch_sds(cfg, shape, mesh, rules).items()}
    metrics = []
    with SH.activation_sharding(mesh, rules):
        step = jax.jit(TS.make_train_step(cfg, ocfg, MICRO),
                       in_shardings=(sh, bsh))
        for i in range(STEPS):
            state, m = step(state, syn.sharded_batch(i, shape, cfg, bsh))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    shards = [(tuple(s.spec), s.shard_shape(a.shape)) for a, s in zip(
        jax.tree.leaves(state), jax.tree.leaves(sh))]
    out[("train", arch)] = (metrics, jax.tree.map(np.asarray, state),
                            shards)

for arch, m in DATA_CASES:
    cfg = small_config(arch)
    rules = lib.rules_for(cfg)
    bsh = {k: v.sharding
           for k, v in lib.batch_sds(cfg, shape, mesh, rules).items()}
    batch = syn.sharded_batch(3, shape, cfg, bsh)
    per_dev = {}
    for name, arr in batch.items():
        # the reference's microbatches [m, B/m, ...], each placed as its
        # activations are (the batch dim resolved on B/m)
        full = np.asarray(arr)
        mb = full.reshape((m, BATCH // m) + full.shape[1:])
        axes = SH.resolve_spec(mesh, ("batch",), (BATCH // m,), rules)[0]
        placed = jax.device_put(mb, NamedSharding(mesh, P(None, axes)))
        for s in placed.addressable_shards:
            d = np.asarray(s.data)
            per_dev.setdefault(s.device.id, {})[name] = d.reshape(
                (-1,) + d.shape[2:])
        if m == 1:   # the reference's own shards
            for s in arr.addressable_shards:
                np.testing.assert_array_equal(
                    per_dev[s.device.id][name], np.asarray(s.data))
    out[("data", arch, m)] = per_dev
with open(PATH, "wb") as f:
    pickle.dump(out, f)
"""


def _start_jax(path):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    code = (f"PATH = {str(path)!r}\nEP_CASES = {EP_CASES!r}\n"
            f"MOE_ARCH = {MOE_ARCH!r}\nARCHS = {ARCHS!r}\n"
            f"DATA_CASES = {DATA_CASES!r}\nSEQ, BATCH, MICRO, STEPS = "
            f"{SEQ}, {BATCH}, {MICRO}, {STEPS}\n"
            + textwrap.dedent(_JAX_RUNS))
    return subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _ep_body(grid, name, p_np, x_np):
    """One MoE case on this rank: y, aux and the grads of sum(y^2) +
    0.01 aux (params summed over the batch axes, x and y gathered)."""
    cfg = port_cfg(_ep_cfg(name))
    ep = EP_CASES[name][1]
    if not ep:
        cfg = dataclasses.replace(cfg, moe_impl="gspmd")
    rules = SH.rules_for(cfg)
    axes, rows = SH.batch_rows(grid, rules, EP_X[0])
    p = bridge._tree_to_torch(p_np, "cpu")
    leaves = [a.requires_grad_() for a in tree.leaves(p)]
    x = torch.from_numpy(x_np)[rows].requires_grad_()
    with SH.activation_sharding(grid, rules, axes):
        y, aux = E.moe_forward(p, cfg, x)
        if ep:   # the dispatch took the expert-parallel form
            y2, aux2 = E.moe_forward_ep(p, cfg, x, grid)
            assert torch.equal(y, y2) and torch.equal(aux, aux2)
        grads = torch.autograd.grad(torch.sum(y * y) + 0.01 * aux,
                                    leaves + [x])
    gp = tree.unflatten(p, [grid.psum(g, axes) for g in grads[:-1]])
    return (grid.all_gather(y, axes).detach(), aux.detach(), gp,
            grid.all_gather(grads[-1], axes))


def _train_body(grid, arch, init):
    """Two sharded steps from the carried state: metrics, the gathered
    state, this rank's block shapes and the placements."""
    cfg = port_cfg(small_config(arch, dtype="float32"))
    ocfg = _ocfg(opt, cfg)
    rules = SH.rules_for(cfg)
    places = TS.state_placements(cfg, ocfg, grid, rules)
    blocks = (grid, places)
    state = {"params": bridge.lm_params_from_jax(
                 init["params"], cfg, blocks=(grid, places["params"])),
             "opt": bridge.opt_state_from_jax(
                 init["opt"], blocks=(grid, places["opt"])),
             "step": torch.tensor(0, dtype=torch.int32)}
    axes, rows = SH.batch_rows(grid, rules, BATCH, MICRO)
    step = TS.make_sharded_train_step(cfg, ocfg, *blocks, axes, rules, MICRO)
    metrics = []
    for i in range(STEPS):
        state, m = step(state, syn.device_batch(i, SHAPE, cfg, "cpu",
                                                rows=rows))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    shapes = [tuple(a.shape) for a in tree.leaves(state)]
    full = tree.map(lambda a, pl: grid.gather(a, pl), state, places)
    return metrics, full, shapes, places


def _port_body(inputs):
    grid = mesh_lib.make_grid(GRID, AXES, "cpu")
    out = {}
    for name, (p_np, x_np) in inputs["ep"].items():
        out[("ep", name)] = _ep_body(grid, name, p_np, x_np)
    for arch in ARCHS:
        out[("train", arch)] = _train_body(grid, arch, inputs["train"][arch])
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm_sharded") / "jax.pkl"
    inputs = _inputs()
    with open(str(path) + ".in", "wb") as f:
        pickle.dump(inputs, f)
    proc = _start_jax(path)
    port = mesh_lib.run_ranks(_port_body, 4, inputs)
    stdout, stderr = proc.communicate(timeout=900)
    if proc.returncode:
        raise AssertionError(f"JAX runs failed:\n{stdout}\n{stderr}")
    with open(path, "rb") as f:
        return port, pickle.load(f), inputs


def _close(got, want, what, rel=REL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    bound = rel * max(float(np.abs(want).max()) if want.size else 0.0,
                      1e-30)
    assert err <= bound, (what, err, bound)


def _trees_close(got, want):
    jl = jax.tree.leaves(want)
    tl = tree.paths(got)
    assert len(jl) == len(tl)
    for (path, g), w in zip(tl, jl):
        if np.asarray(w).dtype == np.int32:
            assert int(g) == int(w), path
        else:
            _close(g, w, path)


@pytest.mark.parametrize("name", list(EP_CASES))
def test_moe_on_a_grid_matches_jax(results, name):
    """The MoE layer on the 2 x 2 grid (EP over "model", EP with 3 experts
    on a 2-way model axis, which falls back to local dispatch, and GSPMD
    routing of the whole microbatch): y, aux, every parameter's grad and
    the input's, against the JAX layer on 4 virtual devices."""
    port, jax_out, _ = results
    y, aux, gp, gx = port[("ep", name)]
    jy, jaux, jgp, jgx = jax_out[("ep", name)]
    assert abs(float(aux) - float(jaux)) <= ABS
    assert float(np.abs(y.numpy() - jy).max()) <= ABS
    _trees_close(gp, jgp)
    _close(gx, jgx, "x")


def test_ep_shards_route_as_the_reference():
    """Each shard's routing plan under EP (its local tokens' capacity, its
    expert range e_lo = model index x E / 2), exactly, from the same
    logits, on every shard of the 2 x 2 grid."""
    for name in ("ep", "ep_indivisible"):
        jcfg = _ep_cfg(name)
        cfg = port_cfg(jcfg)
        p, _ = JE.init_moe(jax.random.PRNGKey(0), jcfg)
        x = np.random.default_rng(1).standard_normal(
            EP_X + (jcfg.d_model,)).astype(np.float32)
        e_par = 2 if jcfg.n_experts % 2 == 0 else 1
        e_local = jcfg.n_experts // e_par
        t_local = (EP_X[0] // 2) * EP_X[1]
        cap = JE.capacity(jcfg, t_local)
        assert cap == E.capacity(cfg, t_local)
        for d in range(2):
            xs = jnp.asarray(x[2 * d:2 * d + 2].reshape(t_local, -1))
            logits = np.asarray(xs @ p["router"])
            for m in range(e_par):
                want = _jax_route(jcfg, jnp.asarray(logits), m * e_local,
                                  e_local, cap)
                got = E.route(cfg, torch.from_numpy(logits.copy()), m * e_local,
                              e_local, cap)
                for k in ("gate_idx", "order", "keep", "dest", "counts"):
                    np.testing.assert_array_equal(
                        got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_jax(results, arch):
    """Two steps of two microbatches on the 2 x 2 grid (qwen3: AdamW,
    default rules; kimi: Adafactor, FSDP, EP; musicgen: the batch over
    (data, model), codebooks) against the JAX jitted step on the (2, 2)
    mesh: losses, grad norms, the gathered parameters and optimizer
    state; each rank's block shapes are the reference's shard shapes and
    its placements the reference's PartitionSpecs."""
    port, jax_out, _ = results
    metrics, full, shapes, places = port[("train", arch)]
    jmetrics, jstate, jshards = jax_out[("train", arch)]
    for (loss, gnorm), (jloss, jgnorm) in zip(metrics, jmetrics):
        assert abs(loss - jloss) <= ABS, (loss, jloss)
        assert abs(gnorm - jgnorm) <= REL * jgnorm, (gnorm, jgnorm)
    _trees_close(full["params"], jstate["params"])
    _trees_close(full["opt"], jstate["opt"])
    assert shapes == [tuple(s) for _, s in jshards]
    got = tree.leaves(tree.map(lambda a, pl: _Leaf(pl), full, places))
    assert [g.value for g in got] == [tuple(spec) for spec, _ in jshards]


class _Leaf:
    """A placement held as one leaf (tree.leaves walks into tuples)."""

    def __init__(self, value):
        self.value = value


@pytest.mark.parametrize("arch,m", DATA_CASES,
                         ids=[f"{a}-m{m}" for a, m in DATA_CASES])
def test_each_rank_builds_the_reference_rows(results, arch, m):
    """Each rank's rows of step 3's batch (built from its own (step, row)
    counters, never the global batch) equal the reference's shards of
    each microbatch, in microbatch order; with one microbatch they are
    the reference's ``sharded_batch`` shards."""
    _, jax_out, _ = results
    per_dev = jax_out[("data", arch, m)]
    ids = jax_out["device_ids"]
    cfg = port_cfg(small_config(arch))
    rules = SH.rules_for(cfg)
    for rank in range(4):
        grid = mesh_lib.DeviceGrid(GRID, AXES, rank, torch.device("cpu"))
        _, rows = SH.batch_rows(grid, rules, BATCH, m)
        got = syn.host_batch(3, SHAPE, cfg, rows=rows)
        want = per_dev[ids[rank // 2][rank % 2]]
        assert got.keys() == want.keys()
        for name in got:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"rank {rank} {name}")


@pytest.mark.parametrize("arch,micro", [("qwen3-0.6b", 2),
                                        ("kimi-k2-1t-a32b", 1),
                                        ("musicgen-medium", 2)])
def test_one_shard_grid_step_is_the_unsharded_step_bitwise(arch, micro):
    """On a (1, 1) grid the sharded step (identity gathers and reductions,
    every block the whole tensor) is the unsharded step, bitwise: losses,
    grad norms and the state after two steps."""
    cfg = port_cfg(small_config(arch, dtype="float32"))
    ocfg = _ocfg(opt, cfg)
    grid = mesh_lib.make_grid((1, 1), AXES, "cpu")
    places = TS.state_placements(cfg, ocfg, grid)
    axes, rows = SH.batch_rows(grid, SH.rules_for(cfg), BATCH, micro)
    assert rows == list(range(BATCH))
    steps = [TS.make_train_step(cfg, ocfg, micro),
             TS.make_sharded_train_step(cfg, ocfg, grid, places, axes,
                                        microbatches=micro)]
    outs = []
    for step in steps:
        state = TS.init_train_state(cfg, ocfg,
                                    torch.Generator().manual_seed(0))
        ms = []
        for i in range(2):
            state, m = step(state, syn.device_batch(i, SHAPE, cfg, "cpu"))
            ms.append((m["loss"], m["grad_norm"]))
        outs.append((ms, state))
    for (a, b), (c, d) in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, c) and torch.equal(b, d)
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(outs[0][1]), tree.leaves(outs[1][1])))
