"""Tensor-parallel compute along "model" in the port's sharded train step,
prefill and decode, against the JAX package's sharded functions.

Each rank computes its blocks (heads, kv heads, ffn columns, vocab rows,
RG-LRU channels, SSM heads, experts) as GSPMD partitions the reference.
Two grids: 2 x 2 (data, model), and 1 x 4 (model), where the small
configs' 2 kv heads do not divide the model axis (each rank then projects
the one kv head its q head reads). Five archs: qwen3-0.6b (AdamW),
kimi-k2 (EP + TP + FSDP, Adafactor), musicgen-medium (the batch over
(data, model), codebooks), recurrentgemma-2b ('rrl') and mamba2-780m;
and two fallbacks (``MODELS``): q heads that read kv heads unevenly on
2 x 2, SSM heads that do not divide the axis on 1 x 4.

For each grid one spawn of 4 gloo ranks runs, per model, two train steps
of two microbatches and a sharded prefill of a 12-token prompt into a
16-slot cache with 4 decode steps, from the reference's weights carried
over; one JAX subprocess on 4 virtual devices runs the reference's jitted
step, prefill and decode with the same shardings. f32 configs, the LM
bounds: 1e-5 absolute on losses and logits, 1e-4 of each leaf's largest
entry on gradients (their norm), parameters, optimizer and decode states
(AdamW's parameters but for the entries ``test_torch_lm_ssm`` also leaves
out, a first-step gradient that cancels to f32 noise, and an entry where
the port's unsharded step misses the reference too and the sharded step
lies within the bound of it: ``_trees_close``); routing exactly. Rank 0's
collectives of the first step equal a rankless rank's of the same step
(the dry-run's), and a gather's gradient that the ring sums comes back
as a reduce-scatter. One more JAX run, the reference's unsharded step
of recurrentgemma on 1 x 4, shows where the ``twin`` excuse applies the
reference's own two programs differ beyond the bound; the RG-LRU gates'
ops, differentiated in torch's order and in the reference's, move that
entry and each op's gradient by rounding only.

One rankless rank of a 2 x 4 layout counts the matrix-product FLOPs of
qwen3-0.6b's (small) sharded step within 5% of the ``dot`` FLOPs of the
reference's compiled sharded step on 8 virtual devices (each device's
program), the gap written out term by term. The stacked layers' gradient
(one autograd Function around the unbind) is bitwise the per-layer
indexing it replaces.
"""
import dataclasses
import functools
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
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.analysis import op_cost as OC  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun_lib as lib  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as E  # noqa: E402
from repro_torch.models import rglru as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from test_torch_lm_moe import _jax_route  # noqa: E402

REL, ABS = 1e-4, 1e-5
AXES = ("data", "model")
GRIDS = {"2x2": (2, 2), "1x4": (1, 4)}
ARCHS = ["qwen3-0.6b", "kimi-k2-1t-a32b", "musicgen-medium",
         "recurrentgemma-2b", "mamba2-780m"]
# name -> (arch, overrides of its small config); the two fallbacks: 6 q
# heads and 3 kv heads on a 2-way model axis (each rank's 3 q heads read
# kv heads unevenly: the attention's heads are gathered and computed
# alike on the ring), and mamba2 with 6 SSM heads on a 4-way axis (heads
# whole, its conv and norm channels and out_proj rows still split: they
# are gathered)
MODELS = dict({a: (a, {}) for a in ARCHS},
              **{"qwen3-uneven-gqa": ("qwen3-0.6b",
                                      {"n_heads": 6, "n_kv_heads": 3}),
                 "mamba2-whole-heads": ("mamba2-780m", {"d_model": 48})})
GRID_MODELS = {"2x2": ARCHS + ["qwen3-uneven-gqa"],
               "1x4": ARCHS + ["mamba2-whole-heads"]}
MOE_ARCH = "kimi-k2-1t-a32b"
SEQ, BATCH, MICRO, STEPS = 16, 8, 2, 2
SB, PROMPT, MAX_LEN, DECODES = 4, 12, 16, 4
SHAPE = ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")
# the arch whose entry lies beyond the bound of the reference's sharded
# step in both the port's steps and the reference's own unsharded one
GAP_ARCH, GAP_LEAF, GAP_ENTRY = "recurrentgemma-2b", "layers/1/rec/b_r", 2
# the models whose step reduce-scatters gradients of its gathers: kimi's
# FSDP blocks over "data" (one data rank on 1 x 4), musicgen's blocks
# over "model" (its batch axis too), the RG-LRU gates' input and mamba2's
# in_proj and conv weights over "model"
SCATTERING = {"2x2": {"kimi-k2-1t-a32b", "musicgen-medium",
                      "recurrentgemma-2b", "mamba2-780m"},
              "1x4": {"musicgen-medium", "recurrentgemma-2b",
                      "mamba2-780m"}}
COUNT_GRID = (2, 4)
COUNT_SHAPE = ShapeConfig("c", seq_len=32, global_batch=8, kind="train")
MATMUL_REL = 0.05


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


def _jcfg(name):
    arch, over = MODELS[name]
    return small_config(arch, dtype="float32", **over)


def _ocfg(mod, cfg):
    return mod.OptimizerConfig(kind=cfg.optimizer, lr=1e-3, warmup_steps=1)


def _tokens(cfg, b, n, seed):
    shape = (b, n, cfg.n_codebooks) if cfg.n_codebooks else (b, n)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _inputs() -> dict:
    """Per model: the reference's initial train state, the prompt and the
    decode tokens."""
    out = {}
    for name in MODELS:
        jcfg = _jcfg(name)
        state, _ = JTS.init_train_state(jax.random.PRNGKey(0), jcfg,
                                        _ocfg(jopt, jcfg))
        out[name] = (jax.tree.map(np.asarray, state),
                     _tokens(jcfg, SB, PROMPT, 1),
                     [_tokens(jcfg, SB, 1, 2 + i) for i in range(DECODES)])
    return out


_JAX_RUNS = """
import pickle, sys
sys.path.insert(0, "tests")
import numpy as np
import jax
import jax.numpy as jnp
from conftest import small_config
from repro.configs.base import ShapeConfig
from repro.data import synthetic as syn
from repro.distributed import sharding as SH
from repro.launch import dryrun_lib as lib
from repro.launch import mesh as mesh_lib
from repro.models import model as M
from repro.models import transformer as JT
from repro.train import optimizer as OPT
from repro.train import train_step as TS

mesh = mesh_lib.make_mesh(GRID, ("data", "model"))
with open(PATH + ".in", "rb") as f:
    inp = pickle.load(f)
out = {}
shape = ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")
pshape = ShapeConfig("p", seq_len=PROMPT, global_batch=SB, kind="prefill")
dshape = ShapeConfig("d", seq_len=MAX_LEN, global_batch=SB, kind="decode")
for arch in NAMES:
    cfg = small_config(MODELS[arch][0], dtype="float32", **MODELS[arch][1])
    rules = lib.rules_for(cfg)
    ocfg = OPT.OptimizerConfig(kind=cfg.optimizer, lr=1e-3, warmup_steps=1)
    init, prompt, toks = inp[arch]
    state = jax.tree.map(jnp.asarray, init)
    _, specs = lib.abstract_params(cfg)
    dims = TS.state_logical_dims(cfg, ocfg, specs, state["params"])
    sh = SH.resolve_tree(mesh, dims, state, rules)
    state = jax.device_put(state, sh)
    bsh = {k: v.sharding
           for k, v in lib.batch_sds(cfg, shape, mesh, rules).items()}
    metrics, noise = [], None
    with SH.activation_sharding(mesh, rules):
        step = jax.jit(TS.make_train_step(cfg, ocfg, MICRO),
                       in_shardings=(sh, bsh))
        for i in range(STEPS):
            state, m = step(state, syn.sharded_batch(i, shape, cfg, bsh))
            state = jax.device_put(state, sh)   # as the next step takes it
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0 and "m" in state["opt"]:
                noise = jax.tree.map(
                    lambda v: np.asarray((v > 0) & (v < 1e-12 * v.max())),
                    state["opt"]["v"])
    shards = [s.shard_shape(a.shape) for a, s in zip(
        jax.tree.leaves(state), jax.tree.leaves(sh))]
    out[("train", arch)] = (metrics, jax.tree.map(np.asarray, state),
                            shards, noise)

    psh = SH.resolve_tree(mesh, specs, init["params"], rules)
    params = jax.device_put(jax.tree.map(jnp.asarray, init["params"]), psh)
    pbsh = {k: v.sharding for k, v in
            lib.batch_sds(cfg, pshape, mesh, rules).items()}
    dbsh = {k: v.sharding for k, v in
            lib.batch_sds(cfg, dshape, mesh, rules).items()}

    def prefill(p, b):
        logits, st = JT.prefill(p, cfg, b, MAX_LEN)
        return logits[:, -1:], st

    with SH.activation_sharding(mesh, rules):
        logits, states = jax.jit(prefill, in_shardings=(psh, pbsh))(
            params, {"tokens": jnp.asarray(prompt)})
        _, sdims = M.decode_state_specs(cfg, dshape)
        ssh = SH.resolve_tree(mesh, sdims, states, rules)
        states = jax.device_put(states, ssh)
        decode = jax.jit(M.make_decode_step(cfg),
                         in_shardings=(psh, ssh, dbsh))
        seen = [np.asarray(logits)]
        for i, tok in enumerate(toks):
            dl, states = decode(params, states, {
                "tokens": jnp.asarray(tok), "pos": jnp.int32(PROMPT + i)})
            states = jax.device_put(states, ssh)
            seen.append(np.asarray(dl))
    out[("serve", arch)] = (seen, jax.tree.map(np.asarray, states))
    if arch in UNSHARDED:
        ustep = jax.jit(TS.make_train_step(cfg, ocfg, MICRO))
        state = jax.tree.map(jnp.asarray, init)
        for i in range(STEPS):
            host = syn.sharded_batch(i, shape, cfg, bsh)
            state, _ = ustep(state, {k: jnp.asarray(np.asarray(v))
                                     for k, v in host.items()})
        out[("unsharded", arch)] = jax.tree.map(np.asarray, state["params"])
with open(PATH, "wb") as f:
    pickle.dump(out, f)
"""

_JAX_COUNT = """
import pickle, sys
sys.path.insert(0, "tests")
import jax
import jax.numpy as jnp
from conftest import small_config
from repro.analysis import hlo_cost as JHC
from repro.configs.base import ShapeConfig
from repro.distributed import sharding as SH
from repro.launch import dryrun_lib as lib
from repro.launch import mesh as mesh_lib
from repro.train import optimizer as OPT
from repro.train import train_step as TS


class DotsOnly(JHC.CostModel):
    def _op_flops(self, comp, op):
        if op.opcode != "dot":
            return JHC.Cost()
        return super()._op_flops(comp, op)


mesh = mesh_lib.make_mesh(GRID, ("data", "model"))
cfg = small_config("qwen3-0.6b", dtype="float32")
rules = lib.rules_for(cfg)
ocfg = OPT.OptimizerConfig(kind=cfg.optimizer)
shape = ShapeConfig("c", seq_len=SEQ, global_batch=BATCH, kind="train")
state, specs = lib.abstract_train_state(cfg, ocfg)
dims = TS.state_logical_dims(cfg, ocfg, specs, state["params"])
sh = SH.resolve_tree(mesh, dims, state, rules)
sds = lib.batch_sds(cfg, shape, mesh, rules)
with SH.activation_sharding(mesh, rules):
    hlo = jax.jit(TS.make_train_step(cfg, ocfg, MICRO),
                  in_shardings=(sh, {k: v.sharding for k, v in sds.items()})
                  ).lower(state, sds).compile().as_text()
with open(PATH, "wb") as f:
    pickle.dump(DotsOnly(hlo).total().flops, f)
"""


def _start(path, code, devices, **consts):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    head = "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    return subprocess.Popen(
        [sys.executable, "-c",
         f"PATH = {str(path)!r}\n" + head + textwrap.dedent(code)],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _train_body(grid, name, init):
    """Two sharded steps from the carried state: metrics, the gathered
    state, this rank's block shapes and the first step's collectives."""
    cfg = port_cfg(_jcfg(name))
    ocfg = _ocfg(opt, cfg)
    rules = SH.rules_for(cfg)
    places = TS.state_placements(cfg, ocfg, grid, rules)
    state = {"params": bridge.lm_params_from_jax(
                 init["params"], cfg, blocks=(grid, places["params"])),
             "opt": bridge.opt_state_from_jax(
                 init["opt"], blocks=(grid, places["opt"])),
             "step": torch.tensor(0, dtype=torch.int32)}
    # the dicts in the order the port initialises them (the carried ones
    # are sorted), as the dry-run's: the step issues its gradients'
    # collectives in that order
    state = tree.map(lambda _, x: x,
                     TS.init_train_state(cfg, ocfg, None, "meta"), state)
    axes, rows = SH.batch_rows(grid, rules, BATCH, MICRO)
    step = TS.make_sharded_train_step(cfg, ocfg, grid, places, axes, rules,
                                      MICRO)
    metrics = []
    for i in range(STEPS):
        del grid.records[:]
        state, m = step(state, syn.device_batch(i, SHAPE, cfg, "cpu",
                                                rows=rows))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            records = list(grid.records)
    shapes = [tuple(a.shape) for a in tree.leaves(state)]
    full = tree.map(lambda a, pl: grid.gather(a, pl), state, places)
    return metrics, full, shapes, records


def _serve_body(grid, name, params_np, prompt, toks):
    """The sharded prefill and the decode steps: (every step's logits, the
    gathered final states, rank 0's routing calls)."""
    cfg = port_cfg(_jcfg(name))
    rules = SH.rules_for(cfg)
    places = SH.resolve_tree(grid, T.model_specs(cfg),
                             T.init_model(cfg, device="meta"), rules)
    params = bridge.lm_params_from_jax(params_np, cfg,
                                       blocks=(grid, places))
    axes, rows = SH.batch_rows(grid, rules, SB)
    sp = M.decode_state_placements(cfg, grid, SB, MAX_LEN, rules)
    prefill = M.make_sharded_prefill(cfg, grid, places, axes, sp, rules,
                                     MAX_LEN)
    decode = M.make_sharded_decode_step(cfg, grid, places, axes, sp, rules)
    calls = []
    route = E.route

    def recording(cfg_, logits, e_lo, e_local, cap):
        out = route(cfg_, logits, e_lo, e_local, cap)
        calls.append((logits.clone(), e_lo, e_local, cap,
                      {k: v.clone() for k, v in out.items()}))
        return out

    E.route = recording
    try:
        logits, states = prefill(params, {"tokens":
                                          torch.from_numpy(prompt)[rows]})
        seen = [grid.all_gather(logits, axes)]
        for i, tok in enumerate(toks):
            logits, states = decode(params, states, {
                "tokens": torch.from_numpy(tok)[rows], "pos": PROMPT + i})
            seen.append(grid.all_gather(logits, axes))
    finally:
        E.route = route
    return (seen, tree.map(lambda a, p: grid.gather(a, p), states, sp),
            calls if grid.rank == 0 else None)


def _port_body(shape, names, inputs):
    grid = dataclasses.replace(mesh_lib.make_grid(shape, AXES, "cpu"),
                               records=[])
    out = {}
    for name in names:
        init, prompt, toks = inputs[name]
        out[("train", name)] = _train_body(grid, name, init)
        out[("serve", name)] = _serve_body(grid, name, init["params"],
                                           prompt, toks)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_tp")
    inputs = _inputs()
    procs = {}
    for name, shape in GRIDS.items():
        path = tmp / f"{name}.pkl"
        with open(str(path) + ".in", "wb") as f:
            pickle.dump(inputs, f)
        procs[name] = (path, _start(
            path, _JAX_RUNS, 4, GRID=shape, NAMES=GRID_MODELS[name],
            MODELS=MODELS, UNSHARDED=[GAP_ARCH] if shape == (1, 4) else [],
            SEQ=SEQ,
            BATCH=BATCH, MICRO=MICRO, STEPS=STEPS, SB=SB, PROMPT=PROMPT,
            MAX_LEN=MAX_LEN))
    count_path = tmp / "count.pkl"
    procs["count"] = (count_path, _start(
        count_path, _JAX_COUNT, 8, GRID=COUNT_GRID,
        SEQ=COUNT_SHAPE.seq_len, BATCH=COUNT_SHAPE.global_batch,
        MICRO=MICRO))
    port = {name: mesh_lib.run_ranks(_port_body, 4, shape,
                                     GRID_MODELS[name], inputs)
            for name, shape in GRIDS.items()}
    ref = {}
    for name, (path, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode:
            raise AssertionError(f"JAX runs ({name}) failed:\n{stdout}\n"
                                 f"{stderr}")
        with open(path, "rb") as f:
            ref[name] = pickle.load(f)
    return port, ref, inputs


def _close(got, want, what, rel=None):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    bound = ABS if rel is None else rel * max(
        float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    assert err <= bound, (what, err, bound)


def _trees_close(got, want, what, noise=None, twin=None):
    """Leaf by leaf to 1e-4 of the leaf's largest entry.

    ``noise`` (a tree of masks of the same leaves) leaves entries out, as
    ``test_torch_lm_ssm.three_steps_match_jax`` does: where an entry's
    first-step gradient cancels to f32 noise (its AdamW second moment not
    zero but below 1e-12 of the leaf's largest), AdamW's first step moves
    it by up to lr in one package and less in the other. Measured here:
    recurrentgemma's layer-0 ``mlp/wo`` [29, 0], whose first-step
    gradient is 7.8e-9 (3e-7 of the leaf's largest). Such entries must be
    under 0.1% of the leaf; their moments are still held.

    ``twin()`` gives the same tree from the port's unsharded step. An
    entry beyond the bound passes only where that step misses the
    reference by more than the bound too and the sharded step lies within
    the bound of it: the gap is then the unsharded port's, which the
    sharded step does not widen. Measured: recurrentgemma's layer-1
    ``rec/b_r`` [2] on 1 x 4 (a zero-initialised bias, so the leaf's
    largest entry is two AdamW steps, about 2 lr; its gradients of -3.0e-6
    and +1.4e-6, 1% of the leaf's largest, half cancel in the second
    step's first moment): the sharded step is 2.6e-7 from the reference,
    the unsharded port 3.3e-7, the bound 2.0e-7, and the two port steps
    6.9e-8 apart."""
    jl = jax.tree.leaves(want)
    tl = tree.paths(got)
    nl = [None] * len(jl) if noise is None else jax.tree.leaves(noise)
    assert len(jl) == len(tl) == len(nl), what
    for i, ((path, g), w, mask) in enumerate(zip(tl, jl, nl)):
        if np.asarray(w).dtype == np.int32:
            assert int(g) == int(w), (what, path)
            continue
        g, w = g.numpy(), np.asarray(w, np.float32)
        if mask is not None and mask.any():
            assert mask.mean() < 1e-3, (what, path, int(mask.sum()))
            g = np.where(mask, w, g)
        bound = REL * max(float(np.abs(w).max()), 1e-30)
        out = np.abs(g - w) > bound
        if out.any() and twin is not None:
            u = tree.leaves(twin())[i].numpy()
            excused = (np.abs(u - w) > bound) & (np.abs(g - u) <= bound)
            g = np.where(out & excused, w, g)
        _close(g, w, f"{what} {path}", rel=REL)


class _ReferenceSigmoid(torch.autograd.Function):
    """``torch.sigmoid`` differentiated as JAX does: ``g * (s * (1 - s))``
    (torch: ``g * (1 - s) * s``)."""

    @staticmethod
    def forward(ctx, a):
        s = torch.sigmoid(a)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * (s * (1 - s))


class _ReferenceSqrt(torch.autograd.Function):
    """``torch.sqrt`` differentiated as JAX does: ``g * (0.5 / s)``."""

    @staticmethod
    def forward(ctx, a):
        s = torch.sqrt(a)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * (0.5 / s)


def _reference_order_gates(sqrt_too: bool):
    """``rglru._gates`` with its sigmoids (and its sqrt when ``sqrt_too``)
    differentiated in the reference's order."""
    sqrt = _ReferenceSqrt.apply if sqrt_too else torch.sqrt

    def gates(p, u, u_all=None):
        uf = u.float()
        ua = uf if u_all is None else u_all.float()
        r = _ReferenceSigmoid.apply(ua @ p["w_r"].float() + p["b_r"])
        i = _ReferenceSigmoid.apply(ua @ p["w_i"].float() + p["b_i"])
        a = torch.exp(-R._C * torch.nn.functional.softplus(p["lam"]) * r)
        return a, sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * uf)
    return gates


# the gates' backward orders: torch's, and the reference's for the
# sigmoids (and the sqrt)
GATE_ORDERS = {"torch": None, "sigmoid": False, "sigmoid-and-sqrt": True}


@functools.lru_cache(maxsize=None)
def _unsharded(name, order="torch"):
    """The port's unsharded two steps from the carried state, the RG-LRU
    gates differentiated in ``GATE_ORDERS[order]``."""
    init = _inputs()[name][0]
    cfg = port_cfg(_jcfg(name))
    state = {"params": bridge.lm_params_from_jax(init["params"], cfg),
             "opt": bridge.opt_state_from_jax(init["opt"]),
             "step": torch.tensor(0, dtype=torch.int32)}
    step = TS.make_train_step(cfg, _ocfg(opt, cfg), MICRO)
    gates = R._gates
    if GATE_ORDERS[order] is not None:
        R._gates = _reference_order_gates(GATE_ORDERS[order])
    try:
        for i in range(STEPS):
            state, _ = step(state, syn.device_batch(i, SHAPE, cfg, "cpu"))
    finally:
        R._gates = gates
    return state


CASES = [(g, a) for g in GRIDS for a in GRID_MODELS[g]]
IDS = [f"{g}-{a}" for g, a in CASES]


@pytest.mark.parametrize("grid,arch", CASES, ids=IDS)
def test_tensor_parallel_train_step_matches_jax(results, grid, arch):
    """Two steps of two microbatches: losses (1e-5), grad norms, the
    gathered parameters and optimizer state (1e-4 of each leaf's largest
    entry) against the JAX jitted step on the same mesh; each rank's
    block shapes are the reference's shard shapes."""
    port, ref, _ = results
    metrics, full, shapes, _ = port[grid][("train", arch)]
    jmetrics, jstate, jshards, noise = ref[grid][("train", arch)]
    for (loss, gnorm), (jloss, jgnorm) in zip(metrics, jmetrics):
        assert abs(loss - jloss) <= ABS, (loss, jloss)
        assert abs(gnorm - jgnorm) <= REL * jgnorm, (gnorm, jgnorm)
    _trees_close(full["params"], jstate["params"], "params", noise,
                 lambda: _unsharded(arch)["params"])
    _trees_close(full["opt"], jstate["opt"], "opt")
    assert shapes == [tuple(s) for s in jshards]


@pytest.mark.parametrize("grid,arch", CASES, ids=IDS)
def test_tensor_parallel_prefill_and_decode_match_jax(results, grid, arch):
    """The sharded prefill (12 tokens into a 16-slot cache) and 4 decode
    steps: every step's logits (1e-5) and the final decode states (1e-4
    of each leaf's largest entry) against the reference's jitted
    functions on the same mesh."""
    port, ref, _ = results
    seen, states, _ = port[grid][("serve", arch)]
    jseen, jstates = ref[grid][("serve", arch)]
    assert len(seen) == len(jseen) == DECODES + 1
    for i, (got, want) in enumerate(zip(seen, jseen)):
        _close(got, want, f"logits {i}")
    _trees_close(states, jstates, "states")


@pytest.mark.parametrize("grid", list(GRIDS))
def test_tensor_parallel_routing_is_the_reference_routing(results, grid):
    """Every routing call of kimi's sharded prefill and decode on rank 0,
    with its experts a block over "model": the reference's routing plan
    of the same router logits, exactly."""
    port, _, _ = results
    calls = port[grid][("serve", MOE_ARCH)][2]
    jcfg = small_config(MOE_ARCH, dtype="float32")
    assert len(calls) == (DECODES + 1) * jcfg.n_layers
    for logits, e_lo, e_local, cap, got in calls:
        want = _jax_route(jcfg, jnp.asarray(logits.numpy()), e_lo, e_local,
                          cap)
        for k in ("gate_idx", "order", "keep", "dest", "counts"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)


def _rankless_step(cfg, grid):
    """A rankless rank 0's records of one sharded train step on ``meta``
    (``dryrun_lib.build_train_cell``: what the dry-run prices), and those
    its microbatches' forward and backward made."""
    rankless = mesh_lib.rankless_grid(mesh_lib.Layout(GRIDS[grid], AXES), 0)
    spans = []
    vag = TS.value_and_grad

    def spanned(cfg_):
        fn_ = vag(cfg_)

        def run(params, batch):
            lo = len(rankless.records)
            out = fn_(params, batch)
            spans.append((lo, len(rankless.records)))
            return out
        return run

    TS.value_and_grad = spanned
    try:
        fn, args = lib.build_train_cell(cfg, SHAPE, rankless, MICRO)
    finally:
        TS.value_and_grad = vag
    fn(*args)
    return rankless.records, [r for lo, hi in spans
                              for r in rankless.records[lo:hi]]


@pytest.mark.parametrize("grid,arch", CASES, ids=IDS)
def test_sharded_step_collectives_are_a_rankless_ranks(results, grid, arch):
    """The first sharded step's collectives on real gloo rank 0 equal, in
    order, kind, bytes and ring, a rankless rank 0's of the same step.
    The gathers whose gradients the ring sums give them back as
    reduce-scatters (``SCATTERING``), and no all-reduce of the forward
    and backward has a reduce-scatter's ring and operand size, but the
    model ring's output sums of [rows, seq, d] activations (the RG-LRU's
    gathered input has that size)."""
    port, _, _ = results
    real = port[grid][("train", arch)][3]
    cfg = port_cfg(_jcfg(arch))
    records, backward = _rankless_step(cfg, grid)
    assert real == records
    scatters = [r for r in backward if r.kind == "reduce-scatter"]
    assert len(scatters) == sum(r.kind == "reduce-scatter" for r in real)
    assert bool(scatters) == (arch in SCATTERING[grid])
    rows = BATCH // MICRO // GRIDS[grid][0]
    activation = rows * SEQ * cfg.d_model * 4
    summed = {(r.ranks, r.result_bytes) for r in backward
              if r.kind == "all-reduce"}
    for r in scatters:
        assert r.result_bytes * len(r.ranks) == r.operand_bytes
        if r.operand_bytes != activation:
            assert (r.ranks, r.operand_bytes) not in summed, r


def test_recurrentgemma_b_r_gap_is_the_references_own(results):
    """Where ``_trees_close`` takes the port's unsharded step as the twin
    (recurrentgemma's layer-1 ``rec/b_r`` [2] on 1 x 4), the reference's
    own unsharded step lies beyond the bound of its sharded step too, so
    no port can be held to the bound there: the first AdamW step moves
    the entries whose gradients cancel to f32 noise differently in the
    two programs, the second step's gradients differ by ~1e-8, and this
    entry, whose two first moments half cancel, grows that to ~1.4 times
    the bound. The port's unsharded step lies within the bound of the
    reference's unsharded step, and its sharded step within the bound of
    its unsharded one."""
    port, ref, _ = results
    jparams = ref["1x4"][("train", GAP_ARCH)][1]["params"]
    i = [p for p, _ in tree.paths(_unsharded(GAP_ARCH)["params"])].index(
        GAP_LEAF)
    want = np.asarray(jax.tree.leaves(jparams)[i])
    bound = REL * float(np.abs(want).max())
    ref_un = np.asarray(jax.tree.leaves(ref["1x4"][("unsharded",
                                                    GAP_ARCH)])[i])
    port_un = tree.leaves(_unsharded(GAP_ARCH)["params"])[i].numpy()
    port_sh = tree.leaves(port["1x4"][("train", GAP_ARCH)][1]["params"])[
        i].numpy()
    print(f"{GAP_LEAF} [{GAP_ENTRY}] (bound {bound:.2e}): |Ju - Js| "
          f"{abs(ref_un - want)[GAP_ENTRY]:.2e}, |Ps - Js| "
          f"{abs(port_sh - want)[GAP_ENTRY]:.2e}, |Pu - Ju| "
          f"{abs(port_un - ref_un)[GAP_ENTRY]:.2e}, |Ps - Pu| "
          f"{abs(port_sh - port_un)[GAP_ENTRY]:.2e}")
    assert abs(ref_un[GAP_ENTRY] - want[GAP_ENTRY]) > bound
    assert np.abs(port_un - ref_un).max() <= bound
    assert np.abs(port_sh - port_un).max() <= bound


@pytest.mark.parametrize("order", [o for o in GATE_ORDERS if o != "torch"])
def test_recurrentgemma_b_r_gap_is_not_the_gates_op_order(results, order):
    """The port's unsharded recurrentgemma step on 1 x 4's inputs with the
    RG-LRU gates' sigmoids (and sqrt) differentiated in the reference's
    order, ``g * (s * (1 - s))`` and ``g * (0.5 / s)``: like torch's
    order, it lies within the bound of the reference's unsharded step and
    within the bound of torch's order, and layer 1's ``rec/b_r`` [2]
    stays beyond the bound of the reference's sharded step. The gap is
    the two reference programs', not an op order of the port's."""
    _, ref, _ = results
    i = [p for p, _ in tree.paths(_unsharded(GAP_ARCH)["params"])].index(
        GAP_LEAF)
    js = np.asarray(jax.tree.leaves(
        ref["1x4"][("train", GAP_ARCH)][1]["params"])[i])
    ju = np.asarray(jax.tree.leaves(ref["1x4"][("unsharded",
                                                GAP_ARCH)])[i])
    bound = REL * float(np.abs(js).max())
    torch_order = tree.leaves(_unsharded(GAP_ARCH)["params"])[i].numpy()
    got = tree.leaves(_unsharded(GAP_ARCH, order)["params"])[i].numpy()
    print(f"{GAP_LEAF} [{GAP_ENTRY}], gates in {order} order: |Pu - Ju| "
          f"{abs(got - ju)[GAP_ENTRY]:.2e}, |Pu - Js| "
          f"{abs(got - js)[GAP_ENTRY]:.2e} (torch's order "
          f"{abs(torch_order - ju)[GAP_ENTRY]:.2e}, "
          f"{abs(torch_order - js)[GAP_ENTRY]:.2e}), bound {bound:.2e}")
    assert np.abs(got - ju).max() <= bound
    assert np.abs(got - torch_order).max() <= bound
    assert abs(got - js)[GAP_ENTRY] > bound
    assert abs(torch_order - js)[GAP_ENTRY] > bound


# the RG-LRU gates' elementwise ops whose backward torch writes in another
# order than JAX: (JAX, torch, the input made from x ~ N(0, 1))
GATE_OPS = {"sigmoid": (jax.nn.sigmoid, torch.sigmoid, lambda x: x),
            "exp": (jnp.exp, torch.exp, lambda x: 0.1 * x - 1),
            "sqrt": (jnp.sqrt, torch.sqrt, lambda x: 1 / (1 + np.exp(-x))),
            "softplus": (jax.nn.softplus, torch.nn.functional.softplus,
                         lambda x: x)}
GATE_SHAPE = (4, SEQ, 64)


def _gate_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(GATE_SHAPE).astype(np.float32)
    g = (rng.standard_normal(GATE_SHAPE) * 1e-3).astype(np.float32)
    return x, g


@pytest.mark.parametrize("op", list(GATE_OPS))
def test_rglru_gate_backward_is_the_references_to_an_ulp(op):
    """Each elementwise op of ``rglru._gates`` differentiated on the same
    seeded [4, 16, 64] inputs and cotangents, JAX against torch: the two
    write the product in another order (JAX's sigmoid ``g * (s * (1 -
    s))``, torch's ``g * (1 - s) * s``) and differ in many entries, but
    by at most 8 float32 eps of JAX's gradient (measured: 5.6 eps at
    most, the sigmoid's, where ``1 - s`` cancels)."""
    jf, tf, make = GATE_OPS[op]
    x, g = _gate_inputs()
    v = make(x).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, c: jax.vjp(jf, a)[1](c)[0])(
        jnp.asarray(v), jnp.asarray(g)))
    t = torch.from_numpy(v.copy()).requires_grad_()
    tf(t).backward(torch.from_numpy(g))
    got = t.grad.numpy()
    diff = np.abs(got - want)
    rel = diff / np.abs(want) / np.finfo(np.float32).eps
    print(f"{op}: {int((diff > 0).sum())} of {diff.size} differ, largest "
          f"{diff.max():.2e} ({rel.max():.1f} eps)")
    assert rel.max() <= 8, rel.max()


def test_rglru_bias_gradient_token_sum_is_the_references_to_rounding():
    """The gate biases' gradient sums [4, 16, 64] over batch and tokens:
    torch's ``sum(dim=(0, 1))`` against XLA's ``reduce_sum`` of the same
    array differ in most entries (the summation orders differ) but within
    twice the 64-term rounding bound, 2 x 63 eps of the sum of the
    terms' magnitudes."""
    x, _ = _gate_inputs()
    xs = x * np.float32(1e-3)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=(0, 1)))(
        jnp.asarray(xs)))
    got = torch.from_numpy(xs).sum(dim=(0, 1)).numpy()
    diff = np.abs(got - want)
    print(f"token sum: {int((diff > 0).sum())} of {diff.size} differ, "
          f"largest {diff.max():.2e}")
    n = GATE_SHAPE[0] * GATE_SHAPE[1]
    bound = 2 * (n - 1) * np.finfo(np.float32).eps * np.abs(xs).sum((0, 1))
    assert (diff <= bound).all(), (diff.max(), bound.min())


def test_rank_matmul_flops_match_the_compiled_sharded_step(results):
    """qwen3-0.6b (small: 4 heads, 2 kv heads, f32, remat), seq 32, batch
    8 in 2 microbatches, AdamW, on a 2 x 4 (data, model) layout: one
    rankless rank's matrix-product FLOPs against the ``dot`` FLOPs of one
    device's program of the reference's compiled sharded step (while
    loops multiplied by their trips). The tolerance is 5%. Reached: the
    port counts 1.01% more, and the gap is, in each of the 2 x 2 (layer,
    microbatch) attention calls of the rank's 2 rows, one q head and the
    one kv head it reads, the two terms
    ``test_torch_analysis.test_train_step_matmul_flops_match_hlo_cost_dots``
    explains for the unsharded step: the compiled reference holds one
    [B*KV, S*G, T] score product fewer than remat's eager recompute runs
    (+2 x 2 x 32 x 32 x 16), and writes the flash backward's row sums as a
    small dot where the port multiplies and sums (-2 x 2 x 32 x 16). The
    kv projections count the same: GSPMD, too, projects on each rank only
    the kv head its q head reads."""
    _, ref, _ = results
    want = ref["count"]
    jcfg = small_config("qwen3-0.6b", dtype="float32")
    cfg = port_cfg(jcfg)
    assert cfg.remat
    grid = mesh_lib.rankless_grid(mesh_lib.Layout(COUNT_GRID, AXES), 0)
    fn, args = lib.build_train_cell(cfg, COUNT_SHAPE, grid, MICRO)
    _, c = OC.count(fn, *args, records=grid.records)
    got = sum(c.matmul_flops.values())
    assert want > 0
    assert abs(got - want) <= MATMUL_REL * want, (got, want)
    b = COUNT_SHAPE.global_batch // MICRO // COUNT_GRID[0]
    s, hd = COUNT_SHAPE.seq_len, cfg.head_dim
    score = 2 * b * s * s * hd
    rowsum = 2 * (b * s) * hd
    assert got - want == cfg.n_layers * MICRO * (score - rowsum), (got, want)


@pytest.mark.parametrize("remat", [False, True])
def test_stacked_layer_gradients_are_the_indexed_ones_bitwise(remat):
    """qwen3-0.6b (small, stacked layers): the loss's gradients through
    the unbind Function equal, bitwise, those of indexing each layer out
    of the ``[L, ...]`` leaves (a ``select_backward`` each, summed)."""
    cfg = port_cfg(small_config("qwen3-0.6b", dtype="float32", remat=remat))
    assert T.stacked(cfg)
    params = T.init_model(cfg, torch.Generator().manual_seed(0))
    batch = syn.device_batch(0, SHAPE, cfg, "cpu")
    grads = []
    unstack = T._Unstack.apply
    for split in (unstack, lambda a: tuple(a[i] for i in range(len(a)))):
        T._Unstack.apply = split
        try:
            grads.append(TS.value_and_grad(cfg)(params, batch))
        finally:
            T._Unstack.apply = unstack
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1)
    for a, b in zip(tree.leaves(g0), tree.leaves(g1)):
        assert torch.equal(a, b)
