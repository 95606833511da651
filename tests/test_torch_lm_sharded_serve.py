"""The sharded prefill and decode of the port against the JAX package on a
2 x 2 (data, model) grid, and the dry-run's rankless ranks against real
ones.

One spawn of 4 gloo ranks runs, for five archs (dense, MoE with FSDP and
EP, the RG-LRU hybrid, the SSM, and audio with its batch over (data,
model)), the sharded prefill of a 16-token prompt and one decode step
from its states, with the reference's weights carried over; one JAX
subprocess on 4 virtual devices runs the reference's jitted
``make_prefill`` / ``make_decode_step`` with the same shardings. f32
configs: logits to 1e-5 absolute, decode states to 1e-4 of each leaf's
largest entry; the MoE's routing exactly (every routing call of rank 0
against the reference's routing of the same router logits).

The same spawn records, on each rank, the collectives of one sharded
train step, prefill and decode step at ``--scale 0.05`` (qwen3-0.6b and
kimi-k2); each must equal, in order, kind, bytes and ring size, what a
rankless rank of the same layout records on ``meta`` tensors.
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
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun_lib as lib  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.train import _reduce  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as E  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from test_torch_lm_moe import _jax_route  # noqa: E402

REL, ABS = 1e-4, 1e-5
GRID, AXES = (2, 2), ("data", "model")
ARCHS = ["qwen3-0.6b", "kimi-k2-1t-a32b", "recurrentgemma-2b",
         "mamba2-780m", "musicgen-medium"]
B, S = 4, 16
RECORD_ARCHS = ["qwen3-0.6b", "kimi-k2-1t-a32b"]
TRAIN = ShapeConfig("t", seq_len=16, global_batch=8, kind="train")
SERVE = ShapeConfig("s", seq_len=16, global_batch=4, kind="prefill")


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


def _tokens(cfg, n, seed):
    shape = (B, n, cfg.n_codebooks) if cfg.n_codebooks else (B, n)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _inputs() -> dict:
    """The reference's parameters and the prompt and decode tokens."""
    out = {}
    for arch in ARCHS:
        jcfg = small_config(arch, dtype="float32")
        params = jax.jit(lambda k, c=jcfg: JT.init_model(k, c)[0])(
            jax.random.PRNGKey(0))
        out[arch] = (jax.tree.map(np.asarray, params),
                     _tokens(jcfg, S, 1), _tokens(jcfg, 1, 2))
    return out


_JAX_RUNS = """
import pickle, sys
sys.path.insert(0, "tests")
import numpy as np
import jax
import jax.numpy as jnp
from conftest import small_config
from repro.configs.base import ShapeConfig
from repro.distributed import sharding as SH
from repro.launch import dryrun_lib as lib
from repro.launch import mesh as mesh_lib
from repro.models import model as M

mesh = mesh_lib.make_mesh((2, 2), ("data", "model"))
with open(PATH + ".in", "rb") as f:
    inp = pickle.load(f)
out = {}
for arch in ARCHS:
    cfg = small_config(arch, dtype="float32")
    rules = lib.rules_for(cfg)
    params_np, prompt, tok = inp[arch]
    _, specs = lib.abstract_params(cfg)
    psh = SH.resolve_tree(mesh, specs, params_np, rules)
    params = jax.device_put(jax.tree.map(jnp.asarray, params_np), psh)
    pshape = ShapeConfig("p", seq_len=S, global_batch=B, kind="prefill")
    dshape = ShapeConfig("d", seq_len=S, global_batch=B, kind="decode")
    bsh = {k: v.sharding for k, v in
           lib.batch_sds(cfg, pshape, mesh, rules).items()}
    dsh = {k: v.sharding for k, v in
           lib.batch_sds(cfg, dshape, mesh, rules).items()}
    with SH.activation_sharding(mesh, rules):
        prefill = jax.jit(M.make_prefill(cfg), in_shardings=(psh, bsh))
        logits, states = prefill(params, {"tokens": jnp.asarray(prompt)})
        _, dims = M.decode_state_specs(cfg, dshape)
        ssh = SH.resolve_tree(mesh, dims, states, rules)
        states = jax.device_put(states, ssh)
        decode = jax.jit(M.make_decode_step(cfg),
                         in_shardings=(psh, ssh, dsh))
        dlogits, dstates = decode(params, states, {
            "tokens": jnp.asarray(tok), "pos": jnp.int32(S - 1)})
    out[arch] = (np.asarray(logits), jax.tree.map(np.asarray, states),
                 np.asarray(dlogits), jax.tree.map(np.asarray, dstates))
with open(PATH, "wb") as f:
    pickle.dump(out, f)
"""


def _start_jax(path):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    code = (f"PATH = {str(path)!r}\nARCHS = {ARCHS!r}\nB, S = {B}, {S}\n"
            + textwrap.dedent(_JAX_RUNS))
    return subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _serve_body(grid, arch, params_np, prompt, tok):
    """The sharded prefill and one decode step on this rank: (prefill
    logits, the gathered prefill states, decode logits, the gathered
    decode states, rank 0's routing calls)."""
    cfg = port_cfg(small_config(arch, dtype="float32"))
    rules = SH.rules_for(cfg)
    places = SH.resolve_tree(grid, T.model_specs(cfg),
                             T.init_model(cfg, device="meta"), rules)
    params = bridge.lm_params_from_jax(params_np, cfg,
                                       blocks=(grid, places))
    axes, rows = SH.batch_rows(grid, rules, B)
    sp = M.decode_state_placements(cfg, grid, B, S, rules)
    prefill = M.make_sharded_prefill(cfg, grid, places, axes, sp, rules)
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
        full = tree.map(lambda a, p: grid.gather(a, p), states, sp)
        dlogits, dstates = decode(params, states, {
            "tokens": torch.from_numpy(tok)[rows], "pos": S - 1})
    finally:
        E.route = route
    if any(a is not b for a, b in zip(tree.leaves(dstates),
                                      tree.leaves(states))):
        raise AssertionError("decode did not update its state blocks in "
                             "place")
    return (grid.all_gather(logits, axes), full,
            grid.all_gather(dlogits, axes),
            tree.map(lambda a, p: grid.gather(a, p), dstates, sp),
            calls if grid.rank == 0 else None)


def _record_cfg(arch):
    return _reduce(get_config(arch), 0.05)


def _record_cells(cfg, grid):
    """(the sharded train step, prefill and decode of ``cfg`` on ``grid``,
    each with its arguments), built from this package's own ``meta``
    shapes: on a real grid the tensors are made on the CPU."""
    train = lib.build_train_cell(cfg, TRAIN, grid, 2)
    prefill = lib.build_prefill_cell(cfg, SERVE, grid)
    decode = lib.build_decode_cell(
        cfg, dataclasses.replace(SERVE, kind="decode"), grid)
    return [train, prefill, decode]


def _records_body(grid, arch):
    """The collectives this rank issues in a real sharded train step,
    prefill and decode step: the cells' ``meta`` arguments made real on
    the CPU (small random values, token ids 0)."""
    gen = torch.Generator().manual_seed(0)

    def real(x):
        if not isinstance(x, torch.Tensor) or not x.is_meta:
            return x
        if x.dtype.is_floating_point:
            return (torch.randn(x.shape, generator=gen) * 0.02).to(x.dtype)
        return torch.zeros(x.shape, dtype=x.dtype)

    out = []
    for fn, args in _record_cells(_record_cfg(arch), grid):
        start = len(grid.records)
        fn(*tree.map(real, list(args)))
        out.append(list(grid.records[start:]))
    return out


def _rankless_records(arch, rank):
    grid = mesh_lib.rankless_grid(mesh_lib.Layout(GRID, AXES), rank)
    out = []
    for fn, args in _record_cells(_record_cfg(arch), grid):
        start = len(grid.records)
        fn(*args)
        out.append(list(grid.records[start:]))
    return out


def _port_body(inputs):
    import torch.distributed as dist
    grid = dataclasses.replace(mesh_lib.make_grid(GRID, AXES, "cpu"),
                               records=[])
    out = {arch: _serve_body(grid, arch, *inputs[arch]) for arch in ARCHS}
    mine = {arch: _records_body(grid, arch) for arch in RECORD_ARCHS}
    every = [None] * grid.size
    dist.all_gather_object(every, (grid.rank, mine))
    out["records"] = dict(every)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm_serve") / "jax.pkl"
    inputs = _inputs()
    with open(str(path) + ".in", "wb") as f:
        pickle.dump(inputs, f)
    proc = _start_jax(path)
    port = mesh_lib.run_ranks(_port_body, 4, inputs)
    stdout, stderr = proc.communicate(timeout=900)
    if proc.returncode:
        raise AssertionError(f"JAX runs failed:\n{stdout}\n{stderr}")
    with open(path, "rb") as f:
        return port, pickle.load(f)


def _close(got, want, what, rel=None):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    bound = ABS if rel is None else rel * max(
        float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    assert err <= bound, (what, err, bound)


def _states_close(got, want, what):
    jl = jax.tree.leaves(want)
    tl = tree.paths(got)
    assert len(jl) == len(tl), what
    for (path, g), w in zip(tl, jl):
        _close(g, w, f"{what} {path}", rel=REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_jax(results, arch):
    """Prefill logits and states, then one decode step's logits and
    states, on the 2 x 2 grid against the reference's jitted functions
    on the (2, 2) mesh."""
    port, jax_out = results
    logits, states, dlogits, dstates, _ = port[arch]
    jlogits, jstates, jdlogits, jdstates = jax_out[arch]
    _close(logits, jlogits, "prefill logits")
    _states_close(states, jstates, "prefill states")
    _close(dlogits, jdlogits, "decode logits")
    _states_close(dstates, jdstates, "decode states")


def test_moe_routing_is_the_reference_routing(results):
    """Every routing call of kimi's prefill (EP over "model": the local
    tokens, this rank's experts) and decode (GSPMD: the whole batch's
    tokens) on rank 0: the reference's routing plan of the same router
    logits, exactly."""
    port, _ = results
    calls = port["kimi-k2-1t-a32b"][4]
    jcfg = small_config("kimi-k2-1t-a32b", dtype="float32")
    cfg = port_cfg(jcfg)
    assert len(calls) == 2 * cfg.n_layers
    for logits, e_lo, e_local, cap, got in calls:
        want = _jax_route(jcfg, jnp.asarray(logits.numpy()), e_lo, e_local,
                          cap)
        for k in ("gate_idx", "order", "keep", "dest", "counts"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    assert {c[2] for c in calls} == {cfg.n_experts // 2, cfg.n_experts}


@pytest.mark.parametrize("arch", RECORD_ARCHS)
def test_rankless_collectives_equal_real_ranks(results, arch):
    """On every rank of the 2 x 2 grid, the collectives of the sharded
    train step, prefill and decode step (kind, operand and result bytes,
    ring size, in order) equal those a rankless rank records on
    ``meta``."""
    port, _ = results
    for rank in range(4):
        real = port["records"][rank][arch]
        assert real == _rankless_records(arch, rank), (arch, rank)
        assert all(real), (arch, rank)


@pytest.mark.parametrize("arch", ARCHS + ["qwen2-vl-7b"])
def test_one_rank_grid_serving_is_the_unsharded_bitwise(arch):
    """On a (1, 1) grid the sharded prefill and decode step (identity
    gathers, every block the whole tensor) are the unsharded ones,
    bitwise: the prefill's logits and states, two decode steps' logits
    and states (updated in place in both)."""
    cfg = port_cfg(small_config(arch, dtype="float32"))
    grid = mesh_lib.make_grid((1, 1), AXES, "cpu")
    rules = SH.rules_for(cfg)
    params = T.init_model(cfg, torch.Generator().manual_seed(0))
    places = SH.resolve_tree(grid, T.model_specs(cfg), params, rules)
    axes, rows = SH.batch_rows(grid, rules, B)
    assert rows == list(range(B))
    max_len = S + 2
    sp = M.decode_state_placements(cfg, grid, B, max_len, rules)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, S, 1))}
    if cfg.family == "vlm":
        batch.update(vision_embeds=torch.randn(B, S, cfg.d_model),
                     vision_mask=torch.arange(S)[None].expand(B, S) < 4,
                     positions=torch.arange(S, dtype=torch.int32)[
                         None, :, None].expand(B, S, 3).contiguous())
    fns = [(M.make_prefill(cfg, max_len), M.make_decode_step(cfg)),
           (M.make_sharded_prefill(cfg, grid, places, axes, sp, rules,
                                   max_len),
            M.make_sharded_decode_step(cfg, grid, places, axes, sp, rules))]
    outs = []
    for prefill, decode in fns:
        logits, states = prefill(params, batch)
        seen = [logits]
        for i, pos in enumerate((S, S + 1)):
            step = {"tokens": torch.from_numpy(_tokens(cfg, 1, 2 + i)),
                    "pos": pos}
            if cfg.family == "vlm":
                step["positions"] = torch.full((B, 1, 3), pos,
                                               dtype=torch.int32)
            logits, states = decode(params, states, step)
            seen.append(logits)
        outs.append((seen, tree.leaves(states)))
    (l0, s0), (l1, s1) = outs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
