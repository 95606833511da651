"""The port's mixture-of-experts layer (``models.moe``) against the JAX
package's on the CPU: the static capacity, the routing plan (top-k with
ties to the lower index, the stable sort, positions, drops and buffer
rows) equal to the reference's before any value is compared, the sort-
based dispatch against the reference's and against the dense
every-expert reference, expert ranges whose partial results sum to the
whole, drops beyond capacity, and the gradients into the router and the
experts; then kimi and llama4 at their small configs with the reference's
parameters carried across (logits, loss, grads, prefill and decode, three
Adafactor steps) and a resumed ``launch.train`` run.

Tolerances (f32), PR 16's: outputs within 1e-5 absolute, gradients and
parameters within 1e-4 of each leaf's largest entry (see
``test_torch_lm_ssm.three_steps_match_jax`` for the optimizer steps).
Routing is compared exactly, on logits carried across bit for bit.
"""
import dataclasses
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import small_config  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as E  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from test_torch_lm_model import (_close, _grads_close, batch_pair,  # noqa: E402
                                 carried, port_cfg)
from test_torch_lm_ssm import three_steps_match_jax  # noqa: E402


def _cfg(arch="kimi-k2-1t-a32b", **kw):
    return small_config(arch, dtype="float32", **kw)


def _layer(jcfg, seed=0):
    """The reference's MoE parameters and the same in the port."""
    jp = jax.jit(lambda k: JE.init_moe(k, jcfg)[0])(jax.random.PRNGKey(seed))
    return jp, bridge._tree_to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _jax_route(cfg, logits, e_lo, e_local, cap):
    """The reference's routing plan: the lines of
    ``repro.models.moe._dispatch_combine`` that precede the buffer write
    (the reference returns none of them)."""
    t = logits.shape[0]
    k = cfg.experts_per_token
    gate_vals, gate_idx = jax.lax.top_k(logits, k)
    flat_e = gate_idx.reshape(-1)
    counts_all = jnp.bincount(flat_e, length=cfg.n_experts)
    loc = flat_e - e_lo
    is_local = (loc >= 0) & (loc < e_local)
    loc = jnp.where(is_local, loc, e_local)
    order = jnp.argsort(loc)
    sorted_e = loc[order]
    counts = jnp.bincount(loc, length=e_local + 1)[:e_local]
    offsets = jnp.cumsum(counts) - counts
    safe_e = jnp.clip(sorted_e, 0, e_local - 1)
    pos_in_e = jnp.arange(t * k) - offsets[safe_e]
    keep = (sorted_e < e_local) & (pos_in_e < cap)
    dest = safe_e * cap + jnp.clip(pos_in_e, 0, cap - 1)
    return {"gate_idx": gate_idx, "weights": jax.nn.softmax(gate_vals, -1),
            "order": order, "keep": keep, "dest": dest,
            "counts": counts_all}


def test_capacity_matches_jax_over_a_grid():
    for cf in (0.5, 1.0, 1.25, 8.0):
        for arch in ("kimi-k2-1t-a32b", "llama4-maverick-400b-a17b"):
            jcfg = small_config(arch, capacity_factor=cf)
            cfg = port_cfg(jcfg)
            for t in list(range(1, 70)) + [128, 1000, 4096, 32768]:
                assert E.capacity(cfg, t) == JE.capacity(jcfg, t), (cf, t)
    full = get_config("kimi-k2-1t-a32b")
    assert E.capacity(full, 4096) == JE.capacity(
        jget_config("kimi-k2-1t-a32b"), 4096) == 108
    assert E.capacity(full, 1) == 4


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("arch,cf,rng_", [
    ("kimi-k2-1t-a32b", 1.25, (0, 4)), ("kimi-k2-1t-a32b", 0.5, (1, 2)),
    ("llama4-maverick-400b-a17b", 1.0, (0, 4))])
def test_routing_equals_the_reference(arch, cf, rng_, ties):
    """gate_idx, weights, the sort order, keep, dest and the per-expert
    counts, over all experts and over an expert range; ``ties`` rounds the
    logits to a coarse grid so that equal logits tie within a row."""
    jcfg = _cfg(arch, capacity_factor=cf)
    cfg = port_cfg(jcfg)
    logits = np.random.default_rng(7).standard_normal(
        (48, jcfg.n_experts)).astype(np.float32)
    if ties:
        logits = np.round(logits * 2) / 2
        assert any(len(set(row)) < len(row) for row in logits)
    e_lo, e_local = rng_
    cap = JE.capacity(jcfg, 48)
    want = _jax_route(jcfg, jnp.asarray(logits), e_lo, e_local, cap)
    got = E.route(cfg, torch.from_numpy(logits), e_lo, e_local, cap)
    for name in ("gate_idx", "order", "keep", "dest", "counts"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    _close(got["weights"], want["weights"])
    assert not bool(got["keep"].all()) or cf > 1


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b",
                                  "llama4-maverick-400b-a17b"])
def test_gspmd_matches_jax_and_dense(arch):
    """The sort-based layer (output and aux) against the reference's, and,
    with a capacity nothing exceeds, against both packages' dense
    every-expert forms."""
    jcfg = _cfg(arch)
    cfg = port_cfg(jcfg)
    jp, tp = _layer(jcfg)
    jx, tx = _x((2, 16, jcfg.d_model), 1)
    jy, jaux = jax.jit(lambda p, x: JE.moe_forward_gspmd(p, jcfg, x))(jp, jx)
    y, aux = E.moe_forward(tp, cfg, tx)
    _close(y, jy)
    _close(aux, jaux)
    roomy = dataclasses.replace(cfg, capacity_factor=8.0)
    jroomy = dataclasses.replace(jcfg, capacity_factor=8.0)
    dense = E.moe_forward_dense(tp, roomy, tx)
    _close(dense, jax.jit(lambda p, x: JE.moe_forward_dense(p, jroomy, x))(
        jp, jx))
    _close(E.moe_forward_gspmd(tp, roomy, tx)[0], dense)


def test_expert_ranges_sum_to_the_whole():
    """``_dispatch_combine`` over [0, 1), [1, 3) and [3, 4): each range's
    partial result equals the reference's, and together they give the
    all-expert result (the expert-parallel split of the sharding slice)."""
    jcfg = _cfg(capacity_factor=1.0)
    cfg = port_cfg(jcfg)
    jp, tp = _layer(jcfg, seed=2)
    jx, tx = _x((32, jcfg.d_model), 2)
    logits = tx @ tp["router"]
    jlogits = jnp.asarray(logits.numpy())
    cap = E.capacity(cfg, 32)
    full, counts = E._dispatch_combine(cfg, tx, logits, tp["wi"], tp["wg"],
                                       tp["wo"], 0, 4, cap)
    total = torch.zeros_like(full)
    for lo, hi in ((0, 1), (1, 3), (3, 4)):
        sl = slice(lo, hi)
        part, c = E._dispatch_combine(cfg, tx, logits, tp["wi"][sl],
                                      tp["wg"][sl], tp["wo"][sl], lo,
                                      hi - lo, cap)
        jpart, jc = JE._dispatch_combine(jcfg, jx, jlogits, jp["wi"][sl],
                                         jp["wg"][sl], jp["wo"][sl], lo,
                                         hi - lo, cap)
        _close(part, jpart)
        assert torch.equal(c, counts)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        total = total + part
    _close(total, full)


def test_tokens_drop_beyond_capacity():
    """Identical tokens all route to the same experts: most slots drop,
    and the output (the kept slots and the shared expert) equals the
    reference's."""
    jcfg = _cfg(capacity_factor=0.5)
    cfg = port_cfg(jcfg)
    jp, tp = _layer(jcfg, seed=3)
    x = np.tile(np.random.default_rng(3).standard_normal(
        (1, 1, jcfg.d_model)).astype(np.float32), (1, 64, 1))
    jy, jaux = jax.jit(lambda p, x: JE.moe_forward_gspmd(p, jcfg, x))(
        jp, jnp.asarray(x))
    y, aux = E.moe_forward(tp, cfg, torch.from_numpy(x))
    _close(y, jy)
    _close(aux, jaux)
    r = E.route(cfg, torch.from_numpy(x[0]) @ tp["router"], 0, 4,
                E.capacity(cfg, 64))
    assert int(r["keep"].sum()) == 2 * E.capacity(cfg, 64) < 128
    assert float(aux) > 1.0


def test_grads_into_router_and_experts_match_jax():
    jcfg = _cfg(capacity_factor=1.0)
    cfg = port_cfg(jcfg)
    jp, tp = _layer(jcfg, seed=4)
    jx, tx = _x((2, 8, jcfg.d_model), 4)

    def jloss(p):
        y, aux = JE.moe_forward_gspmd(p, jcfg, jx)
        return jnp.sum(y * y) + 0.01 * aux

    jg = jax.jit(jax.grad(jloss))(jp)
    leaves = [a.clone().requires_grad_() for a in tree.leaves(tp)]
    y, aux = E.moe_forward(tree.unflatten(tp, leaves), cfg, tx)
    g = tree.unflatten(tp, torch.autograd.grad(
        (y * y).sum() + 0.01 * aux, leaves))
    assert float(g["router"].abs().sum()) > 0
    assert float(g["wi"].abs().sum()) > 0
    _grads_close(g, jg)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

MODELS = {"kimi": lambda: _cfg(), "llama4": lambda: _cfg(
    "llama4-maverick-400b-a17b")}


@pytest.mark.parametrize("case", list(MODELS))
def test_model_forward_loss_grads_and_decode_match_jax(case):
    """Logits, loss and grads of a train batch; then a prompt of 12
    tokens prefilled and 4 greedy decode steps (capacity 4 per expert at
    one token a step), logits and caches against the reference's."""
    jcfg = MODELS[case]()
    cfg = port_cfg(jcfg)
    jparams, tparams = carried(jcfg)
    jb, tb = batch_pair(jcfg, seq=16)

    def jf(p, b):
        return JM.loss_fn(p, jcfg, b), JT.forward(p, jcfg, b)

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jf, has_aux=True))(jparams, jb)
    _close(T.forward(tparams, cfg, tb), jlogits)
    loss, grads = TS.value_and_grad(cfg)(tparams, tb)
    _close(loss, jloss)
    _grads_close(grads, jgrads)

    jb, tb = {"tokens": jb["tokens"][:, :12]}, {"tokens": tb["tokens"][:, :12]}
    jlogits, jstates = jax.jit(lambda p, b: JT.prefill(p, jcfg, b, 16))(
        jparams, jb)
    logits, states = M.make_prefill(cfg, 16)(tparams, tb)
    _close(logits, jlogits[:, -1:])
    jdecode = jax.jit(lambda p, st, b: JT.decode_step(p, jcfg, st, b))
    decode = M.make_decode_step(cfg)
    tok = np.array(jnp.argmax(jlogits[:, -1:], -1), np.int32)
    for pos in range(12, 16):
        jl, jstates = jdecode(jparams, jstates, {
            "tokens": jnp.asarray(tok), "pos": jnp.int32(pos)})
        tl, states = decode(tparams, states, {
            "tokens": torch.from_numpy(tok), "pos": pos})
        _close(tl, jl)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
    for name in ("k", "v"):
        _close(states[name], jstates[name])


@pytest.mark.parametrize("case", list(MODELS))
def test_three_train_steps_match_jax(case):
    """Adafactor, as both configs are set."""
    jcfg = MODELS[case]()
    assert jcfg.optimizer == "adafactor"
    three_steps_match_jax(jcfg)


def _launch(tmp, steps, where, every):
    return launch_train.main(
        ["--arch", "kimi-k2-1t-a32b", "--device", "cpu", "--steps",
         str(steps), "--batch", "4", "--seq", "16", "--microbatches", "2",
         "--scale", "0.05", "--ckpt-dir", str(tmp / where), "--ckpt-every",
         str(every), "--seed", "3"])


def test_launch_train_moe_resumes_bitwise(tmp_path, capsys):
    """``launch.train`` on the CPU at kimi's ``--scale 0.05`` (19 experts,
    top-8, a shared expert, Adafactor): 2 steps with a checkpoint, resumed
    to 3, equal bitwise to a straight 3-step run."""
    before = signal.getsignal(signal.SIGTERM)
    assert _launch(tmp_path, 2, "resumed", 2) == 0
    assert _launch(tmp_path, 3, "resumed", 3) == 0
    assert "restored checkpoint at step 2" in capsys.readouterr().out
    assert _launch(tmp_path, 3, "straight", 3) == 0
    assert signal.getsignal(signal.SIGTERM) is before
    with np.load(tmp_path / "resumed" / "step_00000003.npz") as a, \
            np.load(tmp_path / "straight" / "step_00000003.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "params/layers/moe/router" in a.files
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
