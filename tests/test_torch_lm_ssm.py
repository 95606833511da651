"""The port's recurrent layers against the JAX package's on the CPU: the
Mamba2 SSD mixer (``models.mamba2``: the causal conv, the chunked SSD with
a padded tail and an initial state, the sequential oracle, forward and
decode) and the RG-LRU block (``models.rglru``: the gates, the log-depth
scan, forward and decode); then whole models with the reference's
parameters carried across: mamba2 (stacked, and ``scan_layers=False``)
and recurrentgemma (``'rrl'``): logits, loss and grads, prefill followed
by decode, and three optimizer steps.

Tolerances (f32), PR 16's: outputs within 1e-5 absolute, gradients and
parameters within 1e-4 of each leaf's largest entry. The two packages'
f32 matmuls, cumulative sums and transcendental functions differ in
summation order and last-ulp rounding only; the SSD's cumulative sums
are bitwise the reference's (XLA:CPU's order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import small_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import mamba2 as JS  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.models import mamba2 as S  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import rglru as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from test_torch_lm_model import (_close, _grads_close, batch_pair,  # noqa: E402
                                 carried, port_cfg)

REL = 1e-4


def _rel(path: str) -> float:
    """A leaf's tolerance: AdamW's second moments (``opt/v``) are sums of
    squared gradients, whose relative error is twice the gradients': held
    to 2e-4 of their largest entry (measured: 1.4e-4 on mamba2's
    ``conv_b``); every other leaf to 1e-4."""
    return 2 * REL if path.startswith("opt/v/") else REL


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _params(init, jcfg, seed=0):
    """A layer's reference parameters (random f32 biases and gates, so
    none is trivially zero or one) and the same in the port."""
    jp = jax.jit(lambda k: init(k, jcfg)[0])(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp = {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)
                          * 0.5) if v.dtype == jnp.float32 and v.ndim == 1
              else v) for k, v in jp.items()}
    return jp, bridge._tree_to_torch(_np_tree(jp), "cpu")


def _ssm_cfg(**kw):
    return small_config("mamba2-780m", dtype="float32", **kw)


# ---------------------------------------------------------------------------
# mamba2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,width", [(12, 4), (2, 4), (9, 2)])
def test_causal_conv_matches_jax(s, width):
    rng = np.random.default_rng(s)
    jx, tx = _pair(rng, (2, s, 24))
    jw, tw = _pair(rng, (width, 24))
    jb, tb = _pair(rng, (24,))
    _close(S.causal_conv(tx, tw, tb), JS.causal_conv(jx, jw, jb))


def _ssd_inputs(seed, s, nh=4, hd=8, ns=16):
    rng = np.random.default_rng(seed)
    jx, tx = _pair(rng, (2, s, nh, hd))
    dt = np.log1p(np.exp(rng.standard_normal((2, s, nh)))).astype(
        np.float32)
    a = (-np.exp(rng.standard_normal(nh))).astype(np.float32)
    jb, tb = _pair(rng, (2, s, ns))
    jc, tc = _pair(rng, (2, s, ns))
    jh, th = _pair(rng, (2, nh, hd, ns))
    return ((jx, jnp.asarray(dt), jnp.asarray(a), jb, jc, jh),
            (tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc, th))


@pytest.mark.parametrize("s,chunk,with_h0", [(32, 8, False), (29, 8, True),
                                             (5, 8, False), (24, 24, True)])
def test_ssd_chunked_and_reference_match_jax(s, chunk, with_h0):
    """The chunked SSD (a padded tail where s % chunk != 0, an initial
    state) and the sequential oracle against the reference's, and the
    port's two forms against each other."""
    jin, tin = _ssd_inputs(s, s)
    jh0, th0 = (jin[5], tin[5]) if with_h0 else (None, None)
    jy, jh = JS.ssd_chunked(*jin[:5], chunk, h0=jh0)
    y, h = S.ssd_chunked(*tin[:5], chunk, h0=th0)
    _close(y, jy)
    _close(h, jh)
    jy_ref, jh_ref = JS.ssd_reference(*jin[:5], h0=jh0)
    y_ref, h_ref = S.ssd_reference(*tin[:5], h0=th0)
    _close(y_ref, jy_ref)
    _close(h_ref, jh_ref)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), h_ref.numpy(), atol=1e-4)


def test_cumsum_is_xla_cpus_bitwise():
    """The SSD's cumulative sum adds in XLA:CPU's order for ``jnp.cumsum``
    (blocks of 16), so it equals the reference's bit for bit, at lengths
    below, at and across the block size."""
    rng = np.random.default_rng(5)
    for n in (1, 7, 16, 24, 64, 256, 300):
        a = (rng.standard_normal((3, n)) - 0.7).astype(np.float32)
        np.testing.assert_array_equal(
            S.cumsum(torch.from_numpy(a)).numpy(),
            np.asarray(jnp.cumsum(jnp.asarray(a), -1)), err_msg=str(n))


def test_segsum_matches_jax():
    rng = np.random.default_rng(3)
    jd, td = _pair(rng, (2, 3, 16))
    got, want = S._segsum(td), np.asarray(JS._segsum(jd))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("s", [16, 13])
def test_mamba2_forward_and_grads_match_jax(s):
    jcfg = _ssm_cfg()
    cfg = port_cfg(jcfg)
    jp, tp = _params(JS.init_mamba2, jcfg)
    rng = np.random.default_rng(s)
    jx, tx = _pair(rng, (2, s, jcfg.d_model))

    def jloss(p, x):
        y = JS.mamba2_forward(p, jcfg, x)
        return jnp.sum(y * y), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp, jx)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    y = S.mamba2_forward(leaves, cfg, tx)
    _close(y, jy)
    (y * y).sum().backward()
    _grads_close({k: v.grad for k, v in leaves.items()}, jg)


def test_mamba2_decode_matches_jax():
    """Three single-token steps from a random state: outputs and both
    state leaves, updated in place."""
    jcfg = _ssm_cfg()
    cfg = port_cfg(jcfg)
    jp, tp = _params(JS.init_mamba2, jcfg, seed=1)
    rng = np.random.default_rng(1)
    jst = JS.init_mamba2_state(jcfg, 2)
    jst = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
           for k, v in jst.items()}
    st = bridge._tree_to_torch(_np_tree(jst), "cpu")
    conv = st["conv"]
    for _ in range(3):
        jx, tx = _pair(rng, (2, 1, jcfg.d_model))
        jy, jst = JS.mamba2_decode(jp, jcfg, jst, jx)
        y, st = S.mamba2_decode(tp, cfg, st, tx)
        _close(y, jy)
    assert st["conv"] is conv
    _close(st["conv"], jst["conv"])
    _close(st["ssm"], jst["ssm"])


# ---------------------------------------------------------------------------
# rglru
# ---------------------------------------------------------------------------


def _rec_cfg(**kw):
    return small_config("recurrentgemma-2b", dtype="float32", **kw)


@pytest.mark.parametrize("s", [7, 16])
def test_rglru_gates_and_scans_match_jax(s):
    """The gates, the log-depth scan (7 runs the recursion's odd branch,
    16 the even one) and the sequential oracle."""
    jcfg = _rec_cfg()
    jp, tp = _params(JR.init_rglru, jcfg)
    ju, tu = _pair(np.random.default_rng(s), (2, s, jcfg.d_model))
    (ja, jb), jh, jh_ref = jax.jit(lambda p, u: (
        JR._gates(p, u), JR.rglru_scan(p, u), JR.rglru_reference(p, u)))(
            jp, ju)
    a, b = R._gates(tp, tu)
    _close(a, ja)
    _close(b, jb)
    _close(R.rglru_scan(tp, tu), jh)
    _close(R.rglru_reference(tp, tu), jh_ref)


def test_associative_scan_matches_jax_bitwise():
    """The scan alone on given (a, b): equal to ``jax.lax.associative_scan``
    bit for bit (the same products in the same association)."""
    rng = np.random.default_rng(4)
    for s in (3, 8, 33):
        a = rng.uniform(0.5, 1.0, (2, s, 5)).astype(np.float32)
        b = rng.standard_normal((2, s, 5)).astype(np.float32)
        want = jax.lax.associative_scan(
            lambda x, y: (x[0] * y[0], y[0] * x[1] + y[1]),
            (jnp.asarray(a), jnp.asarray(b)), axis=1)
        got = R.associative_scan(R._combine, (torch.from_numpy(a),
                                              torch.from_numpy(b)), 1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rglru_forward_grads_and_decode_match_jax():
    jcfg = _rec_cfg()
    cfg = port_cfg(jcfg)
    jp, tp = _params(JR.init_rglru, jcfg, seed=3)
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng, (2, 11, jcfg.d_model))

    def jloss(p, x):
        y = JR.rglru_forward(p, jcfg, x)
        return jnp.sum(y * y), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp, jx)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    y = R.rglru_forward(leaves, cfg, tx)
    _close(y, jy)
    (y * y).sum().backward()
    _grads_close({k: v.grad for k, v in leaves.items()}, jg)

    jst = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
           for k, v in JR.init_rglru_state(jcfg, 2).items()}
    st = bridge._tree_to_torch(_np_tree(jst), "cpu")
    for _ in range(3):
        jx, tx = _pair(rng, (2, 1, jcfg.d_model))
        jy, jst = JR.rglru_decode(jp, jcfg, jst, jx)
        y, st = R.rglru_decode(tp, cfg, st, tx)
        _close(y, jy)
    _close(st["conv"], jst["conv"])
    _close(st["h"], jst["h"])


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

MODELS = {
    "mamba2": lambda: _ssm_cfg(),
    "mamba2-list": lambda: _ssm_cfg(scan_layers=False),
    "recurrentgemma": lambda: _rec_cfg(),
}


@pytest.mark.parametrize("case", list(MODELS))
def test_model_forward_loss_and_grads_match_jax(case):
    jcfg = MODELS[case]()
    cfg = port_cfg(jcfg)
    jparams, tparams = carried(jcfg)
    jb, tb = batch_pair(jcfg, seq=24)

    def jf(p, b):
        from repro.models import model as JM
        return JM.loss_fn(p, jcfg, b), JT.forward(p, jcfg, b)

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jf, has_aux=True))(jparams, jb)
    _close(T.forward(tparams, cfg, tb), jlogits)
    loss, grads = TS.value_and_grad(cfg)(tparams, tb)
    _close(loss, jloss)
    _grads_close(grads, jgrads)


@pytest.mark.parametrize("case,s", [("mamba2", 13), ("mamba2-list", 5),
                                    ("recurrentgemma", 11)])
def test_model_prefill_then_decode_match_jax(case, s):
    """Prefill a prompt (13: a padded SSD tail; 5: shorter than a chunk;
    11: longer than the 'l' ring of 8), then 4 greedy decode steps: the
    logits of each and the final states (conv windows of raw inputs, SSM
    and RG-LRU states, the ring) against the reference's."""
    jcfg = MODELS[case]()
    cfg = port_cfg(jcfg)
    jparams, tparams = carried(jcfg, seed=1)
    jb, tb = batch_pair(jcfg, seq=s)
    jb, tb = {"tokens": jb["tokens"]}, {"tokens": tb["tokens"]}
    jlogits, jstates = jax.jit(lambda p, b: JT.prefill(p, jcfg, b, 0))(
        jparams, jb)
    logits, states = M.make_prefill(cfg, 0)(tparams, tb)
    _close(logits, jlogits[:, -1:])
    jdecode = jax.jit(lambda p, st, b: JT.decode_step(p, jcfg, st, b))
    decode = M.make_decode_step(cfg)
    tok = np.array(jnp.argmax(jlogits[:, -1:], -1), np.int32)
    for pos in range(s, s + 4):
        jl, jstates = jdecode(jparams, jstates, {
            "tokens": jnp.asarray(tok), "pos": jnp.int32(pos)})
        tl, states = decode(tparams, states, {
            "tokens": torch.from_numpy(tok), "pos": pos})
        _close(tl, jl)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
    got = tree.paths(states)
    want = jax.tree.leaves(jstates)
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        assert tuple(g.shape) == w.shape, path
        _close(g, w)


def test_init_states_match_jax():
    for jcfg in (_ssm_cfg(), _rec_cfg(), _ssm_cfg(scan_layers=False)):
        want = JT.init_states(jcfg, 3, 20)
        got = T.init_states(port_cfg(jcfg), 3, 20)
        assert [(p, tuple(a.shape), str(a.dtype).split(".")[-1])
                for p, a in tree.paths(got)] == [
            (p, tuple(a.shape), str(a.dtype))
            for p, a in tree.paths(_np_tree(want))]
        assert not any(a.any() for a in tree.leaves(got))


JSHAPE = JShape("t", seq_len=16, global_batch=4, kind="train")
SHAPE = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")


def three_steps_match_jax(jcfg):
    """Three steps of the configured optimizer from the carried state, 2
    microbatches: losses within 1e-5, parameters and optimizer states as
    :func:`_rel` says.

    One exception, measured: where a gradient entry cancels to f32 noise
    (mamba2's ``in_proj`` [0, 55, 220]: microbatch gradients of -3.5e-3
    and +3.5e-3 that sum to -2.6e-9 in the reference and to 0 in the
    port), AdamW's first step moves the parameter by up to
    lr * |g| / (|g| + eps), here 0.21 lr, in one package and not in the
    other. Entries whose first-step second moment is not zero but below
    1e-12 of the leaf's largest (gradients under 1e-6 of the largest) are
    left out of the parameter check; they must be under 0.1% of the leaf, and their
    moments are still held."""
    cfg = port_cfg(jcfg)
    jocfg = jopt.OptimizerConfig(kind=jcfg.optimizer, lr=1e-3,
                                 warmup_steps=1)
    ocfg = opt.OptimizerConfig(kind=cfg.optimizer, lr=1e-3, warmup_steps=1)
    jstate = jax.jit(lambda k: JTS.init_train_state(k, jcfg, jocfg)[0])(
        jax.random.PRNGKey(0))
    np_state = _np_tree(jstate)
    state = {"params": bridge.lm_params_from_jax(np_state["params"], cfg),
             "opt": bridge.opt_state_from_jax(np_state["opt"]),
             "step": torch.tensor(0, dtype=torch.int32)}
    jstep = jax.jit(JTS.make_train_step(jcfg, jocfg, microbatches=2))
    step = TS.make_train_step(cfg, ocfg, microbatches=2)
    noise = {}
    for i in range(3):
        host = jsyn.host_batch(i, JSHAPE, jcfg)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in host.items()})
        state, m = step(state, syn.device_batch(i, SHAPE, cfg, "cpu"))
        _close(m["loss"], jm["loss"])
        if i == 0 and "m" in jstate["opt"]:
            for path, v0 in tree.paths(_np_tree(jstate["opt"]["v"])):
                noise["params/" + path] = (v0 > 0) & (v0 < 1e-12 * v0.max())
    for (path, g), w in zip(tree.paths(state),
                            jax.tree.leaves(jstate)):
        w = np.asarray(w)
        if w.dtype == np.int32:
            assert int(g) == int(w), path
            continue
        diff = np.abs(g.numpy() - w)
        if path in noise:
            assert noise[path].mean() < 1e-3, (path, noise[path].sum())
            diff = np.where(noise[path], 0.0, diff)
        err = diff.max()
        assert err <= _rel(path) * max(np.abs(w).max(), 1e-30), (path, err)


@pytest.mark.parametrize("case", ["mamba2", "recurrentgemma"])
def test_three_train_steps_match_jax(case):
    three_steps_match_jax(MODELS[case]())


def test_mamba2_stacked_and_listed_agree():
    """The stacked [L, ...] layout and the per-layer list give the same
    logits from the same weights."""
    jcfg = _ssm_cfg()
    _, stacked = carried(jcfg)
    listed = {"emb": stacked["emb"],
              "layers": [tree.map(lambda a, i=i: a[i], stacked["layers"])
                         for i in range(jcfg.n_layers)]}
    _, tb = batch_pair(jcfg, seq=16)
    a = T.forward(stacked, port_cfg(jcfg), tb)
    b = T.forward(listed, dataclasses.replace(port_cfg(jcfg),
                                              scan_layers=False), tb)
    assert torch.equal(a, b)
