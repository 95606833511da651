"""The port's decoder LM against the JAX package's on the CPU, with the
reference's parameters carried across (``bridge.lm_params_from_jax``):
logits, loss and parameter grads for the attention families at the
reference tests' ``small_config``, a sliding-window stack and a per-layer
list with attention biases, prefill followed by decode in both cache
layouts and the ring buffer, the model API around them, and the parameter
tree of every registered architecture at its published config.
(``test_torch_lm_ssm.py`` and ``test_torch_lm_moe.py`` hold the
recurrent, SSM and MoE families.)

Tolerances (f32): logits and loss within 1e-5 absolute; each parameter's
gradient within 1e-4 of its largest entry. The two packages' f32 matmuls,
reductions and transcendental functions differ in summation order and
last-ulp rounding only.
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
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

ATOL = 1e-5
GRAD_REL = 1e-4


def port_cfg(jcfg) -> ModelConfig:
    """The port's copy of a reference config (same fields and values)."""
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


def carried(jcfg, seed=0):
    """(reference params, the same params in the port). The init is
    jitted: eager, every op of it compiles on its own (13 s for kimi's
    small config)."""
    params = jax.jit(lambda k: JT.init_model(k, jcfg)[0])(
        jax.random.PRNGKey(seed))
    return params, bridge.lm_params_from_jax(
        jax.tree.map(np.asarray, params), port_cfg(jcfg))


def batch_pair(jcfg, seq=32, batch=2, seed=0):
    """One synthetic batch as JAX arrays and as tensors; the VLM stub gets
    random patch embeddings on a random third of the positions."""
    host = jsyn.host_batch(seed, JShape("t", seq, batch, "train"), jcfg)
    if jcfg.family == "vlm":
        rng = np.random.default_rng(seed)
        host["vision_embeds"] = rng.standard_normal(
            host["vision_embeds"].shape).astype(np.float32)
        host["vision_mask"] = rng.random(host["vision_mask"].shape) < 0.3
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(v) for k, v in host.items()})


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def _grads_close(tgrads, jgrads):
    jl = jax.tree.leaves(jgrads)
    tl = tree.paths(tgrads)
    assert len(jl) == len(tl)
    for (path, got), want in zip(tl, jl):
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= GRAD_REL * np.abs(want).max(), (path, err)


CASES = {
    "qwen3-0.6b": lambda: small_config("qwen3-0.6b"),
    "nemotron-4-15b": lambda: small_config("nemotron-4-15b"),
    "qwen2-vl-7b": lambda: small_config("qwen2-vl-7b"),
    "musicgen-medium": lambda: small_config("musicgen-medium"),
    "local": lambda: small_config("qwen3-0.6b", layer_pattern="l",
                                  window=8),
    "list": lambda: small_config("qwen3-0.6b", layer_pattern="al",
                                 window=8, scan_layers=False,
                                 attn_bias=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_loss_and_grads_match_jax(case):
    jcfg = dataclasses.replace(CASES[case](), dtype="float32")
    cfg = port_cfg(jcfg)
    jparams, tparams = carried(jcfg)
    jb, tb = batch_pair(jcfg)

    def jf(p, b):
        return JM.loss_fn(p, jcfg, b), JT.forward(p, jcfg, b)

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jf, has_aux=True))(jparams, jb)
    _close(T.forward(tparams, cfg, tb), jlogits)
    loss, grads = TS.value_and_grad(cfg)(tparams, tb)
    _close(loss, jloss)
    _grads_close(grads, jgrads)


def test_bf16_forward_loss_and_grads_within_bf16_rounding():
    """qwen3-0.6b's small config in its own dtype, bf16. Measured: logits
    differ by at most 2 bf16 ulps (0.03125 at |logit| < 4), the loss by
    7.6e-4, each gradient by 1.9% of its largest entry; held at 0.0625,
    2e-3 and 5e-2. The rounding points differ: XLA compiles the layer
    body and keeps some elementwise chains in f32 between roundings,
    eager PyTorch rounds each bf16 op's result."""
    jcfg = small_config("qwen3-0.6b")
    cfg = port_cfg(jcfg)
    jparams, tparams = carried(jcfg)
    jb, tb = batch_pair(jcfg)

    def jf(p, b):
        return JM.loss_fn(p, jcfg, b), JT.forward(p, jcfg, b)

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jf, has_aux=True))(jparams, jb)
    _close(T.forward(tparams, cfg, tb), jlogits, atol=0.0625)
    loss, grads = TS.value_and_grad(cfg)(tparams, tb)
    _close(loss, jloss, atol=2e-3)
    for (path, got), want in zip(tree.paths(grads),
                                 jax.tree.leaves(jgrads)):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 5e-2 * np.abs(want).max(), (path, err)


PREFILL_CASES = [
    # (layout, pattern, window, prompt length, max_len)
    ("btkh", "a", 0, 16, 24),
    ("bkth", "a", 0, 16, 24),
    ("btkh", "l", 8, 12, 0),     # prompt longer than the ring: rolled
    ("bkth", "l", 8, 6, 0),      # prompt shorter: padded ring
]


@pytest.mark.parametrize("layout,pattern,window,s,max_len", PREFILL_CASES)
def test_prefill_then_decode_matches_jax(layout, pattern, window, s,
                                         max_len):
    """Prefill a prompt, then 4 decode steps fed the greedy tokens: the
    last prefill logits, every decode step's logits and the final caches
    against the reference (the ring's ``pos % window`` slots included)."""
    jcfg = small_config("qwen3-0.6b", dtype="float32", cache_layout=layout,
                        layer_pattern=pattern, window=window)
    cfg = port_cfg(jcfg)
    jparams, tparams = carried(jcfg, seed=1)
    jb, tb = batch_pair(jcfg, seq=s)
    jb, tb = {"tokens": jb["tokens"]}, {"tokens": tb["tokens"]}
    jlogits, jstates = jax.jit(lambda p, b: JT.prefill(p, jcfg, b, max_len))(
        jparams, jb)
    logits, states = M.make_prefill(cfg, max_len)(tparams, tb)
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
    for name in ("k", "v"):
        _close(states[name], jstates[name])


def test_init_states_match_jax_shapes():
    for jcfg in (small_config("qwen3-0.6b", cache_layout="bkth"),
                 small_config("qwen3-0.6b", layer_pattern="al", window=8,
                              scan_layers=False)):
        want = JT.init_states(jcfg, 3, 20)
        got = T.init_states(port_cfg(jcfg), 3, 20)
        assert [tuple(a.shape) for a in tree.leaves(got)] == \
            [a.shape for a in jax.tree.leaves(want)]
        assert all(a.dtype == torch.bfloat16 and not a.any()
                   for a in tree.leaves(got))


def test_remat_does_not_change_loss_or_grads():
    cfg = port_cfg(small_config("qwen3-0.6b", remat=True))
    _, params = carried(small_config("qwen3-0.6b"))
    _, tb = batch_pair(small_config("qwen3-0.6b"))
    l1, g1 = TS.value_and_grad(cfg)(params, tb)
    l2, g2 = TS.value_and_grad(dataclasses.replace(cfg, remat=False))(
        params, tb)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g1),
                                                 tree.leaves(g2)))


def test_cross_entropy_masks_padded_vocab():
    logits = torch.zeros((1, 2, 8))
    logits[..., 5:] = 100.0
    # vocab_size=5: the huge logits in the padded tail must be masked out
    loss = M.cross_entropy(logits, torch.zeros((1, 2), dtype=torch.int32), 5)
    np.testing.assert_allclose(float(loss), np.log(5), rtol=1e-6)
    want = JM.cross_entropy(jnp.asarray(logits.numpy()),
                            jnp.zeros((1, 2), jnp.int32), 5)
    assert float(loss) == float(want)


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-0.6b",
                                  "nemotron-4-15b", "command-r-35b",
                                  "llama4-maverick-400b-a17b",
                                  "kimi-k2-1t-a32b", "qwen2-vl-7b",
                                  "musicgen-medium", "recurrentgemma-2b",
                                  "mamba2-780m"])
def test_full_config_tree_is_the_reference_tree(arch):
    """Every registered architecture at its published config: the port's
    parameter tree (on the ``meta`` device) has the reference's paths,
    shapes and dtypes (``jax.eval_shape`` of its init), and the port's
    config is the reference's field for field."""
    from repro.configs import get_config as jget_config
    jcfg = jget_config(arch)
    cfg = get_config(arch)
    assert cfg == port_cfg(jcfg)
    want = jax.eval_shape(
        lambda: JT.init_model(jax.random.PRNGKey(0), jcfg)[0])
    got = T.init_model(cfg, device="meta")
    assert [(p, tuple(a.shape), str(a.dtype).split(".")[-1])
            for p, a in tree.paths(got)] == [
        (p, tuple(a.shape), str(a.dtype)) for p, a in tree.paths(want)]


def test_module_holds_the_reference_paths():
    """``LanguageModel``'s state_dict keys are the reference's paths with
    "." for "/", its forward is the function's, and a tree of another
    config is refused by the bridge."""
    jcfg = small_config("qwen3-0.6b", dtype="float32")
    cfg = port_cfg(jcfg)
    jparams, tparams = carried(jcfg)
    model = T.LanguageModel(cfg, tparams)
    want = [p.replace("/", ".") for p, _ in tree.paths(tparams)]
    assert sorted(model.state_dict()) == sorted(
        "params." + p for p in want)
    _, tb = batch_pair(jcfg)
    assert torch.equal(model(tb), T.forward(tparams, cfg, tb))
    listed = port_cfg(small_config("qwen3-0.6b", scan_layers=False))
    assert "params.layers.1.attn.wq" in T.LanguageModel.init(
        listed, device="meta").state_dict()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.LanguageModel.init(listed)
    with pytest.raises(ValueError, match="does not match"):
        bridge.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                  dataclasses.replace(cfg, d_ff=96))


def test_init_follows_the_reference_distributions():
    """Same tree, shapes and dtypes as the reference's init; fan-in
    scaled normals (std within 5%), ones for the norms."""
    jcfg = small_config("qwen3-0.6b", d_model=128, d_ff=256)
    cfg = port_cfg(jcfg)
    gen = torch.Generator().manual_seed(0)
    params = T.init_model(cfg, gen)
    jshapes = jax.eval_shape(
        lambda: JT.init_model(jax.random.PRNGKey(0), jcfg)[0])
    got = tree.paths(params)
    assert [(p, tuple(a.shape)) for p, a in got] == [
        (p, tuple(a.shape)) for p, a in tree.paths(jshapes)]
    assert all(a.dtype == torch.bfloat16 for _, a in got)
    leaves = dict(got)
    for path, fan_in in (("layers/attn/wq", 128), ("layers/attn/wo", 4 * 16),
                         ("layers/mlp/wo", 256), ("emb/out", 128),
                         ("emb/tok", 1)):
        std = float(leaves[path].float().std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.05, (path, std)
    assert bool((leaves["layers/ln1"] == 1).all())
