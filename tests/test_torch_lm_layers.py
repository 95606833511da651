"""The port's LM building blocks against the JAX package's on the CPU:
norms, rotary tables, the flash attention forward and its custom VJP,
decode attention with both cache layouts and the ring buffer, the four
MLP activations, embeddings and the soft-capped unembedding.

Tolerances (f32): 1e-5 absolute on activations and attention outputs
(the two packages' f32 matmuls and transcendental functions differ in
summation order and last-ulp rounding only); gradients within 1e-4 of
the largest entry of each gradient. bf16 bounds are stated where used.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ATOL = 1e-5


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def _grad_close(got: torch.Tensor, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _cfg(**kw):
    """A small attention config (the reference's dataclass: the layers
    read attributes only)."""
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab_size=256, head_dim=16, dtype="float32")
    base.update(kw)
    return dataclasses.replace(jget_config("qwen3-0.6b"), **base)


# ---------------------------------------------------------------------------
# norms and rotary tables
# ---------------------------------------------------------------------------


def test_rms_norm_matches_jax():
    """f32 within 1e-5; a bf16 input gives the reference's bf16 output
    bitwise (the same f32 math, rounded once)."""
    rng = np.random.default_rng(0)
    x, scale = _normal(rng, (2, 5, 64)), _normal(rng, (64,))
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    xb = jnp.asarray(x, jnp.bfloat16)
    want = JL.rms_norm(xb, jnp.asarray(scale))
    got = L.rms_norm(bridge.to_torch(np.asarray(xb)), torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16
    _close(got, want, atol=0)


@pytest.mark.parametrize("sections", [(), (4, 2, 2)])
def test_rope_tables_and_apply_match_jax(sections):
    """cos/sin at positions up to 4095 (f32 angles, XLA's and torch's
    cos/sin), M-RoPE sections, and apply_rope."""
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4096, size=(2, 7)).astype(np.int32)
    if sections:
        pos = np.stack([pos, pos // 2, pos // 3], -1)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), 16, 1e6, sections)
    tc, ts = L.rope_cos_sin(torch.from_numpy(pos), 16, 1e6, sections)
    _close(tc, jc)
    _close(ts, js)
    x = _normal(rng, (2, 7, 3, 16))
    _close(L.apply_rope(torch.from_numpy(x), tc, ts),
           JL.apply_rope(jnp.asarray(x), jc, js))


def test_mrope_reduces_to_rope_for_text():
    pos = torch.arange(8)[None, :]
    c1, s1 = L.rope_cos_sin(pos, 32, 1e4)
    c2, s2 = L.rope_cos_sin(pos[..., None].expand(1, 8, 3), 32, 1e4,
                            (4, 6, 6))
    assert torch.equal(c1, c2) and torch.equal(s1, s2)
    with pytest.raises(ValueError, match="sections"):
        L.rope_cos_sin(pos[..., None].expand(1, 8, 2), 32, 1e4, (4, 6, 6))


# ---------------------------------------------------------------------------
# flash attention: forward and the custom backward
# ---------------------------------------------------------------------------


def _qkv(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, s, h, hd)), _normal(rng, (b, s, kv, hd)),
            _normal(rng, (b, s, kv, hd)))


@pytest.mark.parametrize("h,kv", [(4, 2), (4, 4), (4, 1)])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("chunks", [(16, 16), (32, 8)])
def test_flash_forward_and_grads_match_jax(h, kv, window, chunks):
    """Output of ``flash_attention`` and the grads of sum(sin(out))
    through the port's autograd Function against the reference's
    custom VJP, GQA / MHA / MQA, global and windowed, square and
    rectangular chunks."""
    b, s, hd = 2, 64, 16
    qc, kc = chunks
    q, k, v = _qkv(0, b, s, h, kv, hd)

    def jf(q, k, v):
        o = JL.flash_attention(q, k, v, causal=True, window=window,
                               q_chunk=qc, kv_chunk=kc)
        return jnp.sum(jnp.sin(o)), o

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = L.flash_attention(tq, tk, tv, causal=True, window=window,
                            q_chunk=qc, kv_chunk=kc)
    _close(out, jout)
    tgrads = torch.autograd.grad(torch.sum(torch.sin(out)), (tq, tk, tv))
    for got, want in zip(tgrads, jgrads):
        _grad_close(got, want)


def test_flash_bf16_scores_stay_f32():
    """bf16 q/k/v: the scores are f32 products of the bf16 values (not
    rounded to bf16), P is rounded to bf16 before P @ V, as the
    reference. The bf16 output comes out bitwise the reference's (every
    product exact, sums in f32, one rounding); the bf16 grads reach 1.1e-8
    of each gradient's largest entry (f32 sums in another order before the
    one rounding), held at 1e-6."""
    q, k, v = _qkv(3, 1, 64, 4, 2, 16)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))

    def jf(q, k, v):
        o = JL.flash_attention(q, k, v, q_chunk=16, kv_chunk=16)
        return jnp.sum(jnp.sin(o.astype(jnp.float32))), o

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(jq, jk, jv)
    tq, tk, tv = (bridge.to_torch(np.asarray(a)).requires_grad_()
                  for a in (jq, jk, jv))
    out = L.flash_attention(tq, tk, tv, q_chunk=16, kv_chunk=16)
    assert out.dtype == torch.bfloat16
    _close(out, jout, atol=0)
    tgrads = torch.autograd.grad(torch.sum(torch.sin(out.float())),
                                 (tq, tk, tv))
    for got, want in zip(tgrads, jgrads):
        assert got.dtype == torch.bfloat16
        _grad_close(got, want, rel=1e-6)


def test_flash_skips_dead_chunks_and_refuses_bad_chunks():
    live = [(qi, ki) for qi in range(4) for ki in range(4)
            if L._chunk_live(qi, ki, 16, 16, True, 0)]
    assert len(live) == 10                       # causal: 10 of 16 pairs
    assert sum(L._chunk_live(qi, ki, 16, 16, True, 8)
               for qi in range(4) for ki in range(4)) == 7
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 48, 2, 2, 8))
    with pytest.raises(ValueError, match="tile"):
        L.flash_attention(q, k, v, q_chunk=32)


# ---------------------------------------------------------------------------
# decode attention and caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["btkh", "bkth"])
@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention_and_cache_update_match_jax(layout, window):
    """Three decode positions (inside, at the end of and past the ring):
    cache_update then decode_attention, each against the reference."""
    b, h, kv, hd = 2, 4, 2, 16
    t = window or 24
    rng = np.random.default_rng(4)
    shape = (b, kv, t, hd) if layout == "bkth" else (b, t, kv, hd)
    kc, vc = _normal(rng, shape), _normal(rng, shape)
    jk, jv = jnp.asarray(kc), jnp.asarray(vc)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    for pos in (3, 7, 13):
        q = _normal(rng, (b, 1, h, hd))
        knew, vnew = _normal(rng, (b, 1, kv, hd)), _normal(rng, (b, 1, kv, hd))
        jk = JL.cache_update(jk, jnp.asarray(knew), pos, window, layout)
        jv = JL.cache_update(jv, jnp.asarray(vnew), pos, window, layout)
        L.cache_update(tk, torch.from_numpy(knew), pos, window, layout)
        L.cache_update(tv, torch.from_numpy(vnew), pos, window, layout)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        want = JL.decode_attention(jnp.asarray(q), jk, jv, pos,
                                   window=window, layout=layout)
        got = L.decode_attention(torch.from_numpy(q), tk, tv, pos,
                                 window=window, layout=layout)
        _close(got, want)


# ---------------------------------------------------------------------------
# MLP, embeddings, unembedding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_mlp_activations_match_jax(act):
    """All four activations with the same weights (gelu in its tanh form,
    jax.nn.gelu's default)."""
    cfg = _cfg(activation=act)
    rng = np.random.default_rng(5)
    p = {"wi": _normal(rng, (64, 128)) / 8, "wo": _normal(rng, (128, 64)) / 8}
    if act in ("swiglu", "geglu"):
        p["wg"] = _normal(rng, (64, 128)) / 8
    x = _normal(rng, (2, 5, 64))
    want = JL.mlp_forward({k: jnp.asarray(a) for k, a in p.items()}, cfg,
                          jnp.asarray(x))
    got = L.mlp_forward({k: torch.from_numpy(a) for k, a in p.items()}, cfg,
                        torch.from_numpy(x))
    _close(got, want)
    with pytest.raises(ValueError):
        L.mlp_forward({k: torch.from_numpy(a) for k, a in p.items()},
                      dataclasses.replace(cfg, activation="tanh"),
                      torch.from_numpy(x))


@pytest.mark.parametrize("codebooks,softcap", [(0, 0.0), (3, 30.0)])
def test_embed_and_unembed_match_jax(codebooks, softcap):
    cfg = _cfg(n_codebooks=codebooks, logit_softcap=softcap,
               vocab_pad_multiple=64)
    rng = np.random.default_rng(6)
    n = max(codebooks, 1)
    p = {"tok": _normal(rng, (n, cfg.padded_vocab, 64)),
         "out": _normal(rng, (64, n * cfg.padded_vocab)),
         "ln_f": np.ones(64, np.float32)}
    shape = (2, 5, codebooks) if codebooks else (2, 5)
    tokens = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    x = L.embed_tokens(tp, cfg, torch.from_numpy(tokens))
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(JL.embed_tokens(jp, cfg, jnp.asarray(tokens))))
    _close(L.unembed(tp, cfg, x), JL.unembed(jp, cfg, jnp.asarray(x.numpy())))
