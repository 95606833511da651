"""The port's counter RNG, bridge and lattice layouts against the JAX package.

Every draw of ``repro_torch.random`` must equal ``jax.random`` bit for bit
(threefry2x32, partitionable counter layout), since every chain of the
port is held bitwise against the reference from the same seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lattice as JL  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.core import lattice as L  # noqa: E402

SEEDS = [0, 1, 7, 42, 12345, 2 ** 31 - 1, -1, -77]
SHAPES = [(1,), (7,), (3, 5), (2, 3, 5), (4, 16, 16), (2, 1, 3, 4, 4)]


def _key(jkey) -> tuple:
    return bridge.key_from_numpy(np.asarray(jkey))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_split_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = jr.PRNGKey(seed)
    assert _key(jk) == tk
    assert jr.key_data(tk) == tuple(int(x) for x in
                                    np.asarray(jax.random.key_data(jk)))
    for data in (0, 1, 5, 1000, 2 ** 31 - 1, 2 ** 32 - 1):
        assert _key(jax.random.fold_in(jk, data)) == jr.fold_in(tk, data)
    for num in (2, 3, 5):
        want = [_key(k) for k in jax.random.split(jk, num)]
        assert jr.split(tk, num) == want


def test_fold_in_chains_match_jax():
    """Deep fold_in / split chains, the way engines derive per-sweep and
    per-colour keys."""
    jk, tk = jax.random.PRNGKey(3), jr.PRNGKey(3)
    for step in range(40):
        jk = jax.random.fold_in(jax.random.fold_in(jk, step), step % 2)
        tk = jr.fold_in(jr.fold_in(tk, step), step % 2)
        if step % 7 == 0:
            jk = jax.random.split(jk)[1]
            tk = jr.split(tk)[1]
        assert _key(jk) == tk


@pytest.mark.parametrize("seed", SEEDS[:5])
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_match_jax(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 9)
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    got = jr.bits(_key(jk), shape)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(bridge.bits_to_numpy(got), want)


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16),
                                           (jnp.float16, torch.float16)])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_uniform_and_bernoulli_match_jax(jdtype, tdtype, seed):
    jk = jax.random.PRNGKey(seed)
    for shape in ((7,), (2, 3, 5), (4, 16, 16)):
        want = np.asarray(jax.random.uniform(jk, shape, jdtype), np.float32)
        got = jr.uniform(_key(jk), shape, tdtype)
        assert got.dtype == tdtype
        np.testing.assert_array_equal(got.float().numpy(), want)
        assert float(got.min()) >= 0.0 and float(got.max()) < 1.0
    for p in (0.5, 0.1):
        want = np.asarray(jax.random.bernoulli(jk, p, (9, 11)))
        np.testing.assert_array_equal(jr.bernoulli(_key(jk), p, (9, 11)),
                                      want)


def test_chunked_draws_equal_one_draw(monkeypatch):
    """Counter addressing: cutting the draw into chunks changes no bit."""
    key = jr.PRNGKey(5)
    whole_bits = jr.bits(key, (5, 37))
    whole_u = jr.uniform(key, (5, 37))
    monkeypatch.setattr(jr, "CHUNK", 16)
    torch.testing.assert_close(jr.bits(key, (5, 37)), whole_bits,
                               rtol=0, atol=0)
    torch.testing.assert_close(jr.uniform(key, (5, 37)), whole_u,
                               rtol=0, atol=0)


def test_seed_range_is_checked():
    with pytest.raises(ValueError):
        jr.PRNGKey(2 ** 31)
    with pytest.raises(ValueError):
        jr.uniform(jr.PRNGKey(0), (3,), torch.int32)


# ---------------------------------------------------------------------------
# bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jdtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("shape", [(4, 6, 10), (4, 2, 3, 4, 4), (8, 12)])
def test_bridge_round_trips(jdtype, shape):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.choice([-1.0, 1.0], size=shape), jdtype)
    t = bridge.to_torch(np.asarray(x))
    assert t.dtype == {jnp.bfloat16: torch.bfloat16,
                       jnp.float32: torch.float32}[jdtype]
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x, np.float32))
    back = bridge.to_numpy(t, jnp.bfloat16 if jdtype == jnp.bfloat16
                           else None)
    np.testing.assert_array_equal(np.asarray(jnp.asarray(back) == x), True)


def test_bridge_bits_and_keys():
    bits = np.asarray(jax.random.bits(jax.random.PRNGKey(2), (3, 8),
                                      jnp.uint32))
    t = bridge.bits_to_torch(bits)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(bridge.bits_to_numpy(t), bits)
    with pytest.raises(TypeError):
        bridge.to_torch(bits)
    key = jr.fold_in(jr.PRNGKey(4), 3)
    jkey = jnp.asarray(bridge.key_to_numpy(key))
    assert _key(jax.random.fold_in(jkey, 1)) == jr.fold_in(key, 1)


# ---------------------------------------------------------------------------
# lattice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("hw", [(8, 8), (16, 32), (6, 10)])
@pytest.mark.parametrize("jdtype,tdtype", [(jnp.bfloat16, torch.bfloat16),
                                           (jnp.float32, torch.float32)])
def test_random_lattice_matches_jax(seed, hw, jdtype, tdtype):
    jk = jax.random.PRNGKey(seed)
    want = np.asarray(JL.random_lattice(jk, *hw, jdtype), np.float32)
    got = L.random_lattice(_key(jk), *hw, tdtype)
    assert got.dtype == tdtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(L.cold_lattice(*hw, tdtype).float().numpy(),
                                  np.asarray(JL.cold_lattice(*hw, jdtype),
                                             np.float32))


@pytest.mark.parametrize("hw,bs", [((8, 8), 2), ((16, 32), 4), ((32, 16), 8)])
def test_layout_round_trips_and_match_jax(hw, bs):
    full_np = np.random.default_rng(1).choice([-1.0, 1.0], size=hw)
    full = torch.from_numpy(full_np).float()
    quads = L.to_quads(full)
    np.testing.assert_array_equal(
        quads.numpy(), np.asarray(JL.to_quads(jnp.asarray(full_np,
                                                          jnp.float32))))
    torch.testing.assert_close(L.from_quads(quads), full, rtol=0, atol=0)
    xb = L.block(quads[0], bs)
    np.testing.assert_array_equal(
        xb.numpy(), np.asarray(JL.block(jnp.asarray(quads[0].numpy()), bs)))
    torch.testing.assert_close(L.unblock(xb), quads[0], rtol=0, atol=0)
    with pytest.raises(ValueError):
        L.block(quads[0], 3)
    with pytest.raises(ValueError):
        L.to_quads(torch.zeros(5, 4))


@pytest.mark.parametrize("n", [2, 5, 8])
def test_kernels_and_masks_match_jax(n):
    np.testing.assert_array_equal(
        L.kernel_compact(n, torch.float32).numpy(),
        np.asarray(JL.kernel_compact(n, jnp.float32)))
    np.testing.assert_array_equal(
        L.kernel_naive(n, torch.float32).numpy(),
        np.asarray(JL.kernel_naive(n, jnp.float32)))
    for color in (0, 1):
        np.testing.assert_array_equal(
            L.color_mask(n, color, torch.float32).numpy(),
            np.asarray(JL.color_mask(n, color, jnp.float32)))
    assert L.kernel_compact(n).dtype == torch.bfloat16
    assert L.torch_dtype("float32") is torch.float32
    with pytest.raises(ValueError):
        L.torch_dtype("int8")
