"""The 3-D cube: the port's ``repro_torch.core.ising3d`` and the ``"3d"``
scenario against ``repro.core.ising3d`` and the JAX engine, bitwise."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import EngineConfig as JConfig  # noqa: E402
from repro.api import IsingEngine as JEngine  # noqa: E402
from repro.api import beta_ladder as j_beta_ladder  # noqa: E402
from repro.core import ising3d as JI3  # noqa: E402
from repro.core import observables as JO  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.api import EngineConfig, IsingEngine  # noqa: E402
from repro_torch.api import beta_ladder  # noqa: E402
from repro_torch.core import ising3d as I3  # noqa: E402
from repro_torch.core import observables as O  # noqa: E402


def _cube(seed, shape, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.choice([-1.0, 1.0], size=shape)
                            .astype(np.float32)).to(dtype)


def _j(t):
    return jnp.asarray(bridge.to_numpy(t, jnp.bfloat16)
                       if t.dtype == torch.bfloat16 else t.numpy())


@pytest.mark.parametrize("shape", [(4, 6, 8), (8, 8, 8), (3, 5, 7)])
def test_nn_and_energy_match_jax(shape):
    f = _cube(0, shape)
    want = np.asarray(JI3.nn_matmul3d(_j(f)), np.float32)
    np.testing.assert_array_equal(I3.nn_full3d(f).float().numpy(), want)
    np.testing.assert_array_equal(
        I3.nn_full3d(f).float().numpy(),
        np.asarray(JI3.nn_full3d(_j(f)), np.float32))
    e = O.energy_per_spin3d(f)
    assert float(e) == float(jax.jit(JO.energy_per_spin3d)(_j(f)))


def test_tables_match_jax_at_every_beta():
    """A Python-number beta: the table XLA folds in the reference's
    compiled sweep; a tensor beta: its compiled exp."""
    betas = np.linspace(0.0, 1.5, 151)
    x = jnp.arange(-6.0, 7.0, 2.0, dtype=jnp.float32)
    folded = np.asarray(jax.jit(lambda: jnp.stack(
        [jnp.exp(-2.0 * jnp.float32(float(b)) * x) for b in betas]))())
    for i, b in enumerate(betas):
        np.testing.assert_array_equal(I3.acceptance_table3d(float(b)).numpy(),
                                      folded[i])
        np.testing.assert_array_equal(
            I3.acceptance_table3d(torch.tensor(b, dtype=torch.float32))
            .numpy(), np.asarray(jnp.exp(-2.0 * jnp.float32(b) * x)))


def test_site_uniforms_masks_and_indices_match_jax():
    key = jr.PRNGKey(3)
    jkey = jax.random.PRNGKey(3)
    shape = (4, 6, 10)
    gi = I3.global_index3d(shape)
    np.testing.assert_array_equal(gi.numpy(),
                                  np.asarray(JI3.global_index3d(shape)))
    np.testing.assert_array_equal(
        I3.site_uniforms3d(key, gi).numpy(),
        np.asarray(JI3.site_uniforms3d(jkey, JI3.global_index3d(shape))))
    for color in (0, 1):
        np.testing.assert_array_equal(
            I3.parity_mask3d(shape, color).numpy(),
            np.asarray(JI3.parity_mask3d(shape, color)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("beta", [0.1, 0.2216546, 0.4])
def test_sweeps_match_jax(beta, dtype):
    f = _cube(1, (6, 6, 8), dtype)
    key = jr.PRNGKey(5)
    got, ms = I3.run_sweeps3d(f, key, 3, beta)
    want, jms = jax.jit(lambda x, k: JI3.run_sweeps3d(x, k, 3, beta))(
        _j(f), jax.random.PRNGKey(5))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(ms.numpy(), np.asarray(jms))
    probs = torch.from_numpy(np.random.default_rng(2).random(
        (6, 6, 8), dtype=np.float32))
    one = I3.update_color3d(f, probs, beta, 1)
    jone = jax.jit(lambda x, p: JI3.update_color3d(x, p, beta, 1))(
        _j(f), jnp.asarray(probs.numpy()))
    np.testing.assert_array_equal(one.float().numpy(),
                                  np.asarray(jone, np.float32))


@functools.lru_cache(maxsize=None)
def _jax_engine(cfg: JConfig) -> JEngine:
    """One reference engine a config: its compiled chain serves every
    seed, so no test compiles the same chain twice."""
    return JEngine(cfg)


@pytest.mark.parametrize("measure", [True, False])
@pytest.mark.parametrize("kw", [
    dict(size=8, beta=0.2216546, hot=True),
    dict(size=8, beta=0.35),
    dict(size=10, beta=0.15, dtype="float32"),
    dict(size=6, beta=0.3, hot=True, measure_every=2, n_sweeps=6),
])
def test_engine_3d_matches_jax(kw, measure):
    kw = {"n_sweeps": 4, "dims": 3, "block_size": 0, **kw}
    for seed in (0, 7):
        got = IsingEngine(EngineConfig(**kw, measure=measure),
                          device="cpu").simulate(seed)
        want = _jax_engine(JConfig(**kw, measure=measure)).simulate(seed)
        np.testing.assert_array_equal(bridge.to_numpy(got.state),
                                      np.asarray(want.state, np.float32))
        if not measure:
            assert got.magnetization is None and got.moments is None
            continue
        np.testing.assert_array_equal(got.magnetization.numpy(),
                                      np.asarray(want.magnetization))
        np.testing.assert_array_equal(got.energy.numpy(),
                                      np.asarray(want.energy))
        assert got.moments == want.moments


def test_engine_3d_helpers():
    cfg = EngineConfig(size=8, beta=0.3, n_sweeps=3, dims=3, block_size=0)
    eng = IsingEngine(cfg, device="cpu")
    jeng = JEngine(JConfig(**cfg.__dict__))
    assert eng._auto_hot(0.2) and not eng._auto_hot(0.3)
    assert jeng._auto_hot(0.2) and not jeng._auto_hot(0.3)
    tmpl = eng.state_template()
    assert tuple(tmpl.shape) == tuple(jeng.state_template().shape) == (8,) * 3
    key = jr.PRNGKey(1)
    state = eng.init(key)
    np.testing.assert_array_equal(
        bridge.to_numpy(state), np.asarray(jeng.init(jnp.asarray(
            bridge.key_to_numpy(key))), np.float32))
    cold = IsingEngine(EngineConfig(size=8, beta=0.1, n_sweeps=3, dims=3,
                                    block_size=0, hot=False),
                       device="cpu").init(key)
    assert bool((cold == 1).all())
    torch.testing.assert_close(eng.run_sweeps(state, key, 3),
                               eng.run(state, key).state, rtol=0, atol=0)
    assert beta_ladder(0.9, 1.1, 3, dims=3) == j_beta_ladder(0.9, 1.1, 3,
                                                             dims=3)
