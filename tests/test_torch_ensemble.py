"""Replica ensembles and parallel tempering: the port's ``"ensemble"`` and
``"tempering"`` scenarios, ``phase_curve``, ``run_chains_batched`` and
``measure_curve`` against the JAX package from the same seeds, bitwise
(state, per-sweep m and E, moments, extras, swap decisions)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import EngineConfig as JConfig  # noqa: E402
from repro.api import IsingEngine as JEngine  # noqa: E402
from repro.core import sampler as JS  # noqa: E402
from repro.core import tempering as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.api import (EngineConfig, EngineConfigError,  # noqa: E402
                             IsingEngine, beta_ladder)
from repro_torch.api.engine import replica_sweep_fns  # noqa: E402
from repro_torch.cluster import label as LBL  # noqa: E402
from repro_torch.core import ising3d as I3  # noqa: E402
from repro_torch.core import lattice as L  # noqa: E402
from repro_torch.core import sampler as S  # noqa: E402
from repro_torch.core import tempering as T  # noqa: E402

SIZE, BLOCK, SWEEPS = 16, 4, 4
BETAS = (0.3, 0.4406868, 0.6)


@functools.lru_cache(maxsize=None)
def _jax_engine(cfg: JConfig) -> JEngine:
    """One reference engine a config: its compiled chain serves every
    seed, so no test compiles the same chain twice."""
    return JEngine(cfg)


def _np(t):
    return bridge.to_numpy(t) if isinstance(t, torch.Tensor) else t


def _assert_same(got, want):
    np.testing.assert_array_equal(_np(got.state),
                                  np.asarray(want.state, np.float32))
    for a, b in ((got.magnetization, want.magnetization),
                 (got.energy, want.energy)):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(_np(a), np.asarray(b))
    if want.moments is None:
        assert got.moments is None
    else:
        assert got.moments.keys() == want.moments.keys()
        for k in want.moments:
            np.testing.assert_array_equal(got.moments[k], want.moments[k])
    assert got.extra == want.extra


def _both(seed=0, **kw):
    base = dict(size=SIZE, betas=BETAS, n_sweeps=SWEEPS, block_size=BLOCK)
    base.update(kw)
    got = IsingEngine(EngineConfig(**base), device="cpu").simulate(seed)
    want = _jax_engine(JConfig(**base)).simulate(seed)
    return got, want


# ---------------------------------------------------------------------------
# ensemble
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("measure", [True, False])
@pytest.mark.parametrize("rule", ["metropolis", "heat_bath"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ensemble_simulate_matches_jax(dtype, rule, measure):
    for seed in (0, 4):
        got, want = _both(seed, dtype=dtype, rule=rule, measure=measure)
        assert got.state.shape == (len(BETAS), 4, SIZE // 2, SIZE // 2)
        _assert_same(got, want)
        assert got.extra == {"betas": BETAS}


@pytest.mark.parametrize("kw", [
    dict(accept="exp", field=0.1, dtype="float32"),
    dict(measure_every=2, prob_dtype="bfloat16", width=8, n_sweeps=6),
    dict(betas=beta_ladder(0.9, 1.1, 4), hot=True),
])
def test_ensemble_options_match_jax(kw):
    got, want = _both(1, **kw)
    _assert_same(got, want)


def test_replica_i_is_a_single_chain_keyed_fold_in():
    """Replica i of an ensemble equals one chain keyed fold_in(key, i)."""
    key = jr.PRNGKey(3)
    betas = beta_ladder(0.8, 1.2, 4)
    eng = IsingEngine(EngineConfig(size=SIZE, betas=betas, n_sweeps=SWEEPS,
                                   block_size=BLOCK), device="cpu")
    res = eng.run(eng.init(key), key)
    assert res.magnetization.shape == (4, SWEEPS)
    for i, beta in enumerate(betas):
        ki = jr.fold_in(key, i)
        single = IsingEngine(EngineConfig(
            size=SIZE, beta=beta, n_sweeps=SWEEPS, block_size=BLOCK,
            hot=eng._auto_hot(beta)), device="cpu")
        sres = single.run(single.init(ki), ki)
        torch.testing.assert_close(res.state[i], sres.state, rtol=0, atol=0)
        torch.testing.assert_close(res.magnetization[i], sres.magnetization,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [1 << 25, 7])
def test_key_batch_draws_are_single_key_draws(chunk, monkeypatch):
    """Row i of every draw under a key batch is the draw under key i alone
    (also when the counters are generated in many chunks)."""
    monkeypatch.setattr(jr, "CHUNK", chunk)
    keys = [jr.fold_in(jr.PRNGKey(4), i) for i in range(3)]
    counters = torch.arange(30, dtype=torch.int32).view(3, 10) * 7919
    draws = [
        (jr.bits(keys, (5, 4)), [jr.bits(k, (5, 4)) for k in keys]),
        (jr.uniform(keys, (3, 6), torch.bfloat16),
         [jr.uniform(k, (3, 6), torch.bfloat16) for k in keys]),
        (jr.randint(keys, (), 1, 7), [jr.randint(k, (), 1, 7) for k in keys]),
        (jr.fold_in_bits(keys, counters),
         [jr.fold_in_bits(k, c) for k, c in zip(keys, counters)]),
        (jr.fold_in_bits(keys, jr.shared(keys, counters[0])),
         [jr.fold_in_bits(k, counters[0]) for k in keys]),
    ]
    for batch, singles in draws:
        torch.testing.assert_close(batch, torch.stack(singles), rtol=0,
                                   atol=0)
    assert jr.fold_in(keys, 5) == [jr.fold_in(k, 5) for k in keys]


_FAMILIES = [
    dict(),
    dict(rule="heat_bath", dtype="float32"),
    dict(dims=3),
    dict(model="potts", q=3, rule="heat_bath"),
    dict(model="potts", q=3, rule="metropolis"),
    dict(algorithm="swendsen_wang"),
    dict(algorithm="wolff"),
    dict(model="potts", q=3, algorithm="swendsen_wang"),
    dict(model="potts", q=3, algorithm="wolff"),
]


@pytest.mark.parametrize("kw", _FAMILIES, ids=lambda kw: "-".join(
    str(v) for v in kw.values()) or "ising")
def test_stack_sweep_is_each_replica_alone(kw):
    """One pass over a replica stack equals each replica swept alone with
    its own key and beta (state and per-replica m, E)."""
    betas = (0.3, 0.45, 0.9) if kw.get("model") != "potts" else (
        0.7, 1.0, 1.4)
    kw = dict(size=8, n_sweeps=2, block_size=BLOCK, **kw)
    if kw.get("dims") == 3:     # the engine has no 3-D ensembles
        cfg = EngineConfig(beta=betas[0], **kw)
        state = torch.stack([I3.random_lattice3d(jr.PRNGKey(i), 8, 8, 8)
                             for i in range(len(betas))])
    else:
        cfg = EngineConfig(betas=betas, **kw)
        state = IsingEngine(cfg, device="cpu").init(jr.PRNGKey(2))
    if cfg.algorithm != "metropolis" and cfg.model != "potts":
        state = L.from_quads(state)
    one_sweep, one_sweep_measured, rep_args = replica_sweep_fns(cfg)
    keys = [jr.fold_in(jr.PRNGKey(3), i) for i in range(len(betas))]
    args = rep_args(betas, torch.device("cpu"))
    for step in range(2):
        new, (m, e) = one_sweep_measured(state, keys, args, step)
        torch.testing.assert_close(one_sweep(state, keys, args, step), new,
                                   rtol=0, atol=0)
        for i, k in enumerate(keys):
            alone, (mi, ei) = one_sweep_measured(state[i], k, args[i], step)
            torch.testing.assert_close(new[i], alone, rtol=0, atol=0)
            assert (float(m[i]), float(e[i])) == (float(mi), float(ei))
        state = new


def test_stacked_labels_are_each_graph_alone():
    rng = np.random.default_rng(9)
    br = torch.from_numpy(rng.random((4, 12, 10)) < 0.55)
    bd = torch.from_numpy(rng.random((4, 12, 10)) < 0.55)
    LBL.reset_counters()
    lab = LBL.label_components(br, bd)
    stacked = LBL.counters["iterations"]
    iters = []
    for i in range(4):
        one, n = LBL.label_components(br[i], bd[i], with_iters=True)
        torch.testing.assert_close(lab[i], one, rtol=0, atol=0)
        iters.append(n)
    assert stacked == max(iters)


def test_ensemble_chunks_template_and_helpers():
    cfg = EngineConfig(size=SIZE, betas=BETAS, n_sweeps=SWEEPS,
                       block_size=BLOCK, measure=False)
    eng = IsingEngine(cfg, device="cpu")
    key = jr.PRNGKey(8)
    state = eng.init(key)
    before = state.clone()
    straight = eng.run(state, key).state
    torch.testing.assert_close(state, before, rtol=0, atol=0)
    torch.testing.assert_close(eng.run_sweeps(state, key, SWEEPS), straight,
                               rtol=0, atol=0)
    tmpl = eng.state_template()
    jtmpl = JEngine(JConfig(**{**cfg.__dict__})).state_template()
    assert tuple(tmpl.shape) == tuple(jtmpl.shape) == tuple(state.shape)
    assert tmpl.dtype == torch.bfloat16 and tmpl.device.type == "meta"
    jstate = JEngine(JConfig(**{**cfg.__dict__})).init(
        jnp.asarray(bridge.key_to_numpy(key)))
    np.testing.assert_array_equal(_np(state), np.asarray(jstate, np.float32))
    assert eng.magnetization(state) == float(jnp.mean(
        jstate.astype(jnp.float32)))


@pytest.mark.parametrize("full_stats", [False, True])
def test_phase_curve_matches_jax(full_stats):
    kw = dict(size=SIZE, betas=beta_ladder(0.7, 1.3, 3), n_sweeps=12,
              block_size=BLOCK)
    got = IsingEngine(EngineConfig(**kw), device="cpu").phase_curve(
        jr.PRNGKey(5), burnin=4, full_stats=full_stats)
    want = JEngine(JConfig(**kw)).phase_curve(jax.random.PRNGKey(5),
                                              burnin=4,
                                              full_stats=full_stats)
    assert got == want
    assert len(got) == 3 and ("chi" in got[0]) == full_stats
    with pytest.raises(EngineConfigError, match="phase_curve"):
        IsingEngine(EngineConfig(size=SIZE, beta=0.4, block_size=BLOCK),
                    device="cpu").phase_curve(jr.PRNGKey(0))


def test_run_chains_batched_matches_jax():
    cfg = dict(beta=0.4406868, n_sweeps=3, block_size=BLOCK)
    key = jr.PRNGKey(6)
    batch = torch.stack([S.init_state(jr.fold_in(key, 100 + i), SIZE, SIZE)
                         for i in range(3)])
    got = S.run_chains_batched(batch, key, S.ChainConfig(**cfg))
    want = JS.run_chains_batched(
        jnp.asarray(bridge.to_numpy(batch, jnp.bfloat16)),
        jnp.asarray(bridge.key_to_numpy(key)), JS.ChainConfig(**cfg))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32))
    assert got[1].shape == (3, 3)


def test_measure_curve_matches_jax():
    temps = (2.0, 2.269, 2.6)
    got = S.measure_curve(jr.PRNGKey(2), 8, temps, 6, 2)
    want = JS.measure_curve(jax.random.PRNGKey(2), 8, temps, 6, 2)
    assert got == want


# ---------------------------------------------------------------------------
# tempering
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tempering_simulate_matches_jax(seed, dtype):
    """Final replicas, the per-round |m| series and the swap fraction."""
    got, want = _both(seed, betas=beta_ladder(0.8, 1.3, 5), n_sweeps=8,
                      ensemble="tempering", exchange_every=2, dtype=dtype)
    _assert_same(got, want)
    assert got.magnetization.shape == (5, 4) and got.energy is None
    assert 0.0 <= got.extra["swap_fraction"] <= 1.0


@pytest.mark.parametrize("size,block", [(24, 4), (48, 8)])
def test_tempering_at_a_side_not_a_power_of_two_matches_jax(size, block):
    """With N not a power of two the energies E * N are not exact, where a
    fused E_i * N - E_j * N could part from the port's two rounded
    products: the swap decisions (many accepted), the series and the final
    replicas stay bitwise the reference's compiled run."""
    got, want = _both(3, size=size, block_size=block,
                      betas=beta_ladder(0.95, 1.1, 6), n_sweeps=40,
                      ensemble="tempering", exchange_every=2)
    _assert_same(got, want)
    assert got.extra["swap_fraction"] > 0.2


def test_swap_decisions_match_jax():
    """The swap round itself, on replicas whose energies straddle each
    other: accepted pairs and the permuted stack, round after round."""
    betas = (0.2, 0.35, 0.45, 0.6, 0.9, 1.4)
    n_acc = 0
    for trial in range(12):
        rng = np.random.default_rng(trial)
        full = rng.choice([-1.0, 1.0], (len(betas), 8, 8)).astype(np.float32)
        quads = torch.stack([L.to_quads(torch.from_numpy(f)) for f in full])
        key = jr.PRNGKey(40 + trial)
        for parity in (0, 1):
            got_q, got_acc = T._swap_round(
                quads, torch.tensor(betas), key, parity, 64)
            want_q, want_acc = JT._swap_round(
                jnp.asarray(quads.numpy()), jnp.asarray(betas, jnp.float32),
                jnp.asarray(bridge.key_to_numpy(key)), parity, 64)
            np.testing.assert_array_equal(got_acc.numpy(),
                                          np.asarray(want_acc))
            np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
            n_acc += int(got_acc.sum())
    assert n_acc > 0


def test_run_tempering_default_starts_match_jax():
    cfg = dict(betas=(0.3, 0.45, 0.6), n_rounds=3, exchange_every=2,
               block_size=4)
    got = T.run_tempering(jr.PRNGKey(9), 8, T.TemperingConfig(**cfg))
    want = JT.run_tempering(jax.random.PRNGKey(9), 8,
                            JT.TemperingConfig(**cfg))
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0],
                                                          np.float32))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == want[2]


def test_tempering_errors():
    base = dict(size=SIZE, betas=BETAS, ensemble="tempering",
                block_size=BLOCK, exchange_every=3, n_sweeps=4)
    eng = IsingEngine(EngineConfig(**base), device="cpu")
    with pytest.raises(EngineConfigError, match="multiple of"):
        eng.simulate(0)
    with pytest.raises(EngineConfigError, match="chunks"):
        eng.run_sweeps(eng.init(jr.PRNGKey(0)), jr.PRNGKey(0), 2)
