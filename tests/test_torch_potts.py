"""The q-state Potts plane: the port's ``repro_torch.potts`` (state,
checkerboard heat-bath / Metropolis, FK bonds, Swendsen-Wang / Wolff) and
the ``"potts_cb"`` / ``"potts_cluster"`` scenarios against
``repro.potts`` and the JAX engine, bitwise; q = 2 against Ising."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import EngineConfig as JConfig  # noqa: E402
from repro.api import IsingEngine as JEngine  # noqa: E402
from repro.potts import bonds as JPB  # noqa: E402
from repro.potts import rules as JPR  # noqa: E402
from repro.potts import state as JPS  # noqa: E402
from repro.potts import sweep as JPW  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.api import EngineConfig, IsingEngine  # noqa: E402
from repro_torch.cluster import bonds as CB  # noqa: E402
from repro_torch.potts import bonds as PB  # noqa: E402
from repro_torch.potts import rules as PR  # noqa: E402
from repro_torch.potts import state as PS  # noqa: E402
from repro_torch.potts import sweep as PW  # noqa: E402

BETAS = np.linspace(0.0, 3.0, 301).astype(np.float32)


def _colours(seed, q, h=16, w=24):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, q, (h, w)).astype(np.int32))


def _key(seed):
    return jr.PRNGKey(seed), jax.random.PRNGKey(seed)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", [2, 3, 5, 256])
def test_random_state_and_stats_match_jax(q):
    key, jkey = _key(q)
    for h, w in ((16, 24), (10, 14), (32, 32)):
        f = PS.random_state(key, h, w, q)
        jf = JPS.random_state(jkey, h, w, q)
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        m, e = PS.full_stats(f, q)
        jm, je = jax.jit(lambda x: JPS.full_stats(x, q))(jf)
        assert (float(m), float(e)) == (float(jm), float(je))
        np.testing.assert_array_equal(
            PS.agreement_count(f, f).numpy(),
            np.asarray(JPS.agreement_count(jf, jf)))
        np.testing.assert_array_equal(PS.state_counts(f, q).numpy(),
                                      np.asarray(JPS.state_counts(jf, q)))
    assert PS.beta_c(q) == JPS.beta_c(q)
    assert float(PS.order_parameter(PS.cold_state(8, 8), q)) == 1.0


def test_q2_maps_to_ising():
    rng = np.random.default_rng(1)
    ising = torch.from_numpy(rng.choice([-1.0, 1.0], (8, 12))
                             .astype(np.float32))
    potts = PS.ising_to_potts(ising)
    np.testing.assert_array_equal(potts.numpy(), np.asarray(
        JPS.ising_to_potts(jnp.asarray(ising.numpy()))))
    torch.testing.assert_close(PS.potts_to_ising(potts), ising, rtol=0,
                               atol=0)
    assert PS.beta_c(2) == pytest.approx(2 * 0.44068679350977147)


# ---------------------------------------------------------------------------
# thresholds and bonds
# ---------------------------------------------------------------------------


def test_thresholds_match_jax_at_every_beta():
    """Bond and Metropolis thresholds and heat-bath weights on the
    301-point grid: a Python-number beta against the reference jitted with
    the beta as a literal (its tables fold at compile time), a tensor beta
    against the traced reference, and the tensor form against the
    reference's host ints (its eager form)."""
    np.testing.assert_array_equal(
        PB.bond_threshold_traced(torch.from_numpy(BETAS)).numpy(),
        np.asarray(JPB.bond_threshold_traced(jnp.asarray(BETAS))))
    lit_metro = jax.jit(lambda: jnp.stack(
        [JPR.metropolis_thresholds_traced(float(b)) for b in BETAS]))()
    lit_hb = jax.jit(lambda: jnp.stack(
        [JPR.heat_bath_weight_table(float(b)) for b in BETAS]))()
    trc_metro = jax.jit(jax.vmap(JPR.metropolis_thresholds_traced))(BETAS)
    trc_hb = jax.jit(jax.vmap(JPR.heat_bath_weight_table))(BETAS)
    n_differ = 0
    for i, b in enumerate(BETAS):
        fb = float(b)
        assert PB.bond_threshold_u24(fb) == JPB.bond_threshold_u24(fb)
        assert PR.metropolis_thresholds_traced(torch.tensor(b)).tolist() \
            == JPR.metropolis_thresholds_u24(fb)
        for beta, metro, hb in ((fb, lit_metro, lit_hb),
                                (torch.tensor(b), trc_metro, trc_hb)):
            np.testing.assert_array_equal(
                PR.metropolis_thresholds_traced(beta).numpy(),
                np.asarray(metro[i]))
            np.testing.assert_array_equal(
                PR.heat_bath_weight_table(beta).numpy(), np.asarray(hb[i]))
        n_differ += int((np.asarray(lit_hb[i]) != np.asarray(trc_hb[i])).any())
    assert n_differ > 0      # both forms are exercised


def test_q2_bond_thresholds_are_ising():
    for b in BETAS[::10]:
        assert PB.bond_threshold_u24(2 * float(b)) == \
            CB.bond_threshold_u24(float(b))


@pytest.mark.parametrize("q", [2, 3, 7])
def test_colour_draws_and_bonds_match_jax(q):
    key, jkey = _key(5)
    gi = CB.global_index(12, 16)
    bits = CB.counter_bits(key, gi)
    jbits = JPB.counter_bits(jkey, JPB.global_index(12, 16))
    np.testing.assert_array_equal(PB.cluster_states(bits, q).numpy(),
                                  np.asarray(JPB.cluster_states(jbits, q)))
    f = _colours(q, q, 12, 16)
    jf = jnp.asarray(f.numpy())
    np.testing.assert_array_equal(PR.uniform_other(bits, f, q).numpy(),
                                  np.asarray(JPR.uniform_other(jbits, jf, q)))
    t = PB.bond_threshold_u24(1.1)
    for got, want in zip(PB.fk_bonds(f, key, t), JPB.fk_bonds(jf, jkey, t)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if q == 2:   # the Ising SW coin: the top hash bit
        np.testing.assert_array_equal(PB.cluster_states(bits, 2).numpy(),
                                      ((bits >> 31) & 1).numpy())


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", ["heat_bath", "metropolis"])
@pytest.mark.parametrize("q", [2, 3, 5])
def test_checkerboard_sweeps_match_jax(q, rule):
    f = _colours(0, q)
    jf = jnp.asarray(f.numpy())
    for beta in (0.3, PS.beta_c(q), 2.1):
        key, jkey = _key(int(beta * 100))
        got, (m, e) = PR.checkerboard_sweep_measured(f, key, beta, q, rule)
        want, (jm, je) = jax.jit(
            lambda x, k: JPR.checkerboard_sweep_measured(x, k, beta, q,
                                                         rule))(jf, jkey)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (float(m), float(e)) == (float(jm), float(je))
        traced = PR.checkerboard_sweep(f, key, torch.tensor(beta), q, rule)
        jtraced = jax.jit(lambda x, k, b: JPR.checkerboard_sweep(
            x, k, b, q, rule))(jf, jkey, jnp.float32(beta))
        np.testing.assert_array_equal(traced.numpy(), np.asarray(jtraced))
        # one parity class per half-update
        half = PR.heat_bath_color(f, key, beta, q, 1)
        changed = (half != f).numpy()
        assert not changed[PR.parity_mask(16, 24, 0).numpy()].any()


@pytest.mark.parametrize("algo", ["swendsen_wang", "wolff"])
@pytest.mark.parametrize("q", [2, 3, 4])
def test_cluster_sweeps_match_jax(q, algo):
    f = _colours(1, q)
    jf = jnp.asarray(f.numpy())
    t = PB.bond_threshold_u24(PS.beta_c(q))
    for step in range(3):
        key, jkey = _key(30 + step)
        got, (m, e) = PW.cluster_sweep_measured(f, key, t, q, algo)
        want, (jm, je) = jax.jit(lambda x, k: JPW.cluster_sweep_measured(
            x, k, t, q, algo))(jf, jkey)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (float(m), float(e)) == (float(jm), float(je))
        lab = PW.labels_for(f, key, t).numpy()
        np.testing.assert_array_equal(lab, np.asarray(
            JPW.labels_for(jf, jkey, t)))
        moved = (got != f).numpy()
        if algo == "wolff":
            assert len(np.unique(lab[moved])) <= 1
        assert int(PW.wolff_target_shift(key, q)) == int(
            JPW.wolff_target_shift(jkey, q))
        f, jf = got, want


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_engine(cfg: JConfig) -> JEngine:
    """One reference engine a config: its compiled chain serves every
    seed, so no test compiles the same chain twice."""
    return JEngine(cfg)


def _engine_pair(seed, **kw):
    base = dict(size=16, n_sweeps=4, block_size=4, model="potts")
    base.update(kw)
    got = IsingEngine(EngineConfig(**base), device="cpu").simulate(seed)
    want = _jax_engine(JConfig(**base)).simulate(seed)
    np.testing.assert_array_equal(got.state.numpy(), np.asarray(want.state))
    assert got.state.dtype == torch.int32
    assert got.extra == want.extra
    if want.magnetization is None:
        assert got.magnetization is None and got.moments is None
        return got
    np.testing.assert_array_equal(got.magnetization.numpy(),
                                  np.asarray(want.magnetization))
    np.testing.assert_array_equal(got.energy.numpy(),
                                  np.asarray(want.energy))
    for k in want.moments:
        np.testing.assert_array_equal(got.moments[k], want.moments[k])
    return got


@pytest.mark.parametrize("measure", [True, False])
@pytest.mark.parametrize("rule", ["heat_bath", "metropolis"])
@pytest.mark.parametrize("q", [2, 3])
def test_engine_potts_cb_matches_jax(q, rule, measure):
    for seed in (0, 2):
        _engine_pair(seed, q=q, beta=PS.beta_c(q), rule=rule,
                     measure=measure)
    got = _engine_pair(1, q=q, betas=(0.6, 1.0, 1.4), rule=rule,
                       measure=measure)
    assert got.state.shape == (3, 16, 16)


@pytest.mark.parametrize("algo", ["swendsen_wang", "wolff"])
@pytest.mark.parametrize("q", [2, 3])
def test_engine_potts_cluster_matches_jax(q, algo):
    for seed in (0, 4):
        _engine_pair(seed, q=q, beta=PS.beta_c(q), algorithm=algo)
    _engine_pair(1, q=q, betas=(0.7, 1.3), algorithm=algo, measure=False)
    _engine_pair(3, q=q, betas=(0.7, 1.3), algorithm=algo, hot=True,
                 width=24, measure_every=2)


def test_q2_potts_clusters_are_ising_at_twice_beta():
    """q = 2 at beta_potts = 2 beta_ising: the same bonds and labels from
    the mapped state, and the SW colour is the Ising coin bit."""
    from repro_torch.cluster import sweep as CS
    rng = np.random.default_rng(3)
    ising = torch.from_numpy(rng.choice([-1.0, 1.0], (16, 16))
                             .astype(np.float32))
    potts = PS.ising_to_potts(ising)
    for beta in (0.3, 0.4406868, 0.6):
        key = jr.PRNGKey(int(beta * 1000))
        lab_i = CS.labels_for(ising, key, CB.bond_threshold_u24(beta))
        lab_p = PW.labels_for(potts, key, PB.bond_threshold_u24(2 * beta))
        torch.testing.assert_close(lab_i, lab_p, rtol=0, atol=0)
        coins = CB.counter_bits(jr.fold_in(key, 1), lab_p)
        new = PW.cluster_sweep(potts, key, PB.bond_threshold_u24(2 * beta),
                               2, "swendsen_wang")
        torch.testing.assert_close(new, ((coins >> 31) & 1).to(torch.int32),
                                   rtol=0, atol=0)


def test_engine_potts_helpers():
    cfg = EngineConfig(size=16, beta=1.0, n_sweeps=3, block_size=4,
                       model="potts", q=3)
    eng = IsingEngine(cfg, device="cpu")
    jeng = JEngine(JConfig(**cfg.__dict__))
    assert eng._auto_hot(0.9) == jeng._auto_hot(0.9)
    assert eng._auto_hot(1.1) == jeng._auto_hot(1.1)
    tmpl = eng.state_template()
    assert tmpl.dtype == torch.int32
    assert tuple(tmpl.shape) == tuple(jeng.state_template().shape)
    key = jr.PRNGKey(2)
    state = eng.init(key)
    torch.testing.assert_close(eng.run_sweeps(state, key, 3),
                               eng.run(state, key).state, rtol=0, atol=0)
    ens = EngineConfig(size=16, betas=(0.9, 1.2), n_sweeps=3, block_size=4,
                       model="potts", q=3, algorithm="wolff")
    assert tuple(IsingEngine(ens, device="cpu").state_template().shape) == \
        tuple(JEngine(JConfig(**ens.__dict__)).state_template().shape)
