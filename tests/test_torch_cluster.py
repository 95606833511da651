"""The cluster plane: the port's ``repro_torch.cluster`` (FK bonds, labels,
Swendsen-Wang / Wolff) and the ``"cluster"`` scenario, scalar and
multi-beta, against ``repro.cluster``, the JAX engine and the scipy
connected-components oracle of ``tests/test_cluster.py``, bitwise."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import EngineConfig as JConfig  # noqa: E402
from repro.api import IsingEngine as JEngine  # noqa: E402
from repro.cluster import bonds as JB  # noqa: E402
from repro.cluster import label as JLBL  # noqa: E402
from repro.cluster import sweep as JCS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.api import EngineConfig, IsingEngine  # noqa: E402
from repro_torch.cluster import bonds as B  # noqa: E402
from repro_torch.cluster import label as LBL  # noqa: E402
from repro_torch.cluster import sweep as CS  # noqa: E402
from repro_torch.core import lattice as L  # noqa: E402

BETA_C = 0.4406868


def _scipy_labels(br: np.ndarray, bd: np.ndarray) -> np.ndarray:
    """Canonical min-index component labels from scipy's csgraph (the
    reference tests' oracle)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    h, w = br.shape
    n = h * w
    idx = np.arange(n).reshape(h, w)
    rows, cols = [], []
    for i, j in zip(*np.nonzero(br)):
        rows.append(idx[i, j])
        cols.append(idx[i, (j + 1) % w])
    for i, j in zip(*np.nonzero(bd)):
        rows.append(idx[i, j])
        cols.append(idx[(i + 1) % h, j])
    g = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    ncomp, comp = connected_components(g, directed=False)
    lab = np.zeros(n, np.int32)
    for c in range(ncomp):
        members = np.nonzero(comp == c)[0]
        lab[members] = members.min()
    return lab.reshape(h, w)


def _lattice(seed, h, w):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.choice([-1.0, 1.0], size=(h, w))
                            .astype(np.float32))


def _key(seed):
    return jr.PRNGKey(seed), jax.random.PRNGKey(seed)


# ---------------------------------------------------------------------------
# counter RNG and bonds
# ---------------------------------------------------------------------------


def test_counter_bits_and_randint_match_jax():
    key, jkey = _key(11)
    c = np.concatenate([np.arange(-3, 3999, dtype=np.int32),
                        np.int32([2 ** 31 - 1, 123456789])]).reshape(-1, 7)
    np.testing.assert_array_equal(
        bridge.bits_to_numpy(B.counter_bits(key, torch.from_numpy(c))),
        np.asarray(JB.counter_bits(jkey, jnp.asarray(c))))
    for shape, lo, hi in (((), 0, 4096), ((9, 5), 1, 3), ((300,), -7, 250),
                          ((4,), 5, 5), ((50,), 0, 2 ** 30 + 3)):
        np.testing.assert_array_equal(
            jr.randint(key, shape, lo, hi).numpy(),
            np.asarray(jax.random.randint(jkey, shape, lo, hi, jnp.int32)))


def test_bond_thresholds_match_jax_at_every_beta():
    """Host and tensor thresholds, both XLA's f32 exp (the reference
    computes them eagerly), equal to JAX's on the 301-point grid."""
    betas = np.linspace(0.0, 3.0, 301).astype(np.float32)
    np.testing.assert_array_equal(
        B.bond_threshold_traced(torch.from_numpy(betas)).numpy(),
        np.asarray(JB.bond_threshold_traced(jnp.asarray(betas))))
    for b in betas:
        assert B.bond_threshold_u24(float(b)) == JB.bond_threshold_u24(
            float(b))
        assert B.bond_prob_f32(float(b)) == JB.bond_prob_f32(float(b))
    ts = bridge.thresholds_to_torch(JB.bond_threshold_traced(
        jnp.asarray(betas)))
    assert ts.dtype == torch.int64
    np.testing.assert_array_equal(bridge.thresholds_to_numpy(ts),
                                  np.asarray(JB.bond_threshold_traced(
                                      jnp.asarray(betas))))


@pytest.mark.parametrize("hw", [(8, 8), (12, 20), (16, 6)])
@pytest.mark.parametrize("beta", [0.2, BETA_C, 0.9])
def test_fk_bonds_match_jax(hw, beta):
    full = _lattice(hw[0] + hw[1], *hw)
    key, jkey = _key(3)
    t = B.bond_threshold_u24(beta)
    br, bd = B.fk_bonds(full, key, t)
    jbr, jbd = JB.fk_bonds(jnp.asarray(full.numpy()), jkey, t)
    np.testing.assert_array_equal(br.numpy(), np.asarray(jbr))
    np.testing.assert_array_equal(bd.numpy(), np.asarray(jbd))
    np.testing.assert_array_equal(
        B.global_index(4, 5).numpy(), np.asarray(JB.global_index(4, 5)))
    # bonds join parallel spins only
    assert not (br & (full != torch.roll(full, -1, 1))).any()


# ---------------------------------------------------------------------------
# labels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("p", [0.15, 0.5, 0.85])
def test_labels_match_scipy_and_jax(seed, p):
    rng = np.random.default_rng(seed)
    for h, w in ((12, 12), (8, 20), (16, 8)):
        br = rng.random((h, w)) < p
        bd = rng.random((h, w)) < p
        got, iters = LBL.label_components(torch.from_numpy(br),
                                          torch.from_numpy(bd),
                                          with_iters=True)
        jlab, jiters = JLBL.label_components(jnp.asarray(br),
                                             jnp.asarray(bd),
                                             with_iters=True)
        np.testing.assert_array_equal(got.numpy(), _scipy_labels(br, bd))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jlab))
        assert iters == int(jiters)
        # the fixed point does not depend on the changed-flag cadence
        one = LBL.label_components(torch.from_numpy(br),
                                   torch.from_numpy(bd), rounds_per_iter=1)
        torch.testing.assert_close(one, got, rtol=0, atol=0)


def test_label_edge_cases_and_counters():
    z = torch.zeros((6, 6), dtype=torch.bool)
    LBL.reset_counters()
    lab, iters = LBL.label_components(z, z, with_iters=True)
    assert (lab.numpy() == np.arange(36).reshape(6, 6)).all() and iters == 1
    o = torch.ones((6, 10), dtype=torch.bool)
    assert bool((LBL.label_components(o, o) == 0).all())
    # a serpentine single cluster, the pure-flood worst case
    br = np.ones((8, 8), bool)
    br[:, -1] = False
    bd = np.zeros((8, 8), bool)
    for i in range(7):
        bd[i, -1 if i % 2 == 0 else 0] = True
    lab, iters = LBL.label_components(torch.from_numpy(br),
                                      torch.from_numpy(bd), with_iters=True)
    assert bool((lab == 0).all())
    _, jiters = JLBL.label_components(jnp.asarray(br), jnp.asarray(bd),
                                      with_iters=True)
    assert iters == int(jiters)
    LBL.reset_counters()
    LBL.label_components(torch.from_numpy(br), torch.from_numpy(bd))
    assert LBL.counters["iterations"] == iters > 2


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["swendsen_wang", "wolff"])
@pytest.mark.parametrize("beta", [0.3, BETA_C, 0.6])
def test_cluster_sweeps_match_jax(algo, beta):
    full = _lattice(4, 16, 24)
    jfull = jnp.asarray(full.numpy())
    t = B.bond_threshold_u24(beta)
    for step in range(3):
        key, jkey = _key(20 + step)
        got, (m, e) = CS.cluster_sweep_measured(full, key, t, algo)
        want, (jm, je) = jax.jit(
            lambda f, k: JCS.cluster_sweep_measured(f, k, t, algo))(
            jfull, jkey)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (float(m), float(e)) == (float(jm), float(je))
        np.testing.assert_array_equal(
            CS.labels_for(full, key, t).numpy(),
            np.asarray(JCS.labels_for(jfull, jkey, t)))
        full, jfull = got, want


def test_sw_flips_whole_clusters_and_wolff_one():
    full = _lattice(5, 16, 16)
    key = jr.PRNGKey(6)
    t = B.bond_threshold_u24(BETA_C)
    lab = CS.labels_for(full, key, t).numpy()
    for algo in ("swendsen_wang", "wolff"):
        flipped = (CS.cluster_sweep(full, key, t, algo) != full).numpy()
        for c in np.unique(lab):
            assert flipped[lab == c].all() or not flipped[lab == c].any()
        if algo == "wolff":
            assert len(np.unique(lab[flipped])) == 1


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_engine(cfg: JConfig) -> JEngine:
    """One reference engine a config: its compiled chain serves every
    seed, so no test compiles the same chain twice."""
    return JEngine(cfg)


@pytest.mark.parametrize("measure", [True, False])
@pytest.mark.parametrize("algo", ["swendsen_wang", "wolff"])
@pytest.mark.parametrize("betas", [None, (0.35, BETA_C, 0.55)])
def test_engine_cluster_matches_jax(betas, algo, measure):
    kw = dict(size=16, n_sweeps=4, block_size=4, algorithm=algo,
              measure=measure)
    kw.update(dict(betas=betas) if betas else dict(beta=BETA_C))
    for seed in (0, 3):
        got = IsingEngine(EngineConfig(**kw), device="cpu").simulate(seed)
        want = _jax_engine(JConfig(**kw)).simulate(seed)
        np.testing.assert_array_equal(bridge.to_numpy(got.state),
                                      np.asarray(want.state, np.float32))
        assert got.extra == want.extra
        if not measure:
            assert got.magnetization is None and got.moments is None
            continue
        np.testing.assert_array_equal(got.magnetization.numpy(),
                                      np.asarray(want.magnetization))
        np.testing.assert_array_equal(got.energy.numpy(),
                                      np.asarray(want.energy))
        for k in want.moments:
            np.testing.assert_array_equal(got.moments[k], want.moments[k])


def test_engine_cluster_replica_contract_and_helpers():
    """Replica i of a multi-beta SW run is a scalar run keyed
    fold_in(key, i) (the traced thresholds equal the host ones)."""
    betas = (0.35, 0.5)
    kw = dict(size=16, n_sweeps=3, block_size=4, algorithm="swendsen_wang")
    eng = IsingEngine(EngineConfig(betas=betas, **kw), device="cpu")
    key = jr.PRNGKey(2)
    res = eng.run(eng.init(key), key)
    for i, beta in enumerate(betas):
        ki = jr.fold_in(key, i)
        single = IsingEngine(EngineConfig(beta=beta, hot=eng._auto_hot(beta),
                                          **kw), device="cpu")
        sres = single.run(single.init(ki), ki)
        torch.testing.assert_close(res.state[i], sres.state, rtol=0, atol=0)
        torch.testing.assert_close(res.energy[i], sres.energy, rtol=0,
                                   atol=0)
    assert tuple(eng.state_template().shape) == (2, 4, 8, 8)
    state = eng.init(key)
    torch.testing.assert_close(eng.run_sweeps(state, key, 3),
                               IsingEngine(EngineConfig(
                                   betas=betas, measure=False, **kw),
                                   device="cpu").run(state, key).state,
                               rtol=0, atol=0)
    full = L.from_quads(state[0])
    m, _ = CS.full_stats(full)
    assert float(m) == eng.magnetization(state[0])


def test_wolff_seed_beyond_2_16_sites():
    """randint's uint32 multiplier wraps to 0 once the span passes 2^16:
    the Wolff seed on a 272 x 256 torus follows the reference."""
    full = _lattice(9, 272, 256)
    t = B.bond_threshold_u24(0.3)
    for seed in (1, 2):
        key, jkey = _key(seed)
        got = CS.cluster_sweep(full, key, t, "wolff")
        want = jax.jit(lambda f, k: JCS.cluster_sweep(f, k, t, "wolff"))(
            jnp.asarray(full.numpy()), jkey)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert bool((got != full).any())
