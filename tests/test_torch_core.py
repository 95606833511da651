"""The port's XLA f32 functions, update rules, checkerboard sweeps,
measurement plane and observables against the JAX package, bitwise, and
against the port's own full-lattice oracle."""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import checkerboard as JCB  # noqa: E402
from repro.core import measure as JM  # noqa: E402
from repro.core import observables as JO  # noqa: E402
from repro.core import update_rules as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import checkerboard as CB  # noqa: E402
from repro_torch.core import lattice as L  # noqa: E402
from repro_torch.core import measure as M  # noqa: E402
from repro_torch.core import observables as O  # noqa: E402
from repro_torch.core import update_rules as R  # noqa: E402
from repro_torch.core import xla_f32 as XF  # noqa: E402

BETAS = (0.0, 0.1, 0.3, 0.4406868, 0.7, 1.0, 1.5, 2.5)
DTYPES = [(jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)]


def _np32(x):
    return np.asarray(x, np.float32)


def _site_inputs(seed, n=4096):
    """sigma in {-1, 1}, nn in {-4, -2, 0, 2, 4}, uniforms, uint32 bits."""
    rng = np.random.default_rng(seed)
    sigma = rng.choice([-1.0, 1.0], size=n).astype(np.float32)
    nn = rng.choice([-4.0, -2.0, 0.0, 2.0, 4.0], size=n).astype(np.float32)
    probs = rng.random(n, dtype=np.float32)
    bits = rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)
    return sigma, nn, probs, bits


# ---------------------------------------------------------------------------
# update_rules
# ---------------------------------------------------------------------------


def test_registry_names_and_aliases():
    assert R.get_rule("lut") is R.metropolis_lut
    assert R.get_rule("metropolis") is R.metropolis_lut
    assert R.get_rule("exp") is R.metropolis_exp
    assert R.get_rule("glauber") is R.heat_bath
    assert R.get_rule("int") is R.metropolis_int
    assert set(R.rule_names()) == {"metropolis_lut", "metropolis_exp",
                                   "metropolis_int", "heat_bath"}
    assert R.rule_names() == JR.rule_names()
    with pytest.raises(ValueError, match="unknown update rule"):
        R.get_rule("wolff")
    with pytest.raises(ValueError):
        R.metropolis_acceptance(torch.zeros(2), torch.ones(2), 0.4, "nope")


@pytest.mark.parametrize("beta", BETAS)
def test_kernel_tables_match_reference(beta):
    """Kernel tables: f64 math.exp rounded once to f32, as the reference's
    kernel_form bakes them."""
    t = R.kernel_table("metropolis_lut", beta)
    assert t.dtype == np.float32
    np.testing.assert_array_equal(
        t, np.float32([math.exp(-2.0 * beta * v) for v in
                       (-4.0, -2.0, 0.0, 2.0, 4.0)]))
    np.testing.assert_array_equal(R.kernel_table("heat_bath", beta),
                                  np.float32(JR.heat_bath_table_f32(beta)))


BETA_GRID = np.linspace(0.0, 3.0, 301)


@functools.lru_cache(maxsize=None)
def _jax_literal_tables(dtype_name: str) -> np.ndarray:
    """JR.acceptance_table at every grid beta as the reference's compiled
    chain holds it: the beta is a literal inside a jit."""
    jdt = jnp.dtype(dtype_name)
    return np.asarray(jax.jit(lambda: jnp.stack(
        [JR.acceptance_table(float(b), jdt).astype(jnp.float32)
         for b in BETA_GRID]))())


def test_acceptance_table_bf16_matches_everywhere_f32_gap_recorded():
    """The acceptance and heat-bath tables equal the reference's at every
    beta of the grid, f32 and bf16, with no beta skipped: a Python-number
    beta gives the table the reference's compiled chain folds, a tensor
    beta the one its traced ensembles compute."""
    x = np.float32(R._X_VALUES)
    n_literal_differs = 0
    for jdt, tdt in DTYPES:
        literal = _jax_literal_tables(jnp.dtype(jdt).name)
        for i, beta in enumerate(BETA_GRID):
            got = R.acceptance_table(float(beta), tdt).float().numpy()
            np.testing.assert_array_equal(got, literal[i])
            traced = R.acceptance_table(torch.tensor(beta, dtype=torch.float32),
                                        tdt).float().numpy()
            np.testing.assert_array_equal(
                traced, _np32(JR.acceptance_table(jnp.float32(beta), jdt)))
            n_literal_differs += int((got != traced).any())
            b = torch.tensor(beta, dtype=torch.float32)
            np.testing.assert_array_equal(
                XF.sigmoid_f32(2.0 * b * torch.from_numpy(x)).numpy(),
                _np32(jax.nn.sigmoid(2.0 * jnp.float32(beta) * x)))
    # the folded and the compiled exp part at some betas: both are held
    assert n_literal_differs > 0


def test_exp_sigmoid_log_match_xla_bitwise():
    """XLA:CPU's f32 exp / sigmoid on 10^6 points of [-88, 88] and beyond,
    and its log on 10^6 uniforms and positive floats, bit for bit."""
    x = np.linspace(-88.0, 88.0, 1_000_001, dtype=np.float32)
    x = np.concatenate([x, np.linspace(-120, 100, 20_001, dtype=np.float32),
                        np.float32([0.0, -0.0, 1e-40, 88.72, 88.73])])
    np.testing.assert_array_equal(XF.exp_f32_np(x), _np32(jnp.exp(x)))
    np.testing.assert_array_equal(XF.sigmoid_f32_np(x),
                                  _np32(jax.nn.sigmoid(x)))
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (1_000_000,)))
    u = np.maximum(u, np.float32(1e-30))
    np.testing.assert_array_equal(XF.log_f32_np(u), _np32(jnp.log(u)))
    rng = np.random.default_rng(12)
    pos = rng.integers(1, 0x7F800000, 200_000, dtype=np.int64)
    pos = np.concatenate([pos.astype(np.int32).view(np.float32),
                          np.float32([0.0, 1e-40, np.inf, 1.0, -1.0])])
    got, want = XF.log_f32_np(pos), _np32(jnp.log(pos))
    assert ((got == want) | (np.isnan(got) & np.isnan(want))).all()
    # the tensor forms are the numpy twins
    t = torch.from_numpy(x[::97].copy())
    np.testing.assert_array_equal(XF.exp_f32(t).numpy(),
                                  XF.exp_f32_np(x[::97]))
    # torch's own exp is not XLA's: the reason for this module
    assert (torch.exp(torch.from_numpy(x)).numpy() != _np32(jnp.exp(x))).any()


def test_literal_table_decides_where_the_traced_one_differs():
    """Uniforms placed on the two tables' values: the port's Python-number
    beta flips as the reference's compiled chain does, a tensor beta as its
    traced ensembles do, and the two decisions differ."""
    beta = next(float(b) for b in BETA_GRID
                if (R.acceptance_table(float(b)).numpy()
                    != R.acceptance_table(torch.tensor(b)).numpy()).any())
    lit = R.acceptance_table(beta).numpy()
    trc = R.acceptance_table(torch.tensor(beta)).numpy()
    k = int(np.nonzero(lit != trc)[0][0])
    x = np.float32(R._X_VALUES[k])
    sigma = np.float32([1.0, 1.0])
    nn = np.float32([x, x])
    probs = np.float32([min(lit[k], trc[k]), min(lit[k], trc[k])])
    flip = R.get_rule("lut").flip_probs
    jflip = JR.get_rule("lut").flip_probs
    args = (torch.from_numpy(sigma), torch.from_numpy(nn),
            torch.from_numpy(probs))
    jargs = tuple(jnp.asarray(a) for a in (sigma, nn, probs))
    want_lit = jax.jit(lambda s, n, p: jflip(s, n, p, beta))(*jargs)
    want_trc = jax.jit(lambda s, n, p, b: jflip(s, n, p, b))(
        *jargs, jnp.float32(beta))
    got_lit = flip(*args, beta)
    got_trc = flip(*args, torch.tensor(beta))
    np.testing.assert_array_equal(got_lit.numpy(), _np32(want_lit))
    np.testing.assert_array_equal(got_trc.numpy(), _np32(want_trc))
    assert not np.array_equal(got_lit.numpy(), got_trc.numpy())


@pytest.mark.parametrize("n", [5, 21, 384, 1000, 4097, 65536])
def test_per_spin_is_xla_division_by_a_constant(n):
    """XLA rewrites x / N for a constant N into x * f32(1/N); the port's
    per-spin division does the same (equal at powers of two)."""
    rng = np.random.default_rng(n)
    x = rng.choice([-1.0, 1.0], (64, n)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jnp.mean))(x))
    got = [float(M.per_spin(torch.sum(torch.from_numpy(r)), n)) for r in x]
    np.testing.assert_array_equal(np.float32(got), want)


@pytest.mark.parametrize("rule", ["metropolis_lut", "metropolis_exp",
                                  "heat_bath"])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_flip_probs_matches_jax(rule, jdt, tdt):
    """Every beta, with and without a field, f32 and bf16: a Python-number
    beta against the reference jitted with the beta as a literal (its
    chain), a tensor beta against the reference with a traced beta (its
    ensembles)."""
    sigma, nn, probs, _ = _site_inputs(1)
    jflip = JR.get_rule(rule).flip_probs
    jargs = (jnp.asarray(sigma, jdt), jnp.asarray(nn, jdt),
             jnp.asarray(probs))
    args = (torch.from_numpy(sigma).to(tdt), torch.from_numpy(nn).to(tdt),
            torch.from_numpy(probs))
    for beta in BETAS:
        for field in ((0.0, 0.25) if rule != "metropolis_exp" else (0.0,)):
            want = jax.jit(lambda s, n, p: jflip(s, n, p, beta, field))(
                *jargs)
            got = R.get_rule(rule).flip_probs(*args, beta, field)
            np.testing.assert_array_equal(got.float().numpy(), _np32(want))
            want_t = jax.jit(lambda s, n, p, b: jflip(s, n, p, b, field))(
                *jargs, jnp.float32(beta))
            got_t = R.get_rule(rule).flip_probs(
                *args, torch.tensor(beta, dtype=torch.float32), field)
            np.testing.assert_array_equal(got_t.float().numpy(),
                                          _np32(want_t))


@pytest.mark.parametrize("rule", ["metropolis_lut", "metropolis_exp",
                                  "heat_bath"])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("beta", BETAS)
def test_flip_bits_and_kernel_form_match_jax(rule, jdt, tdt, beta):
    sigma, nn, _, bits = _site_inputs(2)
    want = JR.get_rule(rule).flip_bits(jnp.asarray(sigma, jdt),
                                       jnp.asarray(nn, jdt),
                                       jnp.asarray(bits), beta)
    t_bits = bridge.bits_to_torch(bits)
    got = R.get_rule(rule).flip_bits(torch.from_numpy(sigma).to(tdt),
                                     torch.from_numpy(nn).to(tdt), t_bits,
                                     beta)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), _np32(want))
    got_k = R.get_rule(rule).kernel_form(beta)(
        torch.from_numpy(sigma).to(tdt), torch.from_numpy(nn), t_bits)
    np.testing.assert_array_equal(got_k.float().numpy(), _np32(want))


def test_bits_to_uniform_matches_jax():
    bits = np.asarray(jax.random.bits(jax.random.PRNGKey(0), (4096,),
                                      jnp.uint32))
    u = R.bits_to_uniform(bridge.bits_to_torch(bits))
    np.testing.assert_array_equal(u.numpy(),
                                  _np32(JR.bits_to_uniform(jnp.asarray(bits))))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


# ---------------------------------------------------------------------------
# checkerboard
# ---------------------------------------------------------------------------


def _lattice(seed, h, w, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.choice([-1.0, 1.0], size=(h, w))
                            .astype(np.float32)).to(dtype)


@pytest.mark.parametrize("accept", ["lut", "exp", "heat_bath"])
@pytest.mark.parametrize("hw,bs", [((16, 16), 4), ((16, 32), 8),
                                   ((32, 16), 8), ((8, 8), 4)])
def test_compact_equals_port_oracle(accept, hw, bs):
    full = _lattice(3, *hw, torch.bfloat16)
    rng = np.random.default_rng(4)
    pb = torch.from_numpy(rng.random(hw, dtype=np.float32))
    pw = torch.from_numpy(rng.random(hw, dtype=np.float32))
    want = CB.sweep_full(full, pb, pw, 0.4406868, accept)
    probs = CB.quad_probs_from_full(pb, pw)
    got = CB.sweep_compact(L.to_quads(full), probs, 0.4406868, bs, accept)
    torch.testing.assert_close(L.from_quads(got), want, rtol=0, atol=0)


@pytest.mark.parametrize("accept", ["lut", "exp"])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("hw,bs", [((16, 16), 4), ((32, 64), 8)])
def test_update_naive_matches_jax(accept, jdt, tdt, hw, bs):
    """Paper Algorithm 1, both colours, bitwise against the reference
    jitted with beta as a literal (``accept="exp"`` through the port's
    XLA f32 exp), and against the port's full-lattice oracle; the blocked
    neighbour sums equal the reference's too."""
    full = _lattice(7, *hw, tdt)
    jfull = jnp.asarray(bridge.to_numpy(full, jnp.bfloat16)).astype(jdt)
    rng = np.random.default_rng(8)
    sig = L.block(full, bs)
    k = L.kernel_naive(bs, tdt)
    np.testing.assert_array_equal(
        CB.nn_naive(sig, k).float().numpy(),
        _np32(JCB.nn_naive(jnp.asarray(bridge.to_numpy(sig, jnp.bfloat16))
                           .astype(jdt),
                           jnp.asarray(bridge.to_numpy(k, jnp.bfloat16))
                           .astype(jdt))))
    for beta in (0.3, 0.4406868, 1.0):
        for color in (0, 1):
            probs = rng.random(hw, dtype=np.float32)
            want = jax.jit(lambda f, p: JCB.update_naive(
                f, p, beta, color, bs, accept))(jfull, jnp.asarray(probs))
            got = CB.update_naive(full, torch.from_numpy(probs), beta, color,
                                  bs, accept)
            assert got.dtype == tdt
            np.testing.assert_array_equal(got.float().numpy(), _np32(want))
            oracle = CB.update_color_full(full, torch.from_numpy(probs),
                                          beta, color, accept)
            torch.testing.assert_close(got, oracle, rtol=0, atol=0)


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("hw,bs", [((16, 16), 4), ((16, 32), 8),
                                   ((32, 64), 16)])
def test_nn_and_edges_match_jax(color, hw, bs):
    full = _lattice(5, *hw, torch.bfloat16)
    quads = L.to_quads(full)
    tq = [L.block(quads[i], bs) for i in range(4)]
    jq = [jnp.asarray(bridge.to_numpy(q, jnp.bfloat16)) for q in tq]
    kh = L.kernel_compact(bs)
    jkh = jnp.asarray(bridge.to_numpy(kh, jnp.bfloat16))
    for t_line, j_line in zip(CB.edge_lines(*tq, color),
                              JCB.edge_lines(*jq, color)):
        np.testing.assert_array_equal(t_line.float().numpy(), _np32(j_line))
    fn, jfn = ((CB.nn_black, JCB.nn_black) if color == 0
               else (CB.nn_white, JCB.nn_white))
    for t_nn, j_nn in zip(fn(*tq, kh), jfn(*jq, jkh)):
        np.testing.assert_array_equal(t_nn.float().numpy(), _np32(j_nn))
    np.testing.assert_array_equal(
        CB.nn_full(full).float().numpy(),
        _np32(JCB.nn_full(jnp.asarray(bridge.to_numpy(full, jnp.bfloat16)))))
    with pytest.raises(ValueError):
        CB.default_edges(tq[0], "up")


@pytest.mark.parametrize("accept", ["lut", "heat_bath"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_compact_matches_jax(accept, seed):
    h, w, bs = 16, 32, 8
    full = _lattice(seed, h, w, torch.bfloat16)
    quads = L.to_quads(full)
    probs = torch.from_numpy(np.random.default_rng(seed + 10).random(
        (4, h // 2, w // 2), dtype=np.float32))
    want = JCB.sweep_compact(jnp.asarray(bridge.to_numpy(quads,
                                                         jnp.bfloat16)),
                             jnp.asarray(probs.numpy()), 0.4406868, bs,
                             accept)
    got = CB.sweep_compact(quads, probs, 0.4406868, bs, accept)
    np.testing.assert_array_equal(got.float().numpy(), _np32(want))
    got_s, stats = CB.update_color_compact(quads, probs[0], probs[1],
                                           0.4406868, 0, bs, accept,
                                           return_stats=True)
    assert len(stats) == 4 and stats[2].shape == (h // 2 // bs, w // 2 // bs,
                                                  bs, bs)


# ---------------------------------------------------------------------------
# measure
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw,bs", [((16, 16), 4), ((32, 16), 8)])
def test_sweep_compact_measured_matches_jax_and_observables(hw, bs):
    full = _lattice(7, *hw, torch.bfloat16)
    quads = L.to_quads(full)
    probs = torch.from_numpy(np.random.default_rng(8).random(
        (4, hw[0] // 2, hw[1] // 2), dtype=np.float32))
    jq = jnp.asarray(bridge.to_numpy(quads, jnp.bfloat16))
    jout, (jmv, jev) = JM.sweep_compact_measured(
        jq, jnp.asarray(probs.numpy()), 0.4406868, bs, "lut")
    out, (m, e) = M.sweep_compact_measured(quads, probs, 0.4406868, bs,
                                           "lut")
    np.testing.assert_array_equal(out.float().numpy(), _np32(jout))
    assert float(m) == float(jmv) and float(e) == float(jev)
    # the streamed (m, E) are the oracle observables of the new state
    assert float(m) == float(O.magnetization(out))
    assert float(e) == float(O.energy_per_spin(out))
    assert float(O.energy_per_spin(out)) == float(JO.energy_per_spin(jout))
    qb = torch.stack([L.block(out[i], bs) for i in range(4)])
    mb, eb = M.blocked_stats(qb)
    jmb, jeb = JM.blocked_stats(jnp.asarray(bridge.to_numpy(qb,
                                                            jnp.bfloat16)))
    assert (float(mb), float(eb)) == (float(m), float(e))
    assert (float(jmb), float(jeb)) == (float(mb), float(eb))


@pytest.mark.parametrize("every,burnin", [(1, 0), (3, 5)])
def test_accumulate_matches_reference_order(every, burnin):
    """Moments in the reference's f32 operation order as XLA compiles it
    (the products fused into the Kahan subtractions), m**4 as the square
    of the square. The op-by-op order differs from it on these samples."""
    rng = np.random.default_rng(9)
    ms = rng.uniform(-1, 1, 120).astype(np.float32)
    es = rng.uniform(-2, -1, 120).astype(np.float32)
    jacc = jax.jit(JM.accumulate, static_argnums=(4, 5))
    jmom, opmom, tmom = JM.init_moments(), JM.init_moments(), \
        M.init_moments()
    for i in range(120):
        jmom = jacc(jmom, ms[i], es[i], jnp.int32(i), every, burnin)
        opmom = JM.accumulate(opmom, ms[i], es[i], jnp.int32(i), every,
                              burnin)
        tmom = M.accumulate(tmom, torch.tensor(ms[i]), torch.tensor(es[i]),
                            i, every, burnin)
    for name, a, b in zip(M.Moments._fields, jmom, tmom):
        assert np.asarray(a) == b.numpy(), name
    assert M.finalize(tmom) == JM.finalize(jmom)
    assert any(np.asarray(a) != np.asarray(b) for a, b in zip(jmom, opmom))


@pytest.mark.parametrize("every,burnin", [(1, 0), (2, 3)])
def test_moments_from_series_matches_jax(every, burnin):
    rng = np.random.default_rng(10)
    ms = rng.uniform(-1, 1, (40,)).astype(np.float32)
    es = rng.uniform(-2, -1, (40,)).astype(np.float32)
    want = JM.finalize(JM.moments_from_series(ms, es, burnin, every))
    got = M.finalize(M.moments_from_series(torch.from_numpy(ms),
                                           torch.from_numpy(es), burnin,
                                           every))
    assert got == want
    batched = M.finalize(M.moments_from_series(np.stack([ms, es]),
                                               np.stack([es, ms])))
    assert batched["m_abs"].shape == (2,)


# ---------------------------------------------------------------------------
# observables
# ---------------------------------------------------------------------------


def test_host_statistics_equal_reference():
    rng = np.random.default_rng(11)
    ms = rng.normal(0.3, 0.05, 400)
    es = rng.normal(-1.4, 0.02, 400)
    assert O.chain_statistics(ms, es, 50, 0.44, 1024) == \
        JO.chain_statistics(ms, es, 50, 0.44, 1024)
    assert O.autocorrelation(ms) == JO.autocorrelation(ms)
    assert O.autocorrelation_time(ms[:3]) == 1.0
    mom = {"E": -1.4, "E2": 1.97, "E_var": 0.01, "m2": 0.1, "m_abs": 0.3}
    assert O.specific_heat_from_moments(mom, 0.4, 64) == \
        JO.specific_heat_from_moments(mom, 0.4, 64)
    assert O.susceptibility_from_moments(mom, 0.4, 64) == \
        JO.susceptibility_from_moments(mom, 0.4, 64)
    assert O.critical_temperature() == JO.critical_temperature()
    assert float(O.binder_parameter(0.5, 0.3)) == \
        float(JO.binder_parameter(0.5, 0.3))
