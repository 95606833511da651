"""The decomposed lattice of the port against the JAX package: the opt
pipeline's integer thresholds, the halo plane over gloo ranks, multi-rank
sweeps against one device, the accumulate order of the compiled loops, and
the one-rank ``opt`` / ``mesh`` / ``mesh3d`` engine scenarios, all bitwise.

Multi-rank parts run in gloo ranks (``repro_torch.launch.mesh.run_ranks``,
spawned processes, CPU tensors); rank 0 gathers what the test compares. The
grid engine scenarios on 1x2, 2x1 and 2x2 grids against the JAX engine on
as many virtual devices are in ``test_torch_mesh_engine.py``.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import EngineConfig as JConfig  # noqa: E402
from repro.api import IsingEngine as JEngine  # noqa: E402
from repro.core import checkerboard as JCB  # noqa: E402
from repro.core import measure as JM  # noqa: E402
from repro.core import update_rules as JR  # noqa: E402
from repro.distributed import ising as jdising  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.api import EngineConfig, EngineConfigError  # noqa: E402
from repro_torch.api import IsingEngine  # noqa: E402
from repro_torch.core import checkerboard as cb  # noqa: E402
from repro_torch.core import lattice as L  # noqa: E402
from repro_torch.core import measure as M  # noqa: E402
from repro_torch.core import update_rules as R  # noqa: E402
from repro_torch.distributed import decomp  # noqa: E402
from repro_torch.distributed import halo  # noqa: E402
from repro_torch.distributed import ising as dising  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402

BETA = 0.4406868
X_VALUES = (-4.0, -2.0, 0.0, 2.0, 4.0)


def _spins(rng, shape):
    return rng.choice([-1.0, 1.0], size=shape).astype(np.float32)


def _bits(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _blocked(full, bs):
    """[H, W] numpy spins -> blocked quads [4, H/2bs, W/2bs, bs, bs]."""
    quads = L.to_quads(torch.from_numpy(full))
    return torch.stack([L.block(quads[i], bs) for i in range(4)]).contiguous()


# ---------------------------------------------------------------------------
# The opt pipeline's integer thresholds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("beta", [0.1, 0.4406868, 1.0, 2.5])
def test_thresholds_match_f32_lut_exactly(beta):
    """u24 thresholds equal the reference's, and the integer compare agrees
    with the f32 compare for every uniform near each threshold."""
    ts = R.metropolis_thresholds_u24(beta)
    assert ts == JCB.acceptance_thresholds_u24(beta)
    assert R.heat_bath_thresholds_u24(beta) == JR.heat_bath_thresholds_u24(
        beta)
    for k, x in enumerate(X_VALUES):
        a32 = np.float32(math.exp(-2.0 * beta * x))
        t = ts[k]
        probes = sorted({max(0, t - 2), max(0, t - 1), min(t, (1 << 24) - 1),
                         min(t + 1, (1 << 24) - 1)})
        bits = torch.tensor([(u << 8) - (1 << 32) if u >= 1 << 23
                             else u << 8 for u in probes], dtype=torch.int32)
        got = R._int_compare(bits, ts, torch.full((len(probes),), x))
        for u_int, g in zip(probes, got.tolist()):
            u = np.float32(u_int) * np.float32(1.0 / (1 << 24))
            assert g == bool(u < a32) == (u_int < t), (beta, x, u_int, t)


@pytest.mark.parametrize("rule", ["metropolis_lut", "heat_bath"])
@pytest.mark.parametrize("beta", [0.3, 0.4406868, 1.2])
def test_flip_bits_int_matches_reference(beta, rule):
    """flip_bits_int on uint32 bits == the reference's, and == the kernel
    form's float flip on the same bits."""
    rng = np.random.default_rng(int(beta * 10))
    sigma = torch.from_numpy(_spins(rng, (64, 64))).to(torch.bfloat16)
    nn = cb.nn_full(sigma)
    bits = _bits(rng, (64, 64))
    got = R.get_rule(rule).flip_bits_int(sigma, nn, bridge.bits_to_torch(bits),
                                         beta)
    jsigma = jnp.asarray(bridge.to_numpy(sigma, jnp.bfloat16))
    want = JR.get_rule(rule).flip_bits_int(
        jsigma, jnp.asarray(bridge.to_numpy(nn, jnp.bfloat16)),
        jnp.asarray(bits), beta)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    kernel = R.get_rule(rule).kernel_form(beta)(
        sigma, nn.float(), bridge.bits_to_torch(bits))
    assert torch.equal(got, kernel)
    if rule == "metropolis_lut":
        assert torch.equal(got, R.get_rule("int").flip_bits_int(
            sigma, nn, bridge.bits_to_torch(bits), beta))


@pytest.mark.parametrize("rule", ["metropolis_lut", "heat_bath"])
def test_uint16_bits_and_flip_match_reference(rule):
    """bits_dtype='uint16': ``jax.random.bits``'s 16-bit draw (the low half
    of the 32-bit one) bitwise, the rescaled thresholds' flips bitwise, and
    the acceptance within 2^-16 of the float one over all 2^16 draws."""
    key = jr.PRNGKey(7)
    cfg = dising.DistIsingConfig(beta=BETA, pipeline="opt",
                                 bits_dtype="uint16")
    got = dising._draw_bits(key, (2, 3, 5, 8), cfg, "cpu")
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(7), (2, 3, 5, 8),
                                      jnp.uint16))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)

    n = 1 << 16
    bits = torch.arange(n, dtype=torch.int32).to(torch.int16)  # exhaustive
    jbits = jnp.arange(n, dtype=jnp.uint16)
    sigma = torch.ones(n, dtype=torch.bfloat16)
    for nn_val in X_VALUES:
        nn = torch.full((n,), nn_val, dtype=torch.bfloat16)
        out = R.get_rule(rule).flip_bits_int(sigma, nn, bits, BETA)
        jout = JR.get_rule(rule).flip_bits_int(
            jnp.ones(n, jnp.bfloat16), jnp.full(n, nn_val, jnp.bfloat16),
            jbits, BETA)
        np.testing.assert_array_equal(out.float().numpy(),
                                      np.asarray(jout, np.float32))
        if rule == "metropolis_lut":
            frac = float((out == -1).float().mean())
            want_p = min(1.0, math.exp(-2.0 * BETA * nn_val))
            assert abs(frac - want_p) <= 2.0 / n + 1e-9, (nn_val, frac)


def test_rbg_and_bad_bits_are_refused():
    """``rng="rbg"`` is accepted (its physics is held over gloo ranks in
    ``test_rbg_opt_pipeline_physics``); an unknown generator, a bits dtype
    other than uint32/uint16 and int64 bits are refused."""
    cfg = dising.DistIsingConfig(beta=BETA, pipeline="opt", rng="rbg")
    assert cfg.rng == "rbg"
    with pytest.raises(ValueError, match="rng"):
        dising.DistIsingConfig(beta=BETA, pipeline="opt", rng="philox")
    with pytest.raises(ValueError, match="bits_dtype"):
        dising.DistIsingConfig(beta=BETA, bits_dtype="uint8")
    with pytest.raises(TypeError, match="int32"):
        R.metropolis_int.flip_bits_int(torch.ones(4), torch.zeros(4),
                                       torch.zeros(4, dtype=torch.int64),
                                       BETA)


# ---------------------------------------------------------------------------
# The halo plane and multi-rank sweeps, in gloo ranks
# ---------------------------------------------------------------------------

# (grid shape, grid axes, lattice axes, array shape)
_HALO_CASES = {
    4: [((4,), ("data",), ("data", None), (8, 8)),
        ((2, 2), ("data", "model"), ("data", "model"), (8, 8))],
    8: [((2, 2, 2), ("pod", "data", "model"), ("pod", "data", "model"),
         (4, 8, 8)),
        ((2, 4), ("data", "model"), (None, ("data", "model"), None),
         (4, 8, 8))],
}
# (grid shape, grid axes, row axes, mr, mc, bs) of the sweep-with-bits cases
_SWEEP_CASES = {
    4: ((2, 2), ("data", "model"), ("data",), 4, 4, 8),
    8: ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"), 8, 4, 8),
}


def _sweep_inputs(mr, mc, bs, seed=3):
    rng = np.random.default_rng(seed)
    full = _spins(rng, (2 * mr * bs, 2 * mc * bs))
    return full, _bits(rng, (2, 2, mr, mc, bs, bs))


def _ranks_body(world):
    """On each of ``world`` gloo ranks: the halo primitives and a sweep of
    explicit bits on the grids of ``world`` shards; rank 0's gathered
    results come back."""
    out = {}
    for shape, axes, lat_axes, arr_shape in _HALO_CASES[world]:
        grid = mesh_lib.make_grid(shape, axes, "cpu")
        spec = halo.HaloSpec.from_mesh(grid, lat_axes)
        place = spec.partition_spec()
        x = torch.arange(math.prod(arr_shape),
                         dtype=torch.float32).view(arr_shape)
        local = grid.local_block(x, place)
        for dim in range(spec.ndim):
            for delta in (+1, -1):
                out[(shape, "neighbor", dim, delta)] = grid.gather(
                    spec.neighbor(local, dim, delta), place)
        out[(shape, "global_index")] = grid.gather(
            spec.global_index(local.shape), place)

    shape, axes, row_axes, mr, mc, bs = _SWEEP_CASES[world]
    grid = mesh_lib.make_grid(shape, axes, "cpu")
    cfg = dising.DistIsingConfig(beta=0.44, block_size=bs, row_axes=row_axes,
                                 col_axes=("model",))
    place = dising.lattice_spec(cfg)
    full, bits = _sweep_inputs(mr, mc, bs)
    qb = grid.local_block(_blocked(full, bs).to(torch.bfloat16), place)
    lbits = grid.local_block(bridge.bits_to_torch(bits), (None,) + place)
    out["sweep_with_bits"] = grid.gather(
        dising.make_sweep_with_bits_fn(grid, cfg)(qb, lbits), place)

    if world == 4:
        spec = halo.spec2d(("data",), ("model",), 2, 2, grid)
        xb = L.block(torch.arange(32 * 32, dtype=torch.float32)
                     .view(32, 32), 8).contiguous()
        qplace = spec.partition_spec(trailing=2)
        local = grid.local_block(xb, qplace)
        edges = halo.blocked_quad_edges(spec)
        for side in ("north", "south", "west", "east"):
            out[("edges", side)] = grid.gather(
                edges(local, side), spec.partition_spec(trailing=1))
        ocfg = dising.DistIsingConfig(beta=0.6, block_size=bs,
                                      pipeline="opt")
        key, step = jr.PRNGKey(5), 3
        stacked = dising.make_sweep_fn(grid, ocfg)(qb, key, step)
        tup = dising.make_sweep_tuple_fn(grid, ocfg)(*qb.unbind(0), key,
                                                     step)
        out["tuple_vs_stacked"] = torch.equal(stacked, torch.stack(tup))
        out["sends"] = mesh_lib.counters["send"]
        out["rbg"] = _rbg_physics(grid)
    return out


def _rbg_physics(grid):
    """|m| after 40 opt-pipeline sweeps with ``rng="rbg"`` and uint16 bits
    on the 2x2 grid at 128^2 (bs 16): a cold start at beta 1.0 and a hot
    start at beta 0.2, as ``tests/test_ising_opt.py`` runs the reference.
    Also whether one key drew the same bits twice and another key others."""
    out = {}
    for name, beta, seed, full in (
            ("cold", 1.0, 0, L.cold_lattice(128, 128)),
            ("hot", 0.2, 1, L.random_lattice(jr.PRNGKey(1), 128, 128))):
        cfg = dising.DistIsingConfig(beta=beta, block_size=16,
                                     pipeline="opt", rng="rbg",
                                     bits_dtype="uint16")
        place = dising.lattice_spec(cfg)
        qb = grid.local_block(_blocked_quads(full, 16), place)
        run = dising.make_run_sweeps_fn(grid, cfg, n_sweeps=40)
        got = grid.gather(run(qb, jr.PRNGKey(seed)), place)
        out[name] = abs(float(got.float().mean()))
    k = jr.fold_in(jr.PRNGKey(2), grid.rank)
    a = dising.rbg_bits(k, (3, 64), "cpu")
    out["same_key_same_bits"] = torch.equal(a, dising.rbg_bits(k, (3, 64),
                                                               "cpu"))
    out["other_key_other_bits"] = not torch.equal(
        a, dising.rbg_bits(jr.fold_in(k, 1), (3, 64), "cpu"))
    return out


def _blocked_quads(full, bs):
    quads = L.to_quads(full)
    return torch.stack([L.block(quads[i], bs) for i in range(4)]).contiguous()


@functools.lru_cache(maxsize=None)
def _ranks(world):
    return mesh_lib.run_ranks(_ranks_body, world, world)


_HALO_IDS = [(w, i) for w in (4, 8) for i in range(2)]


@pytest.mark.parametrize("world,case", _HALO_IDS)
def test_neighbor_round_trips_over_ranks(world, case):
    """Gathered ``spec.neighbor`` == the global torus roll for every dim and
    both directions, and gathered ``global_index`` == arange, on 1-, 2- and
    3-axis grids (2-D and 3-D arrays)."""
    shape, _, _, arr_shape = _HALO_CASES[world][case]
    res = _ranks(world)
    x = np.arange(math.prod(arr_shape), dtype=np.float32).reshape(arr_shape)
    for dim in range(len(arr_shape)):
        for delta in (+1, -1):
            np.testing.assert_array_equal(
                res[(shape, "neighbor", dim, delta)].numpy(),
                np.roll(x, -delta, dim), err_msg=f"{shape} {dim} {delta}")
    np.testing.assert_array_equal(
        res[(shape, "global_index")].numpy().reshape(-1),
        np.arange(math.prod(arr_shape)))


def test_blocked_quad_edges_match_gathered_default():
    """Per rank, the blocked-quad provider gives the slice of the one-device
    ``default_edges`` of the gathered lattice (the reference's as well), for
    all four sides."""
    res = _ranks(4)
    xb = L.block(torch.arange(32 * 32, dtype=torch.float32).view(32, 32), 8)
    for side in ("north", "south", "west", "east"):
        want = cb.default_edges(xb, side)
        assert torch.equal(res[("edges", side)], want), side
        np.testing.assert_array_equal(
            want.numpy(), np.asarray(JCB.default_edges(
                jnp.asarray(xb.numpy()), side)))


def test_rbg_opt_pipeline_physics():
    """``rng="rbg"`` on a 2x2 gloo grid, 128^2, uint16 bits, 40 sweeps: a
    cold start at beta 1.0 stays ordered (|m| > 0.95) and a hot start at
    beta 0.2 stays disordered (|m| < 0.2), the reference's own bounds
    (``tests/test_ising_opt.py::test_opt_pipeline_physics``); its bits are
    the generator's, the same for the same key."""
    res = _ranks(4)["rbg"]
    assert res["cold"] > 0.95, res
    assert res["hot"] < 0.2, res
    assert res["same_key_same_bits"] and res["other_key_other_bits"], res


def test_neighbor_and_index_unsharded_is_local_roll():
    """On a one-rank grid every primitive is a plain torus op and ``send``
    is the identity (no process group needed)."""
    grid = mesh_lib.make_grid((1, 1), ("data", "model"), "cpu")
    spec = halo.HaloSpec.from_mesh(grid, ("data", "model"))
    x = torch.arange(48, dtype=torch.float32).view(6, 8)
    assert torch.equal(spec.neighbor(x, 0, +1), torch.roll(x, -1, 0))
    assert torch.equal(spec.neighbor(x, 1, -1), torch.roll(x, 1, 1))
    assert torch.equal(spec.global_index(x.shape).view(-1),
                       torch.arange(48, dtype=torch.int32))
    assert spec.send(x, 0, 1) is x
    assert grid.psum(x) is x and grid.gather(x, (None, None)) is x


def test_halo_spec_static_properties():
    grid = mesh_lib.DeviceGrid((2, 4, 2), ("pod", "data", "model"), 13,
                               torch.device("cpu"))
    spec = halo.HaloSpec.from_mesh(grid, (("pod", "data"), "model", None))
    assert spec.ndim == 3
    assert spec.shard_counts() == (8, 2, 1)
    assert spec.n_devices() == 16
    assert spec.mesh_axis_names() == ("pod", "data", "model")
    assert spec.partition_spec(leading=1, trailing=2) == \
        (None, ("pod", "data"), ("model",), None, None, None)
    # rank 13 of a (2, 4, 2) grid sits at (1, 2, 1): row 1 * 4 + 2 = 6
    assert grid.coords == (1, 2, 1)
    assert spec.axis_index(0) == 6 and spec.axis_index(1) == 1
    assert spec.offsets((3, 5, 7)) == (18, 5, 0)
    assert halo.spec2d(("pod", "data"), "model", 4, 2).shard_counts() == \
        (4, 2)


@pytest.mark.parametrize("world", [4, 8])
def test_multi_rank_sweep_bitwise_equals_single(world):
    """A multi-rank sweep of the lines-kernel form from explicit bits ==
    the reference's one-device Pallas lines kernel (interpret mode) from the
    same bits: the halo wraps the torus across rank boundaries, including
    row axes flattened over ("pod", "data")."""
    _, _, _, mr, mc, bs = _SWEEP_CASES[world]
    full, bits = _sweep_inputs(mr, mc, bs)
    qb = jnp.asarray(bridge.to_numpy(_blocked(full, bs).to(torch.bfloat16),
                                     jnp.bfloat16))
    want = jops.update_color(qb, jnp.asarray(bits[0]), 0.44, 0,
                             backend="pallas_lines")
    want = jops.update_color(want, jnp.asarray(bits[1]), 0.44, 1,
                             backend="pallas_lines")
    got = _ranks(world)["sweep_with_bits"]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert not np.array_equal(np.asarray(want, np.float32),
                              np.asarray(qb, np.float32))


def test_tuple_sweep_matches_stacked_sweep():
    """make_sweep_tuple_fn == make_sweep_fn (same key and step) on a 2x2
    grid, and the sweeps exchanged halo lines between ranks."""
    res = _ranks(4)
    assert res["tuple_vs_stacked"]
    assert res["sends"] > 0


# ---------------------------------------------------------------------------
# One-rank engine scenarios against the JAX engine
# ---------------------------------------------------------------------------

_MESH = dict(topology="mesh", mesh_shape=(1, 1))
# (backend, rule, dtype, measure_every or None for measurement-free):
# every pair of values of two factors occurs at least once
_MESH_CASES = [
    ("xla", "metropolis", "bfloat16", 1),
    ("xla", "heat_bath", "float32", 3),
    ("xla", "metropolis", "float32", None),
    ("xla", "heat_bath", "bfloat16", None),
    ("pallas_lines", "metropolis", "bfloat16", 3),
    ("pallas_lines", "heat_bath", "float32", 1),
    ("pallas_lines", "metropolis", "float32", None),
    ("pallas_lines", "heat_bath", "bfloat16", 3),
]
_ONE_RANK = (
    [dict(backend=b, rule=r, dtype=d, measure=me is not None,
          measure_every=me or 1, **_MESH) for b, r, d, me in _MESH_CASES]
    + [dict(pipeline="opt"),
       dict(pipeline="opt", backend="pallas_lines", rule="heat_bath",
            measure_every=3),
       dict(pipeline="opt", **_MESH),
       dict(dims=3, size=8, block_size=0, beta=0.2216546, measure_every=2,
            **_MESH),
       dict(dims=3, size=6, block_size=0, beta=0.2216546, measure=False,
            **_MESH)])


def _base(**kw):
    base = dict(size=24, beta=BETA, n_sweeps=5, block_size=4, hot=True)
    base.update(kw)
    return base


def _same_result(got, want):
    np.testing.assert_array_equal(got.state.float().numpy(),
                                  np.asarray(want.state, np.float32))
    assert got.magnetization is None and want.magnetization is None
    assert got.moments == want.moments


@pytest.mark.parametrize("kw", _ONE_RANK,
                         ids=[str(i) for i in range(len(_ONE_RANK))])
def test_one_rank_engine_matches_jax(kw):
    """``IsingEngine(cfg, device="cpu").simulate(seed)`` == the JAX engine's
    (final state and moments) on a one-rank grid, at a lattice side that is
    not a power of two (24, or 6 for the cube)."""
    cfg = _base(**kw)
    got = IsingEngine(EngineConfig(**cfg), device="cpu").simulate(4)
    want = JEngine(JConfig(**cfg)).simulate(4)
    _same_result(got, want)
    assert got.state.shape == want.state.shape


def test_accumulate_matches_compiled_loop_not_op_by_op():
    """A one-rank mesh run, measured, 50 sweeps, measure_every=3, at side
    24: Moments bitwise the JAX loop's, c_m2 and c_de2 included. The same
    per-sweep (m, E) folded op by op (the reference's accumulate run
    eagerly) or by the standalone compiled accumulate differ from it."""
    cfg = _base(n_sweeps=50, measure_every=3, **_MESH)
    jeng = JEngine(JConfig(**cfg))
    k_init, k_chain = jax.random.split(jax.random.PRNGKey(8))
    jrun = jdising.make_run_chain_fn(jeng.mesh, jeng._dist_cfg(), 50, 3)
    jstate, jmom = jrun(jeng.init(k_init), k_chain)

    eng = IsingEngine(EngineConfig(**cfg), device="cpu")
    ti, tc = jr.split(jr.PRNGKey(8))
    model = dising.mesh_model(eng.grid, eng._dist_cfg())
    run = decomp.make_run_chain_fn(eng.grid, model, 50, 3)
    state, mom = run(eng.init(ti), tc)
    np.testing.assert_array_equal(state.float().numpy(),
                                  np.asarray(jstate, np.float32))
    for name, a, b in zip(M.Moments._fields, jmom, mom):
        assert np.asarray(a) == b.numpy(), name

    qb, samples = model.unpack(eng.init(ti)), []
    for step in range(50):
        qb, tot = model.sweep_measured(qb, tc, step)
        samples.append(tot.means())
    op, fused = JM.init_moments(), M.init_moments()
    for step, (m, e) in enumerate(samples):
        op = JM.accumulate(op, m.numpy(), e.numpy(), jnp.int32(step), 3)
        fused = M.accumulate(fused, m, e, step, 3)
    assert any(np.asarray(a) != np.asarray(b) for a, b in zip(jmom, op))
    assert any(np.asarray(a) != b.numpy() for a, b in zip(jmom, fused))


def test_one_rank_stats_chunks_and_template_match_jax():
    """stats() is the reference's exact global (m, E); a chunk of
    run_sweeps equals the reference's; the template is the global
    [4, MR, MC, bs, bs] and state_sharding places one block."""
    cfg = _base(measure=False, **_MESH)
    jeng = JEngine(JConfig(**cfg))
    eng = IsingEngine(EngineConfig(**cfg), device="cpu")
    jstate = jeng.init(jax.random.PRNGKey(1))
    state = eng.init(jr.PRNGKey(1))
    jchunk = jeng.run_sweeps(jstate, jax.random.PRNGKey(2), 3)
    chunk = eng.run_sweeps(state, jr.PRNGKey(2), 3)
    np.testing.assert_array_equal(chunk.float().numpy(),
                                  np.asarray(jchunk, np.float32))
    assert eng.stats(chunk) == jeng.stats(jchunk)
    assert eng.magnetization(chunk) == jeng.magnetization(jchunk)
    assert tuple(eng.state_template().shape) == jeng.state_template().shape
    grid, place = eng.state_sharding()
    assert grid.size == 1 and place == (None, ("data",), ("model",), None,
                                        None)
    with pytest.raises(EngineConfigError, match="stats"):
        IsingEngine(EngineConfig(**_base()), device="cpu").stats(state)


def test_grid_errors():
    """A grid whose shard count is not the group's world size raises; so
    do the reference's tiling checks."""
    with pytest.raises(EngineConfigError, match="4 shards"):
        IsingEngine(EngineConfig(**_base(topology="mesh", mesh_shape=(2, 2))),
                    device="cpu")
    fake = mesh_lib.DeviceGrid((4, 1), ("data", "model"), 0,
                               torch.device("cpu"))
    with pytest.raises(EngineConfigError, match="cannot shard evenly"):
        IsingEngine(EngineConfig(**_base(betas=(0.3, 0.4), beta=None,
                                         topology="mesh",
                                         mesh_shape=(4, 1))), device="cpu",
                    grid=fake)
    with pytest.raises(EngineConfigError, match="does not divide"):
        IsingEngine(EngineConfig(size=6, beta=0.3, dims=3, topology="mesh",
                                 mesh_shape=(4, 1)), device="cpu", grid=fake)
    with pytest.raises(EngineConfigError, match="does not tile"):
        IsingEngine(EngineConfig(**_base(topology="mesh", mesh_shape=(4, 1),
                                         block_size=4, size=24, width=16)),
                    device="cpu", grid=fake)
    with pytest.raises(ValueError, match="no process group|process group"):
        mesh_lib.make_grid((2, 1), ("data", "model"), "cpu")


# ---------------------------------------------------------------------------
# The port stands alone
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_the_reference(subproc):
    """No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
    ``jax`` or anything of ``repro``: by their source, and by importing
    every module of the port in a fresh interpreter."""
    import ast
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    modules = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)
        if path.name != "chip_smoke.py":
            rel = path.relative_to(root / "src").with_suffix("")
            modules.append(".".join(p for p in rel.parts
                                    if p != "__init__"))
    out = subproc(f"""
    import importlib, sys
    for name in {modules!r}:
        importlib.import_module(name)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not bad, bad
    print("PORT_ALONE", len({modules!r}))
    """, devices=0)
    assert "PORT_ALONE" in out
