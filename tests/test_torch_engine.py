"""The 2-D chain and kernel scenarios as a whole: the port's
``IsingEngine(cfg, device="cpu")`` against the JAX ``IsingEngine(cfg)``
from the same seed — final state, per-sweep m and E bitwise, moments
equal — for every ported backend, both rules, measured and
measurement-free, hot and cold; plus the engine's errors. The other
scenarios have their own files (``test_torch_{ensemble,ising3d,cluster,
potts}.py``).

The JAX side runs ``backend="ref"`` for the port's ``pallas`` and
``pallas_lines``: the JAX tests hold ref bitwise equal to both Pallas
kernels, and one interpret-mode case here holds it directly.
"""
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
from repro.api.engine import EngineConfigError as JConfigError  # noqa: E402
from repro.core import sampler as jsampler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.api import (EngineConfig, EngineConfigError,  # noqa: E402
                             IsingEngine, beta_ladder)
from repro_torch.kernels import build  # noqa: E402

SIZE, BLOCK, SWEEPS = 32, 8, 4
BETA = 0.4406868


def _cfg(**kw):
    base = dict(size=SIZE, beta=BETA, n_sweeps=SWEEPS, block_size=BLOCK)
    base.update(kw)
    return base


@functools.lru_cache(maxsize=None)
def _jax_engine(backend, rule, measure, dtype="bfloat16", width=0):
    return JEngine(JConfig(**_cfg(backend=backend, rule=rule,
                                  measure=measure, hot=True, dtype=dtype,
                                  width=width)))


@functools.lru_cache(maxsize=None)
def _jax_run(backend, rule, measure, hot, seed, dtype="bfloat16", width=0):
    """JAX simulate(seed), hot or cold, through one cached engine (a cold
    start ignores its key, so the cold state is made directly)."""
    eng = _jax_engine(backend, rule, measure, dtype, width)
    k_init, k_chain = jax.random.split(jax.random.PRNGKey(seed))
    state = (eng.init(k_init) if hot else jsampler.init_state(
        k_init, SIZE, width or SIZE, jnp.dtype(dtype), hot=False))
    return eng.run(state, k_chain)


def _assert_same(got, want, measure):
    np.testing.assert_array_equal(got.state.float().numpy(),
                                  np.asarray(want.state, np.float32))
    if not measure:
        assert got.magnetization is None and want.magnetization is None
        assert got.moments is None
        return
    np.testing.assert_array_equal(got.magnetization.numpy(),
                                  np.asarray(want.magnetization))
    np.testing.assert_array_equal(got.energy.numpy(),
                                  np.asarray(want.energy))
    assert got.moments == want.moments


@pytest.mark.parametrize("measure", [True, False])
@pytest.mark.parametrize("rule", ["metropolis", "heat_bath"])
@pytest.mark.parametrize("backend", ["xla", "ref", "pallas", "pallas_lines"])
def test_simulate_matches_jax_bitwise(backend, rule, measure):
    build.reset_launches()
    jbackend = "xla" if backend == "xla" else "ref"
    for hot in (True, False):
        for seed in (0, 5):
            cfg = EngineConfig(**_cfg(backend=backend, rule=rule,
                                      measure=measure, hot=hot))
            got = IsingEngine(cfg, device="cpu").simulate(seed)
            assert got.state.device.type == "cpu"
            assert got.state.dtype == torch.bfloat16
            _assert_same(got, _jax_run(jbackend, rule, measure, hot, seed),
                         measure)
    # CPU tensors run the plain versions: no kernel was launched
    assert build.launches == dict.fromkeys(build.launches, 0)


def test_kernel_path_matches_pallas_interpret():
    """The port's pallas backend against the JAX Pallas kernels themselves
    (interpret mode), through both engines."""
    kw = _cfg(backend="pallas", n_sweeps=2, hot=True)
    want = JEngine(JConfig(**kw, interpret=True)).simulate(3)
    got = IsingEngine(EngineConfig(**kw, interpret=True),
                      device="cpu").simulate(3)
    _assert_same(got, want, True)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_float32_lattice_matches_jax(backend):
    """f32 kernel tables are f64 math.exp rounded once, and the chain's f32
    table is the one XLA folds for a literal beta, so both paths are
    bitwise at f32, at every beta tried."""
    for beta in (BETA, 0.3, 0.47):
        kw = _cfg(backend=backend, dtype="float32", hot=True, beta=beta)
        want = JEngine(JConfig(**{**kw, "backend": "ref"
                                  if backend == "pallas" else "xla"})
                       ).simulate(2)
        got = IsingEngine(EngineConfig(**kw), device="cpu").simulate(2)
        assert got.state.dtype == torch.float32
        _assert_same(got, want, True)


@pytest.mark.parametrize("kw", [
    dict(size=24, block_size=4, dtype="float32"),
    dict(size=12, width=20, block_size=2, rule="heat_bath"),
])
def test_non_power_of_two_sizes_match_jax(kw):
    """Per-spin means divide by the spin count as XLA does (a product with
    the f32 reciprocal), so odd-sized tori are bitwise too."""
    kw = {**_cfg(hot=True), **kw}
    want = JEngine(JConfig(**kw)).simulate(4)
    got = IsingEngine(EngineConfig(**kw), device="cpu").simulate(4)
    _assert_same(got, want, True)


def test_rectangular_thinned_and_bf16_uniforms_match_jax():
    kw = _cfg(width=16, measure_every=2, n_sweeps=6, prob_dtype="bfloat16",
              hot=True)
    want = JEngine(JConfig(**kw)).simulate(1)
    got = IsingEngine(EngineConfig(**kw), device="cpu").simulate(1)
    assert got.state.shape == (4, SIZE // 2, 8)
    _assert_same(got, want, True)
    assert got.moments["n_samples"] == 3


def test_run_sweeps_chunks_and_helpers():
    eng = IsingEngine(EngineConfig(**_cfg(backend="pallas", hot=True)),
                      device="cpu")
    key = jr.PRNGKey(4)
    state = eng.init(key)
    before = state.clone()
    full = eng.run(state, key)
    torch.testing.assert_close(state, before, rtol=0, atol=0)
    chunk = eng.run_sweeps(state, key, SWEEPS)
    torch.testing.assert_close(chunk, full.state, rtol=0, atol=0)
    assert eng.magnetization(full.state) == float(full.magnetization[-1])
    tmpl = eng.state_template()
    assert tmpl.device.type == "meta"
    assert tuple(tmpl.shape) == (4, SIZE // 2, SIZE // 2)
    assert tmpl.dtype == torch.bfloat16
    jeng = JEngine(JConfig(**_cfg(backend="pallas", hot=True)))
    assert tuple(jeng.state_template().shape) == tuple(tmpl.shape)
    assert beta_ladder(0.8, 1.2, 4) == j_beta_ladder(0.8, 1.2, 4)
    assert beta_ladder(0.9, 1.1, 1, dims=3) == j_beta_ladder(0.9, 1.1, 1,
                                                             dims=3)
    jkey = jnp.asarray(bridge.key_to_numpy(key))
    np.testing.assert_array_equal(
        bridge.to_numpy(state),
        np.asarray(JEngine(JConfig(**_cfg(hot=True))).init(jkey),
                   np.float32))


def test_auto_hot_follows_tc():
    for beta, hot in ((0.3, True), (0.6, False)):
        eng = IsingEngine(EngineConfig(**_cfg(beta=beta)), device="cpu")
        assert eng._auto_hot(beta) is hot
        jeng = JEngine(JConfig(**_cfg(beta=beta)))
        assert jeng._auto_hot(beta) is hot


# The reference's invalid-config table (tests/test_engine.py).
BAD = [
    (dict(size=32, beta=0.4, betas=(0.4, 0.5)), "exactly one"),
    (dict(size=32), "exactly one"),
    (dict(size=33, beta=0.4), "even"),
    (dict(size=32, beta=0.4, dims=4), "dims"),
    (dict(size=32, beta=0.4, dims=3, backend="pallas"), "3-D"),
    (dict(size=32, beta=0.4, dims=3, width=16), "cubic"),
    (dict(size=32, beta=0.4, topology="mesh"), "mesh_shape"),
    (dict(size=32, betas=(0.3, 0.4), pipeline="opt"), "opt"),
    (dict(size=32, beta=0.4, rule="wolff"), "rule"),
    (dict(size=32, beta=0.4, measure_every=0), "measure_every"),
    (dict(size=8, beta=0.3, dims=3, rule="heat_bath"), "2-D"),
    (dict(size=32, betas=(0.3, 0.4), ensemble="tempering",
          rule="heat_bath"), "Metropolis"),
    (dict(size=32, betas=(0.3, 0.4), ensemble="tempering", field=0.1),
     "h=0"),
    (dict(size=32, beta=0.4, backend="pallas", accept="exp"), "LUT"),
    (dict(size=32, betas=(0.3, 0.4), ensemble="tempering",
          backend="ref"), "tempering"),
    (dict(size=32, beta=0.4, backend="warp"), "backend"),
    (dict(size=32, beta=0.4, model="potts"), "q >= 2"),
    (dict(size=32, beta=0.4, block_size=6), "divisible"),
]


@pytest.mark.parametrize("bad,hint", BAD)
def test_invalid_configs_raise_the_reference_errors(bad, hint):
    with pytest.raises(EngineConfigError, match="invalid EngineConfig") as e:
        IsingEngine(EngineConfig(**bad), device="cpu")
    assert hint.lower() in str(e.value).lower()
    with pytest.raises(JConfigError) as je:
        JConfig(**bad).validate()
    assert str(je.value) == str(e.value)


@pytest.mark.parametrize("kw", [
    dict(algorithm="swendsen_wang", topology="mesh", mesh_shape=(1, 1)),
    dict(model="potts", q=3, topology="mesh", mesh_shape=(1, 1)),
    dict(model="potts", q=3, algorithm="wolff", topology="mesh",
         mesh_shape=(1, 1)),
    dict(algorithm="wolff", topology="mesh", mesh_shape=(2, 2)),
    dict(model="potts", q=3, topology="mesh", mesh_shape=(2, 2)),
    dict(model="potts", q=3, algorithm="swendsen_wang", topology="mesh",
         mesh_shape=(2, 2)),
    dict(betas=(0.3, 0.4), topology="mesh", mesh_shape=(2, 1)),
])
def test_unported_scenarios_raise(kw):
    """The cluster and Potts meshes and replica ensembles on a mesh, once
    refused as not yet ported, are ported: on a one-rank grid they build
    their grid; on a larger grid with no process group they raise only the
    grid's shard-count error."""
    base = _cfg(**kw)
    if "betas" in kw:
        base.pop("beta")
    cfg = EngineConfig(**base)
    if cfg.mesh_shape == (1, 1):
        eng = IsingEngine(cfg, device="cpu")
        assert eng.state_sharding()[0] is eng.grid
        assert eng.grid.shape == (1, 1) and not eng.grid.distributed
        return
    with pytest.raises(EngineConfigError, match="shards") as exc:
        IsingEngine(cfg, device="cpu")
    assert "ported" not in str(exc.value)


def test_default_device_is_cuda():
    cfg = EngineConfig(**_cfg())
    if torch.cuda.is_available():
        assert IsingEngine(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IsingEngine(cfg)
    assert IsingEngine(cfg, device="cpu").device.type == "cpu"


def test_chip_smoke_prints_no_result_without_a_card(tmp_path):
    """chip_smoke.py measures the card: without CUDA, or copied away from
    the repository, it exits non-zero and prints nothing on stdout."""
    import shutil
    import subprocess
    import sys
    from pathlib import Path
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    script = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(script, alone)
    for path in (script, alone):
        proc = subprocess.run([sys.executable, str(path)], cwd=tmp_path,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert proc.stdout == ""
