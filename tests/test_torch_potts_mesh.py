"""The decomposed Potts planes of the port against the JAX package: the
cluster plane (Swendsen-Wang / Wolff with the cross-rank label merge) and
the checkerboard plane (heat-bath / Metropolis on the sharded colour view)
on 1x2, 2x1 and 2x2 grids of gloo ranks, and the launcher with ``--model
potts`` through a checkpoint and a resume, all bitwise against the JAX
package on as many virtual devices.

One JAX subprocess (4 virtual devices; the 2-device grids take the first
two) computes every reference while the port's ranks run, one spawn per
grid shape. The restored overrides of ``potts.rules`` are held
in-process.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import REPO, SRC  # noqa: E402
from repro.cluster import bonds as JB  # noqa: E402
from repro.potts import rules as JPR  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.api import EngineConfig, IsingEngine  # noqa: E402
from repro_torch.cluster import bonds as B  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.potts import rules as PR  # noqa: E402
from repro_torch.potts import state as PS  # noqa: E402

SEED = 4
GRIDS = [(1, 2), (2, 1), (2, 2)]
# a 48 x 32 colour lattice (N = 1536, not a power of two), blocks of 4 for
# the cluster plane
_2D = dict(size=48, width=32, block_size=4, n_sweeps=5, model="potts",
           hot=True)
CONFIGS = [
    dict(_2D, q=3, beta=1.0, algorithm="swendsen_wang"),
    dict(_2D, q=3, beta=0.9, algorithm="wolff", measure_every=2),
    dict(_2D, q=3, beta=1.1, rule="heat_bath"),
    dict(_2D, q=3, beta=1.0, rule="metropolis", measure_every=2),
    dict(_2D, q=2, beta=0.8, rule="heat_bath"),
    dict(_2D, q=2, beta=0.9, algorithm="swendsen_wang", measure=False),
]


def _cfg(shape, kw):
    return dict(kw, topology="mesh", mesh_shape=shape)


_JAX_RUNS = """
import pickle
import numpy as np
import jax
from jax.sharding import Mesh
from repro.api import EngineConfig, IsingEngine

out = {}
for shape in GRIDS:
    n = shape[0] * shape[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))
    for i, kw in enumerate(CONFIGS):
        eng = IsingEngine(EngineConfig(**dict(kw, topology="mesh",
                                              mesh_shape=shape)), mesh=mesh)
        r = eng.simulate(SEED)
        chunk = eng.run_sweeps(eng.init(jax.random.PRNGKey(1)),
                               jax.random.PRNGKey(2), 3)
        out[(shape, i)] = (np.asarray(r.state), r.moments,
                           np.asarray(chunk), eng.stats(chunk))
with open(PATH, "wb") as f:
    pickle.dump(out, f)
"""


def _start_jax(path):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    code = (f"GRIDS = {GRIDS!r}\nCONFIGS = {CONFIGS!r}\nSEED = {SEED}\n"
            f"PATH = {str(path)!r}\n" + textwrap.dedent(_JAX_RUNS))
    return subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _port_body(shape):
    """On every rank of one grid: each config's run, a measurement-free
    chunk and its global stats; rank 0 returns them gathered."""
    out = {}
    for i, kw in enumerate(CONFIGS):
        eng = IsingEngine(EngineConfig(**_cfg(shape, kw)), device="cpu")
        res = eng.simulate(SEED)
        assert res.magnetization is None and res.energy is None
        grid, place = eng.state_sharding()
        assert grid.shape == shape and grid.distributed
        assert res.state.dtype == torch.int32
        chunk = eng.run_sweeps(eng.init(jr.PRNGKey(1)), jr.PRNGKey(2), 3)
        out[(shape, i)] = (grid.gather(res.state, place), res.moments,
                           grid.gather(chunk, place), eng.stats(chunk),
                           tuple(res.state.shape))
    out[("collectives", shape)] = dict(mesh_lib.counters)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("potts_mesh") / "jax.pkl"
    proc = _start_jax(path)
    port = {}
    for shape in GRIDS:
        port.update(mesh_lib.run_ranks(_port_body, shape[0] * shape[1],
                                       shape))
    stdout, stderr = proc.communicate(timeout=900)
    if proc.returncode:
        raise AssertionError(f"JAX runs failed:\n{stdout}\n{stderr}")
    with open(path, "rb") as f:
        return port, pickle.load(f)


_CASES = [(shape, i) for shape in GRIDS for i in range(len(CONFIGS))]


@pytest.mark.parametrize("shape,i", _CASES,
                         ids=[f"{s[0]}x{s[1]}-{i}" for s, i in _CASES])
def test_potts_mesh_engine_matches_jax(results, shape, i):
    """State, moments, a measurement-free chunk and its global stats; the
    checkerboard plane's rank state is its block of the colour view, the
    cluster plane's its blocked quads."""
    port, jax_out = results
    state, mom, chunk, stats, local = port[(shape, i)]
    jstate, jmom, jchunk, jstats = jax_out[(shape, i)]
    np.testing.assert_array_equal(state.numpy(), jstate)
    assert mom == jmom
    np.testing.assert_array_equal(chunk.numpy(), jchunk)
    assert stats == jstats
    kw = CONFIGS[i]
    if kw.get("algorithm", "metropolis") == "metropolis":
        assert local == (kw["size"] // shape[0], kw["width"] // shape[1])
    else:
        assert len(local) == 5


@pytest.mark.parametrize("shape", GRIDS,
                         ids=[f"{s[0]}x{s[1]}" for s in GRIDS])
def test_potts_mesh_runs_exchange_and_merge(results, shape):
    """The ranks exchanged halo lines, all-reduced, and merged labels."""
    counts = results[0][("collectives", shape)]
    assert counts["send"] > 0 and counts["all_reduce"] > 0
    assert counts["label_merge"] > 0


# ---------------------------------------------------------------------------
# checkerboard_sweep's restored overrides
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", ["heat_bath", "metropolis"])
def test_checkerboard_sweep_defaults_are_the_full_view(rule):
    """Without overrides the sweep is the single-device one: the same as
    passing the full view's own geometry explicitly."""
    full = PS.random_state(jr.PRNGKey(2), 12, 16, 3)
    key = jr.PRNGKey(8)
    got = PR.checkerboard_sweep(full, key, 1.0, 3, rule)
    explicit = PR.checkerboard_sweep(
        full, key, 1.0, 3, rule, gi=B.global_index(12, 16),
        neighbors_fn=PS.neighbor_states,
        masks=tuple(PR.parity_mask(12, 16, c) for c in (0, 1)))
    assert torch.equal(got, explicit)
    assert torch.equal(PR.parity_mask(12, 16, 1, 0, 0),
                       PR.parity_mask(12, 16, 1))


@pytest.mark.parametrize("rule", ["heat_bath", "metropolis"])
def test_checkerboard_sweep_overrides_match_jax(rule):
    """A patch at offset (6, 8) of a 24 x 32 lattice with explicit global
    indices, neighbour colours and offset parity masks, bitwise the JAX
    function's; the half-updates alone too."""
    rng = np.random.default_rng(5)
    patch = rng.integers(0, 3, size=(6, 8), dtype=np.int32)
    nbs = [rng.integers(0, 3, size=(6, 8), dtype=np.int32)
           for _ in range(4)]
    gi = B.global_index(6, 8, 6, 8, 32)
    jgi = JB.global_index(6, 8, 6, 8, 32)
    masks = tuple(PR.parity_mask(6, 8, c, 6, 8) for c in (0, 1))
    jmasks = tuple(JPR.parity_mask(6, 8, c, 6, 8) for c in (0, 1))
    for m, jm in zip(masks, jmasks):
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    got = PR.checkerboard_sweep(
        torch.from_numpy(patch), jr.PRNGKey(3), 1.05, 3, rule, gi=gi,
        neighbors_fn=lambda f: tuple(torch.from_numpy(n) for n in nbs),
        masks=masks)
    want = JPR.checkerboard_sweep(
        jnp.asarray(patch), jax.random.PRNGKey(3), 1.05, 3, rule, gi=jgi,
        neighbors_fn=lambda f: tuple(jnp.asarray(n) for n in nbs),
        masks=jmasks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tnbs = tuple(torch.from_numpy(n) for n in nbs)
    jnbs = tuple(jnp.asarray(n) for n in nbs)
    if rule == "heat_bath":
        got = PR.heat_bath_color(torch.from_numpy(patch), jr.PRNGKey(6),
                                 1.05, 3, 1, gi=gi, neighbors=tnbs,
                                 mask=masks[1])
        want = JPR.heat_bath_color(jnp.asarray(patch), jax.random.PRNGKey(6),
                                   1.05, 3, 1, gi=jgi, neighbors=jnbs,
                                   mask=jmasks[1])
    else:
        t = PR.metropolis_thresholds_traced(1.05)
        got = PR.metropolis_color(torch.from_numpy(patch), jr.PRNGKey(6), t,
                                  3, 1, gi=gi, neighbors=tnbs, mask=masks[1])
        want = JPR.metropolis_color(
            jnp.asarray(patch), jax.random.PRNGKey(6),
            JPR.metropolis_thresholds_u24(1.05), 3, 1, gi=jgi,
            neighbors=jnbs, mask=jmasks[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _launch(module, args, popen=False):
    cmd = [sys.executable, "-m", module, "--devices", "4"] + args
    if popen:
        return subprocess.Popen(cmd, cwd=str(REPO), env=_env(), text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=str(REPO),
                       env=_env(), timeout=600)
    assert p.returncode == 0, f"{p.stdout}\n{p.stderr}"
    return p.stdout


def _stats(text):
    return [line.split("flips/ns")[0].rsplit("  ", 1)[0]
            for line in text.splitlines() if "E/spin" in line]


@pytest.mark.parametrize("extra", [["--rule", "heat_bath"],
                                   ["--algo", "wolff"]],
                         ids=["checkerboard", "wolff"])
def test_simulate_launcher_potts_matches_jax(tmp_path, extra):
    """``--model potts --q 3`` on 4 gloo ranks (2x2): to sweep 8 with a
    checkpoint every 4, resumed to 12; the logged stats and the last
    checkpoint equal the JAX launcher's straight 12-sweep run."""
    common = ["--mesh", "2,2", "--blocks-per-device", "1", "--block-size",
              "8", "--chunk", "4", "--model", "potts", "--q", "3"] + extra
    ref = _launch("repro.launch.simulate",
                  common + ["--ckpt-dir", str(tmp_path / "jax"),
                            "--sweeps", "12"], popen=True)
    port = common + ["--ckpt-dir", str(tmp_path / "port")]
    out1 = _launch("repro_torch.launch.simulate", port + ["--sweeps", "8"])
    out2 = _launch("repro_torch.launch.simulate", port + ["--sweeps", "12"])
    assert "restored lattice at sweep 8" in out2
    ref_out, ref_err = ref.communicate(timeout=600)
    assert ref.returncode == 0, ref_err
    assert len(_stats(ref_out)) == 3
    assert _stats(out1) + _stats(out2) == _stats(ref_out)
    with np.load(tmp_path / "port" / "step_00000012.npz") as a, \
            np.load(tmp_path / "jax" / "step_00000012.npz") as b:
        np.testing.assert_array_equal(a["qb"], b["qb"])
