"""The decomposed cluster plane of the port against the JAX package:
Swendsen-Wang / Wolff on 1x2, 2x1 and 2x2 grids of gloo ranks (the
cross-rank label merge), replica ensembles sharded over ``replica_axes``,
and the launcher with ``--algo swendsen_wang`` through a checkpoint and a
resume, all bitwise against the JAX package on as many virtual devices.

One JAX subprocess (4 virtual devices; the 2-device grids take the first
two) computes every reference while the port's ranks run, one spawn per
grid shape. The restored ``fk_bonds`` overrides are held in-process.
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
from repro_torch import random as jr  # noqa: E402
from repro_torch.api import EngineConfig, IsingEngine  # noqa: E402
from repro_torch.api import beta_ladder  # noqa: E402
from repro_torch.cluster import bonds as B  # noqa: E402
from repro_torch.cluster import mesh as cmesh  # noqa: E402
from repro_torch.core import lattice as L  # noqa: E402
from repro_torch.distributed import ising as dising  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402

SEED = 9
GRIDS = [(1, 2), (2, 1), (2, 2)]
# a 48 x 32 lattice of 4 x 4 blocks (N = 1536, not a power of two, so the
# moments' accumulate order shows)
_2D = dict(size=48, width=32, block_size=4, beta=0.45, n_sweeps=5,
           hot=True)
CONFIGS = [
    dict(_2D, algorithm="swendsen_wang", dtype="float32"),
    dict(_2D, algorithm="wolff", measure_every=2),
    dict(_2D, algorithm="swendsen_wang", beta=0.3, measure=False),
]
BETAS = beta_ladder(0.8, 1.2, 4)
_ENS = dict(size=24, betas=BETAS, n_sweeps=4, block_size=4)
# (replica_axes, grids it runs on)
ENSEMBLES = [(("data",), [(2, 1), (2, 2)]), (("model",), [(1, 2)]),
             (("data", "model"), [(2, 2)])]
LABEL_BETA, LABEL_KEY = 0.5, 7


def _cfg(shape, kw):
    return dict(kw, topology="mesh", mesh_shape=shape)


def _ens(shape, axes):
    return [(i, dict(_ENS, topology="mesh", mesh_shape=shape,
                     replica_axes=axes))
            for i, (a, grids) in enumerate(ENSEMBLES)
            if a == axes and shape in grids]


_JAX_RUNS = """
import pickle
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.api import EngineConfig, IsingEngine
from repro.cluster import mesh as cmesh
from repro.core import lattice as L
from repro.distributed import ising as dising

def mesh_of(shape):
    n = shape[0] * shape[1]
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))

out = {}
for shape in GRIDS:
    mesh = mesh_of(shape)
    for i, kw in enumerate(CONFIGS):
        eng = IsingEngine(EngineConfig(**dict(kw, topology="mesh",
                                              mesh_shape=shape)), mesh=mesh)
        r = eng.simulate(SEED)
        chunk = eng.run_sweeps(eng.init(jax.random.PRNGKey(1)),
                               jax.random.PRNGKey(2), 3)
        out[(shape, i)] = (np.asarray(r.state, np.float32), r.moments,
                           np.asarray(chunk, np.float32), eng.stats(chunk))
    for i, (axes, grids) in enumerate(ENSEMBLES):
        if shape not in grids:
            continue
        eng = IsingEngine(EngineConfig(**dict(ENS, topology="mesh",
                                              mesh_shape=shape,
                                              replica_axes=axes)), mesh=mesh)
        r = eng.simulate(SEED)
        out[("ens", shape, i)] = (np.asarray(r.state, np.float32),
                                  np.asarray(r.magnetization),
                                  np.asarray(r.energy), r.moments)
    cfg = dising.DistIsingConfig(beta=LABEL_BETA, block_size=4,
                                 row_axes=("data",), col_axes=("model",))
    full = L.random_lattice(jax.random.PRNGKey(3), 48, 32, jnp.float32)
    quads = L.to_quads(full)
    qb = jnp.stack([L.block(quads[i], 4) for i in range(4)])
    qb = jax.device_put(qb, dising.lattice_sharding(mesh, cfg))
    out[("labels", shape)] = np.asarray(cmesh.make_labels_fn(mesh, cfg)(
        qb, jax.random.PRNGKey(LABEL_KEY)))
with open(PATH, "wb") as f:
    pickle.dump(out, f)
"""


def _start_jax(path):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    code = (f"GRIDS = {GRIDS!r}\nCONFIGS = {CONFIGS!r}\nENS = {_ENS!r}\n"
            f"ENSEMBLES = {ENSEMBLES!r}\nSEED = {SEED}\n"
            f"LABEL_BETA = {LABEL_BETA}\nLABEL_KEY = {LABEL_KEY}\n"
            f"PATH = {str(path)!r}\n" + textwrap.dedent(_JAX_RUNS))
    return subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _blocked(full, bs):
    q = L.to_quads(full)
    return torch.stack([L.block(q[i], bs) for i in range(4)]).contiguous()


def _port_body(shape):
    """On every rank of one grid: the engine runs, the ensembles and one
    bond draw's labels; rank 0 returns them gathered."""
    out = {}
    for i, kw in enumerate(CONFIGS):
        eng = IsingEngine(EngineConfig(**_cfg(shape, kw)), device="cpu")
        res = eng.simulate(SEED)
        assert res.magnetization is None and res.energy is None
        grid, place = eng.state_sharding()
        assert grid.shape == shape and grid.distributed
        chunk = eng.run_sweeps(eng.init(jr.PRNGKey(1)), jr.PRNGKey(2), 3)
        out[(shape, i)] = (grid.gather(res.state, place).float(),
                           res.moments,
                           grid.gather(chunk, place).float(),
                           eng.stats(chunk))
    for axes, _ in ENSEMBLES:
        for i, kw in _ens(shape, axes):
            eng = IsingEngine(EngineConfig(**kw), device="cpu")
            res = eng.simulate(SEED)
            grid, place = eng.state_sharding()
            out[("ens", shape, i)] = (grid.gather(res.state, place).float(),
                                      res.magnetization.numpy(),
                                      res.energy.numpy(), res.moments,
                                      tuple(res.state.shape))
    grid = mesh_lib.make_grid(shape, ("data", "model"), "cpu")
    cfg = dising.DistIsingConfig(beta=LABEL_BETA, block_size=4,
                                 row_axes=("data",), col_axes=("model",))
    full = L.random_lattice(jr.PRNGKey(3), 48, 32, torch.float32)
    loc = grid.local_block(_blocked(full, 4), dising.lattice_spec(cfg))
    mesh_lib.reset_counters()
    lab = cmesh.make_labels_fn(grid, cfg)(loc, jr.PRNGKey(LABEL_KEY))
    out[("labels", shape)] = grid.gather(lab, (("data",), ("model",)))
    out[("merge", shape)] = dict(mesh_lib.counters)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("cluster_mesh") / "jax.pkl"
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
def test_cluster_mesh_engine_matches_jax(results, shape, i):
    """State, moments, a measurement-free chunk and its global stats."""
    port, jax_out = results
    state, mom, chunk, stats = port[(shape, i)]
    jstate, jmom, jchunk, jstats = jax_out[(shape, i)]
    np.testing.assert_array_equal(state.numpy(), jstate)
    assert mom == jmom
    np.testing.assert_array_equal(chunk.numpy(), jchunk)
    assert stats == jstats


@pytest.mark.parametrize("shape", GRIDS,
                         ids=[f"{s[0]}x{s[1]}" for s in GRIDS])
def test_mesh_labels_match_jax(results, shape):
    """One bond draw's global canonical labels after the cross-rank
    merge; the merge ran (one all-reduce of the changed flag an
    iteration, at least two iterations: a change, then none)."""
    port, jax_out = results
    np.testing.assert_array_equal(port[("labels", shape)].numpy(),
                                  jax_out[("labels", shape)])
    counts = port[("merge", shape)]
    assert counts["label_merge"] >= 2
    assert counts["all_reduce"] == counts["label_merge"]


_ENS_CASES = [(shape, i) for i, (_, grids) in enumerate(ENSEMBLES)
              for shape in grids]


@pytest.mark.parametrize("shape,i", _ENS_CASES,
                         ids=[f"{s[0]}x{s[1]}-{'+'.join(ENSEMBLES[i][0])}"
                              for s, i in _ENS_CASES])
def test_replica_sharded_ensemble_matches_jax(results, shape, i):
    """A replica ensemble over ``replica_axes``: each rank steps its share
    (its state is that share); series and moments come back gathered in
    the [n_replicas] layout, bitwise the JAX engine's."""
    port, jax_out = results
    state, ms, es, mom, local = port[("ens", shape, i)]
    jstate, jms, jes, jmom = jax_out[("ens", shape, i)]
    shards = 1
    for a in ENSEMBLES[i][0]:
        shards *= shape[("data", "model").index(a)]
    assert local[0] == len(BETAS) // shards
    np.testing.assert_array_equal(state.numpy(), jstate)
    np.testing.assert_array_equal(ms, jms)
    np.testing.assert_array_equal(es, jes)
    assert mom.keys() == jmom.keys()
    for k in mom:
        np.testing.assert_array_equal(mom[k], np.asarray(jmom[k]))


def test_ensemble_mesh_checks_and_refusals():
    """The reference's even-shard check, and the JAX package's refusals
    of cluster and Potts ensembles and tempering on a mesh, word for
    word."""
    from repro.api import EngineConfig as JConfig
    from repro_torch.api import EngineConfigError
    fake = mesh_lib.DeviceGrid((2, 1), ("data", "model"), 0,
                               torch.device("cpu"))
    with pytest.raises(EngineConfigError, match="cannot shard evenly"):
        IsingEngine(EngineConfig(**dict(_ENS, betas=BETAS[:3],
                                        topology="mesh", mesh_shape=(2, 1))),
                    device="cpu", grid=fake)
    mesh = dict(topology="mesh", mesh_shape=(2, 2))
    for kw in (dict(algorithm="swendsen_wang"), dict(model="potts", q=3),
               dict(ensemble="tempering")):
        cfg = dict(size=16, betas=(0.4, 0.5), **mesh, **kw)
        with pytest.raises(ValueError) as want:
            JConfig(**cfg).validate()
        with pytest.raises(EngineConfigError) as got:
            IsingEngine(EngineConfig(**cfg), device="cpu")
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# fk_bonds' restored overrides
# ---------------------------------------------------------------------------


def test_fk_bonds_defaults_are_the_single_device_bonds():
    """Without overrides fk_bonds is the torus-roll, full-index form."""
    full = L.random_lattice(jr.PRNGKey(1), 12, 16, torch.float32)
    key, t = jr.PRNGKey(5), B.bond_threshold_u24(0.45)
    br, bd = B.fk_bonds(full, key, t)
    gi = B.global_index(12, 16)
    want_r = (full == torch.roll(full, -1, -1)) & B.active(
        B.bond_bits(key, gi, 0), t)
    want_d = (full == torch.roll(full, -1, -2)) & B.active(
        B.bond_bits(key, gi, 1), t)
    assert torch.equal(br, want_r) and torch.equal(bd, want_d)
    assert torch.equal(B.global_index(12, 16, 0, 0, 16), gi)


def test_fk_bonds_overrides_match_jax():
    """Explicit east / south neighbours and a patch's global indices,
    bitwise the JAX function's."""
    rng = np.random.default_rng(3)
    patch = rng.choice([-1.0, 1.0], size=(6, 8)).astype(np.float32)
    east = rng.choice([-1.0, 1.0], size=(6, 8)).astype(np.float32)
    south = rng.choice([-1.0, 1.0], size=(6, 8)).astype(np.float32)
    t = B.bond_threshold_u24(0.4)
    gi = B.global_index(6, 8, 12, 8, 24)
    want_gi = JB.global_index(6, 8, 12, 8, 24)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(want_gi))
    got = B.fk_bonds(torch.from_numpy(patch), jr.PRNGKey(4), t,
                     east=torch.from_numpy(east),
                     south=torch.from_numpy(south), gi=gi)
    want = JB.fk_bonds(jnp.asarray(patch), jax.random.PRNGKey(4), t,
                       east=jnp.asarray(east), south=jnp.asarray(south),
                       gi=want_gi)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


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


def test_simulate_launcher_swendsen_wang_matches_jax(tmp_path):
    """``--algo swendsen_wang`` on 4 gloo ranks (2x2): to sweep 8 with a
    checkpoint every 4, resumed to 12; the logged stats and the last
    checkpoint equal the JAX launcher's straight 12-sweep run."""
    common = ["--mesh", "2,2", "--blocks-per-device", "1", "--block-size",
              "8", "--chunk", "4", "--algo", "swendsen_wang"]
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
