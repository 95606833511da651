"""Checkpoints and the simulate launcher of the port: atomic save/restore,
keep-k, bf16 widening, async writes, ``.npz`` files that the JAX package's
``repro.checkpoint.ckpt`` reads and writes alike, elastic restore of a
decomposed lattice from 4 gloo ranks onto 2, resume == straight run, and
``python -m repro_torch.launch.simulate`` running, resuming and matching
the JAX launcher bitwise."""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import REPO, SRC  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.api import EngineConfig  # noqa: E402
from repro_torch.api.engine import check_ported  # noqa: E402
from repro_torch.api import IsingEngine  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import simulate  # noqa: E402


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(4, 8))
                                         .astype(np.float32)),
                   "emb": torch.from_numpy(rng.normal(size=16)
                                           .astype(np.float32))
                   .to(torch.bfloat16)},
        "opt": {"m": [torch.zeros(4, 8), torch.ones(3)]},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves(tree):
    return [leaf for _, leaf in ckpt._flatten(tree)]


def test_save_restore_roundtrip(tmp_path):
    state = _state()
    ckpt.save(str(tmp_path), state, step=7)
    restored = ckpt.restore(str(tmp_path), state)
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_bf16_widening_is_exact(tmp_path):
    state = {"x": torch.arange(256, dtype=torch.bfloat16) / 7}
    ckpt.save(str(tmp_path), state, step=1)
    with np.load(tmp_path / "step_00000001.npz") as data:
        assert data["x"].dtype == np.float32
    r = ckpt.restore(str(tmp_path), state)
    assert r["x"].dtype == torch.bfloat16
    assert torch.equal(r["x"], state["x"])


def test_keep_k_prunes_old(tmp_path):
    state = _state()
    for step in (10, 20, 30, 40, 50):
        ckpt.save(str(tmp_path), state, step=step, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [40, 50]
    assert ckpt.latest_step(str(tmp_path)) == 50


def test_restore_specific_step(tmp_path):
    for step in (1, 2):
        ckpt.save(str(tmp_path), {"s": torch.tensor(step)}, step=step,
                  keep=5)
    r = ckpt.restore(str(tmp_path), {"s": torch.tensor(0)}, step=1)
    assert int(r["s"]) == 1


def test_no_partial_checkpoint_visible(tmp_path):
    """Temp files are not checkpoints (atomicity)."""
    (tmp_path / ".tmp_step_00000099.npz").write_bytes(b"garbage")
    assert ckpt.all_steps(str(tmp_path)) == []
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), {"x": torch.zeros(1)})


def test_async_save(tmp_path):
    state = _state()
    t = ckpt.save(str(tmp_path), state, step=3, async_=True)
    assert isinstance(t, threading.Thread)
    t.join(timeout=30)
    assert not t.is_alive()
    assert ckpt.latest_step(str(tmp_path)) == 3
    r = ckpt.restore(str(tmp_path), state)
    assert torch.equal(r["params"]["w"], state["params"]["w"])


def test_restore_accepts_meta_template(tmp_path):
    """``like`` leaves may be meta tensors (``state_template()``): the
    dtype is honoured without allocating."""
    eng = IsingEngine(EngineConfig(size=16, beta=0.4, block_size=4),
                      device="cpu")
    st = eng.init(jr.PRNGKey(0))
    ckpt.save(str(tmp_path), {"qb": st}, step=1)
    like = {"qb": eng.state_template()}
    assert like["qb"].device.type == "meta"
    out = ckpt.restore(str(tmp_path), like)["qb"]
    assert out.dtype == torch.bfloat16 and torch.equal(out, st)


def test_checkpoints_cross_read_with_reference(tmp_path):
    """The port reads the reference's files and the reference the port's:
    same keys, bf16 widened to f32 on disk."""
    state = _state(1)
    ckpt.save(str(tmp_path / "port"), state, step=4)
    jlike = jax.tree.map(lambda t: jnp.asarray(
        bridge.to_numpy(t, jnp.bfloat16)), state)
    jgot = jckpt.restore(str(tmp_path / "port"), jlike)
    for (_, a), b in zip(ckpt._flatten(state), jax.tree.leaves(jgot)):
        assert np.asarray(b).dtype == bridge.to_numpy(a, jnp.bfloat16).dtype
        np.testing.assert_array_equal(np.asarray(b, np.float32),
                                      a.float().numpy())
    jckpt.save(str(tmp_path / "ref"), jlike, step=9)
    got = ckpt.restore(str(tmp_path / "ref"), state)
    for a, b in zip(_leaves(state), _leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


_RESUME_CASES = [
    # every checkpointable scenario the port runs
    ("ensemble", dict(size=16, betas=(0.35, 0.44, 0.5), block_size=8)),
    ("cluster", dict(size=16, beta=0.8, algorithm="swendsen_wang",
                     block_size=8)),
    ("potts_cb", dict(size=16, beta=1.0, model="potts", q=3,
                      rule="heat_bath")),
    ("potts_cluster", dict(size=16, beta=1.0, model="potts", q=3,
                           algorithm="wolff")),
    ("opt", dict(size=24, beta=0.44, pipeline="opt", block_size=4)),
    ("mesh", dict(size=24, beta=0.44, block_size=4, topology="mesh",
                  mesh_shape=(1, 1), backend="pallas_lines")),
    ("mesh3d", dict(size=6, beta=0.22, dims=3, topology="mesh",
                    mesh_shape=(1, 1))),
]


def _chunked(engine, state, key, start, stop, chunk=4):
    done = start
    while done < stop:
        state = engine.run_sweeps(state, jr.fold_in(key, done), chunk)
        done += chunk
    return state


@pytest.mark.parametrize("name,kw", _RESUME_CASES,
                         ids=[n for n, _ in _RESUME_CASES])
def test_resume_equals_straight_run_per_scenario(tmp_path, name, kw):
    """Chunked run -> checkpoint -> restore (template + sharding) ->
    continue == the uninterrupted chunked run, bitwise."""
    engine = IsingEngine(EngineConfig(n_sweeps=4, **kw), device="cpu")
    key = jr.PRNGKey(11)
    st0 = engine.init(jr.PRNGKey(10))
    straight = _chunked(engine, st0, key, 0, 8)
    sh = engine.state_sharding()
    ckpt.save(str(tmp_path), {"qb": _chunked(engine, st0, key, 0, 4)},
              step=4, shardings=({"qb": sh} if sh else None))
    restored = ckpt.restore(str(tmp_path), {"qb": engine.state_template()},
                            shardings=({"qb": sh} if sh else None))["qb"]
    assert restored.dtype == engine.state_template().dtype, name
    resumed = _chunked(engine, restored, key, 4, 8)
    assert torch.equal(straight, resumed), name


# ---------------------------------------------------------------------------
# Elastic restore across grids, in gloo ranks
# ---------------------------------------------------------------------------

_CUBE = dict(size=8, beta=0.2216546, dims=3, topology="mesh", n_sweeps=2)
_QUADS = dict(size=32, beta=0.44, block_size=4, topology="mesh",
              n_sweeps=2)


def _save_on_4(path):
    """4 ranks (2x2): 4 sweeps of the cube and of the 2-D lattice, each
    saved (gathered to rank 0) at step 4."""
    out = {}
    for name, kw in (("cube", _CUBE), ("quads", _QUADS)):
        eng = IsingEngine(EngineConfig(mesh_shape=(2, 2), **kw),
                          device="cpu")
        key = jr.PRNGKey(3)
        st = _chunked(eng, eng.init(jr.PRNGKey(2)), key, 0, 4, chunk=2)
        ckpt.save(os.path.join(path, name), {"qb": st}, step=4,
                  shardings={"qb": eng.state_sharding()})
        grid, place = eng.state_sharding()
        out[name] = grid.gather(st, place)
    return out


def _resume_on_2(path):
    """2 ranks (1x2): restore both, continue to step 8; for the 2-D
    lattice also run on from the restored global state held in memory."""
    out = {}
    for name, kw in (("cube", _CUBE), ("quads", _QUADS)):
        eng = IsingEngine(EngineConfig(mesh_shape=(1, 2), **kw),
                          device="cpu")
        sh = eng.state_sharding()
        st = ckpt.restore(os.path.join(path, name),
                          {"qb": eng.state_template()},
                          shardings={"qb": sh})["qb"]
        grid, place = sh
        out[name + "_restored"] = grid.gather(st, place)
        out[name] = grid.gather(
            _chunked(eng, st, jr.PRNGKey(3), 4, 8, chunk=2), place)
    return out


def test_elastic_restore_4_ranks_onto_2(tmp_path):
    """Saved on a 2x2 grid, restored on 1x2: every rank gets its block of
    the saved global state, and the cube (decomposition-independent) run on
    to step 8 equals a straight one-rank run of 8 sweeps, bitwise."""
    saved = mesh_lib.run_ranks(_save_on_4, 4, str(tmp_path))
    resumed = mesh_lib.run_ranks(_resume_on_2, 2, str(tmp_path))
    for name in ("cube", "quads"):
        assert torch.equal(resumed[name + "_restored"], saved[name]), name
    one = IsingEngine(EngineConfig(mesh_shape=(1, 1), **_CUBE),
                      device="cpu")
    straight = _chunked(one, one.init(jr.PRNGKey(2)), jr.PRNGKey(3), 0, 8,
                        chunk=2)
    assert torch.equal(resumed["cube"], straight)
    assert not torch.equal(resumed["quads"], saved["quads"])


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _launch(module, args, devices, popen=False):
    cmd = [sys.executable, "-m", module, "--devices", str(devices)] + args
    if popen:
        return subprocess.Popen(cmd, cwd=str(REPO), env=_env(), text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=str(REPO),
                       env=_env(), timeout=600)
    assert p.returncode == 0, f"{p.stdout}\n{p.stderr}"
    return p.stdout


def test_simulate_launcher_runs_resumes_and_matches_jax(tmp_path):
    """4 gloo ranks on a 2x2 grid run to sweep 20 with a checkpoint every
    10, resume to 30; the logged stats and the final checkpoint equal the
    JAX launcher's straight 30-sweep run on 4 virtual devices, bitwise."""
    common = ["--mesh", "2,2", "--blocks-per-device", "1", "--block-size",
              "16", "--chunk", "10"]
    ref = _launch("repro.launch.simulate",
                  common + ["--ckpt-dir", str(tmp_path / "jax"),
                            "--sweeps", "30"], 4, popen=True)
    port = common + ["--ckpt-dir", str(tmp_path / "port")]
    out1 = _launch("repro_torch.launch.simulate", port + ["--sweeps", "20"],
                   4)
    assert "sweep     20" in out1
    out2 = _launch("repro_torch.launch.simulate", port + ["--sweeps", "30"],
                   4)
    assert "restored lattice at sweep 20" in out2
    assert "sweep     30" in out2
    ref_out, ref_err = ref.communicate(timeout=600)
    assert ref.returncode == 0, ref_err

    def stats(text):
        return [line.split("flips/ns")[0].rsplit("  ", 1)[0]
                for line in text.splitlines() if "E/spin" in line]
    assert stats(out1) + stats(out2) == stats(ref_out)
    with np.load(tmp_path / "port" / "step_00000030.npz") as a, \
            np.load(tmp_path / "jax" / "step_00000030.npz") as b:
        np.testing.assert_array_equal(a["qb"], b["qb"])


@pytest.mark.parametrize("extra", [["--model", "potts", "--q", "3"],
                                   ["--algo", "wolff"]])
def test_simulate_launcher_refuses_unported_grids(extra):
    """The Potts and cluster grids, refused before any rank started while
    they were not ported, now pass the launcher's check as grid scenarios
    (their runs are held in test_torch_cluster_mesh.py and
    test_torch_potts_mesh.py)."""
    args = simulate.parse_args(["--devices", "4", "--mesh", "2,2"] + extra)
    cfg = simulate.build(args)[0]
    assert check_ported(cfg) in ("potts_cb_mesh", "cluster_mesh")
    assert cfg.topology == "mesh" and cfg.mesh_shape == (2, 2)


def test_simulate_launcher_device_choice(capsys):
    """Without --devices the run is one rank on the card, or on the CPU
    only when asked; the replica path runs every model on one device."""
    small = ["--mesh", "1,1", "--blocks-per-device", "1", "--block-size",
             "4", "--sweeps", "2", "--chunk", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            simulate.main(small)
    assert simulate.main(small + ["--device", "cpu"]) == 0
    assert simulate.main(small + ["--device", "cpu", "--replicas", "2",
                                  "--model", "potts", "--q", "3"]) == 0
    assert simulate.main(small + ["--device", "cpu", "--dims", "3"]) == 0
    out = capsys.readouterr().out
    assert out.count("sweep      2") == 3 and "2 replicas of 8x8" in out
