"""The grid scenarios end to end: ``IsingEngine(cfg, device="cpu")
.simulate(seed)`` on 1x2, 2x1 and 2x2 grids of gloo ranks against the JAX
engine on as many virtual devices, bitwise: the gathered state and the
moments. The ranks and the JAX runs (one subprocess per device count, as
the JAX package's own mesh tests run) start together.
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

from conftest import REPO, SRC  # noqa: E402
from repro_torch.api import EngineConfig, IsingEngine  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402

SEED = 6
GRIDS = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
# 2-D: a 48 x 32 lattice of 4 x 4 blocks (MR = 6, MC = 4), a side that is
# not a power of two; 3-D: a 6^3 cube, depth whole
_2D = dict(size=48, width=32, block_size=4, beta=0.4406868, n_sweeps=4,
           hot=True)
CONFIGS = [
    dict(_2D),
    dict(_2D, rule="heat_bath", dtype="float32", measure_every=3),
    dict(_2D, backend="pallas_lines", measure_every=3),
    dict(_2D, backend="pallas_lines", rule="heat_bath", dtype="float32",
         measure=False),
    dict(_2D, pipeline="opt"),
    dict(size=6, dims=3, beta=0.2216546, n_sweeps=4, hot=True),
]


def _cfg(shape, kw):
    return dict(kw, topology="mesh", mesh_shape=shape)


_JAX_RUNS = """
import pickle
import numpy as np
from repro.api import EngineConfig, IsingEngine
out = {}
for shape in GRIDS:
    for i, kw in enumerate(CONFIGS):
        r = IsingEngine(EngineConfig(**dict(kw, topology="mesh",
                                            mesh_shape=shape))).simulate(SEED)
        out[(shape, i)] = (np.asarray(r.state, np.float32), r.moments)
with open(PATH, "wb") as f:
    pickle.dump(out, f)
"""


def _start_jax(devices, path):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    code = (f"GRIDS = {GRIDS[devices]!r}\nCONFIGS = {CONFIGS!r}\n"
            f"SEED = {SEED}\nPATH = {str(path)!r}\n"
            + textwrap.dedent(_JAX_RUNS))
    return subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _port_body(grids):
    """On every rank: each config on each grid; rank 0 returns the
    gathered states and the moments."""
    out = {}
    for shape in grids:
        for i, kw in enumerate(CONFIGS):
            eng = IsingEngine(EngineConfig(**_cfg(shape, kw)), device="cpu")
            res = eng.simulate(SEED)
            assert res.magnetization is None and res.energy is None
            grid, place = eng.state_sharding()
            assert grid.shape == shape and grid.distributed
            out[(shape, i)] = (grid.gather(res.state, place).float(),
                               res.moments)
    out["collectives"] = dict(mesh_lib.counters)
    return out


def _results(tmp):
    jax_runs = {n: _start_jax(n, os.path.join(tmp, f"jax{n}.pkl"))
                for n in GRIDS}
    port = {n: mesh_lib.run_ranks(_port_body, n, GRIDS[n]) for n in GRIDS}
    jax = {}
    for n, proc in jax_runs.items():
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode:
            raise AssertionError(f"JAX runs on {n} devices failed:\n"
                                 f"{stdout}\n{stderr}")
        with open(os.path.join(tmp, f"jax{n}.pkl"), "rb") as f:
            jax.update(pickle.load(f))
    return port, jax


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return _results(str(tmp_path_factory.mktemp("mesh_engine")))


_CASES = [(shape, i) for n in GRIDS for shape in GRIDS[n]
          for i in range(len(CONFIGS))]


@pytest.mark.parametrize("shape,i", _CASES,
                         ids=[f"{s[0]}x{s[1]}-{i}" for s, i in _CASES])
def test_grid_engine_matches_jax_mesh(results, shape, i):
    port, jax = results
    n = shape[0] * shape[1]
    got_state, got_mom = port[n][(shape, i)]
    want_state, want_mom = jax[(shape, i)]
    assert tuple(got_state.shape) == want_state.shape
    np.testing.assert_array_equal(got_state.numpy(), want_state)
    assert got_mom == want_mom


@pytest.mark.parametrize("n", sorted(GRIDS))
def test_grid_runs_exchange_halos_and_reduce(results, n):
    """The ranks really exchanged halo lines and all-reduced the stats."""
    port, _ = results
    counts = port[n]["collectives"]
    assert counts["send"] > 0 and counts["all_reduce"] > 0
    assert counts["gather"] == len(GRIDS[n]) * len(CONFIGS)
