"""The port's int8 gradient compression against the JAX package, bitwise:
``quantize`` / ``dequantize`` (1-D, 2-D and 3-D, with and without
stochastic rounding), ``compress_tree`` / ``decompress_tree``, and
``psum_compressed`` over "pod" on gloo ranks against the reference's in a
shard_map on as many virtual devices (2 ranks, and a 2 x 2 (pod, data)
grid where the pod rings are two of the four ranks). The reference is
what XLA compiles (``jax.jit``): its scale is ``max|row|`` times the f32
reciprocal of 127. The same ranks hold the grid's ring collectives.
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
from repro.distributed import compression as JC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.distributed import compression as C  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402

SHAPES = [(16,), (8, 32), (4, 8, 16)]
GRIDS = [((2,), ("pod",)), ((2, 2), ("pod", "data"))]
# leaf -> (rows a rank holds, trailing shape, dtype)
LEAVES = {"b": (3, (), "float32"), "h": (4, (8,), "bfloat16"),
          "t": (2, (3, 5), "float32"), "w": (4, (16,), "float32")}


def _x(seed, shape, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    x = x.astype(np.float32)
    x.reshape(x.shape[0] if x.ndim > 1 else 1, -1)[0] = 0.0   # a zero row
    return x


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=["1d", "2d", "3d"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_round_trip_is_bitwise_the_reference(seed, shape,
                                                      stochastic):
    """Payload, scales and the dequantized tensor (f32 and bf16), inputs
    from 1e-3 to 1e3, one row all zeros; with a stochastic key the noise
    is the reference's threefry uniform."""
    for scale in (1e-3, 1.0, 1e3):
        x = _x(seed, shape, scale)
        key = jax.random.PRNGKey(seed + 10) if stochastic else None
        jq, js = jax.jit(JC.quantize)(jnp.asarray(x), key)
        q, s = C.quantize(torch.from_numpy(x), None if key is None else
                          bridge.key_from_numpy(key))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            got = C.dequantize(q, s, dt)
            want = jax.jit(JC.dequantize, static_argnums=2)(jq, js, jdt)
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("stochastic", [False, True])
def test_tree_round_trip_is_bitwise_the_reference(stochastic):
    """compress_tree (leaf i's noise under split(key, n)[i], leaves in
    JAX's order) and decompress_tree."""
    grads = {"b": {"c": _x(3, (5,)), "a": _x(4, (6, 2, 3))},
             "l": [_x(5, (4, 8)), _x(6, (7,))]}
    key = jax.random.PRNGKey(7) if stochastic else None
    jct = jax.jit(JC.compress_tree)(jax.tree.map(jnp.asarray, grads), key)
    ct = C.compress_tree(tree.map(torch.from_numpy, grads),
                         None if key is None else bridge.key_from_numpy(key))
    jl = jax.tree.leaves(jct)       # (payload, scale) of each leaf
    tl = tree.leaves(ct)
    assert len(jl) == len(tl) == 8
    for got, want in zip(tl, jl):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = C.decompress_tree(ct)
    jback = jax.jit(JC.decompress_tree)(jct)
    for got, want in zip(tree.leaves(back), jax.tree.leaves(jback)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert jr.split((0, 7), 2) == [bridge.key_from_numpy(k) for k in
                                   jax.random.split(jax.random.PRNGKey(7))]


def _global_grads(n: int) -> dict:
    """The global gradient tree of an n-rank grid: each leaf's leading dim
    is n blocks of the rank's rows."""
    rng = np.random.default_rng(n)
    out = {}
    for name, (rows, tail, dt) in LEAVES.items():
        a = rng.standard_normal((n * rows,) + tail).astype(np.float32)
        a *= 10.0 ** rng.integers(-2, 3, size=(n * rows,) + (1,) * len(tail))
        out[name] = a
    return out


_JAX_RUNS = """
import pickle
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.distributed import compression as C

with open(PATH + ".in", "rb") as f:
    GLOBAL = pickle.load(f)
out = {}
for shape, axes in GRIDS:
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
    grads = {k: jnp.asarray(v, LEAVES[k][2])
             for k, v in GLOBAL[n].items()}
    spec = P(axes)
    f = jax.jit(shard_map(lambda g: C.psum_compressed(g, "pod"), mesh=mesh,
                          in_specs=(spec,), out_specs=spec,
                          check_vma=False))
    res = f(grads)
    out[shape] = {k: np.asarray(v.astype(jnp.float32)) for k, v in res.items()}
with open(PATH, "wb") as f:
    pickle.dump(out, f)
"""


def _ranks_body(shape, axes, grads_np):
    """On every rank: psum_compressed over "pod" of its blocks, and the
    grid's ring collectives; rank 0 gets every rank's."""
    import torch.distributed as dist
    grid = mesh_lib.make_grid(shape, axes, "cpu")
    r = grid.axis_index(axes)
    local = {}
    for name, a in grads_np.items():
        rows, _, dt = LEAVES[name]
        local[name] = torch.from_numpy(a[r * rows:(r + 1) * rows]).to(
            getattr(torch, dt))
    out = {"psum_compressed": {k: v.float() for k, v in
                               C.psum_compressed(local, grid, "pod").items()}}
    x = torch.tensor([float(grid.rank + 1), -float(grid.rank)])
    for ring in [("pod",), ("data",), ("pod", "data"), ("data", "pod")]:
        if not all(a in axes for a in ring):
            continue
        out[ring] = (grid.psum(x, ring), grid.pmax(x, ring),
                     grid.all_gather(x[None], ring, 0),
                     grid.all_gather(x.to(torch.bfloat16)[:, None], ring,
                                     1).float())
    out["all"] = grid.psum(x)
    everyone = [None] * grid.size
    dist.all_gather_object(everyone, out)
    return everyone


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("compression") / "jax.pkl"
    glob = {int(np.prod(s)): _global_grads(int(np.prod(s)))
            for s, _ in GRIDS}
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    with open(str(path) + ".in", "wb") as f:
        pickle.dump(glob, f)
    code = (f"PATH = {str(path)!r}\nGRIDS = {GRIDS!r}\nLEAVES = {LEAVES!r}\n"
            + textwrap.dedent(_JAX_RUNS))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    port = {shape: mesh_lib.run_ranks(_ranks_body, int(np.prod(shape)),
                                      shape, axes, glob[int(np.prod(shape))])
            for shape, axes in GRIDS}
    stdout, stderr = proc.communicate(timeout=600)
    if proc.returncode:
        raise AssertionError(f"JAX runs failed:\n{stdout}\n{stderr}")
    with open(path, "rb") as f:
        return port, pickle.load(f)


@pytest.mark.parametrize("shape", [s for s, _ in GRIDS],
                         ids=["2", "2x2"])
def test_psum_compressed_is_bitwise_the_reference(results, shape):
    """Every rank's sum over its pod ring (common scale by pmax, int32
    payloads) equals the reference's shard_map output on that device,
    bitwise, f32 and bf16 leaves."""
    port, jax_out = results
    for rank, out in enumerate(port[shape]):
        for name, (rows, _, _) in LEAVES.items():
            want = jax_out[shape][name][rank * rows:(rank + 1) * rows]
            np.testing.assert_array_equal(
                out["psum_compressed"][name].numpy(), want,
                err_msg=f"rank {rank} {name}")


@pytest.mark.parametrize("shape,axes", GRIDS, ids=["2", "2x2"])
def test_ring_collectives(results, shape, axes):
    """psum / pmax / all_gather over the rings of each axis set (the
    all_gather in axis_index order, the first axis slowest, bf16 too) and
    psum over the whole grid, on every rank, against numpy."""
    port, _ = results
    ranks = range(int(np.prod(shape)))
    coords = [tuple(np.unravel_index(r, shape)) for r in ranks]
    xs = [np.array([r + 1.0, -float(r)], np.float32) for r in ranks]
    for r in ranks:
        out = port[shape][r]
        np.testing.assert_array_equal(out["all"].numpy(), sum(xs))
        for ring in [k for k in out if isinstance(k, tuple)]:
            dims = [axes.index(a) for a in ring]
            others = [i for i in range(len(shape)) if i not in dims]

            def index(c):
                return np.ravel_multi_index([c[i] for i in dims],
                                            [shape[i] for i in dims])
            members = sorted((q for q in ranks if all(
                coords[q][i] == coords[r][i] for i in others)),
                key=lambda q: index(coords[q]))
            total, top, gathered, gathered16 = out[ring]
            np.testing.assert_array_equal(total.numpy(),
                                          sum(xs[q] for q in members))
            np.testing.assert_array_equal(
                top.numpy(), np.max([xs[q] for q in members], 0))
            np.testing.assert_array_equal(
                gathered.numpy(), np.stack([xs[q] for q in members]))
            np.testing.assert_array_equal(
                gathered16.numpy(), np.stack([xs[q] for q in members], 1))
