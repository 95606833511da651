"""The port's kernel module: the plain versions of both CUDA kernels against
the JAX package's kernel oracle, bitwise, over the shape, dtype, colour,
rule and beta grid of tests/test_kernel_checkerboard.py; and the launch
seam (``kernels.build``) every wrapper goes through.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
each against its plain version there); here a wrapper given a CPU tensor
runs the plain version and counts no launch.
"""
import contextlib
import ctypes
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lattice as JL  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.core import checkerboard as cb  # noqa: E402
from repro_torch.core import sampler  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import checkerboard as kern  # noqa: E402
from repro_torch.kernels import label as klabel  # noqa: E402
from repro_torch.kernels import measure as kmeasure  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import rng as krng  # noqa: E402

BETAS = (0.1, 0.4406868, 1.5)
RULES = ("metropolis_lut", "heat_bath")
GRIDS = [((1, 1), 32), ((2, 2), 32), ((3, 2), 16), ((1, 4), 32),
         ((2, 2), 128)]
DTYPES = [(jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)]
CASES = [(color, rule, beta) for color in (0, 1) for rule in RULES
         for beta in BETAS]


@jax.jit
def _jax_ref_all_cases(qb, bits):
    """repro.kernels.ops.update_color(backend="ref") for every CASE, in one
    compiled program per shape."""
    return jnp.stack([jops.update_color(qb, bits, beta, color, backend="ref",
                                        rule=rule)
                      for color, rule, beta in CASES])


def _port_inputs(seed, mr, mc, bs, dtype=torch.bfloat16):
    """Blocked quads and bits from the port's RNG (bitwise jax.random's,
    see test_torch_random_lattice.py)."""
    key = jr.PRNGKey(seed)
    quads = sampler.init_state(key, 2 * mr * bs, 2 * mc * bs, dtype)
    return (ops._block_quads(quads, bs),
            jr.bits(jr.fold_in(key, 1), (2, mr, mc, bs, bs)))


def _to_jax(qb, bits, jdt):
    return (jnp.asarray(bridge.to_numpy(qb, jnp.bfloat16), jdt),
            jnp.asarray(bridge.bits_to_numpy(bits)))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("grid,bs", GRIDS)
def test_plain_kernels_match_jax_ref(grid, bs, jdt, tdt):
    """Both colours, both rules, three betas, two seeds per shape. On a CPU
    tensor each wrapper runs its plain version."""
    mr, mc = grid
    build.reset_launches()
    kh = torch.from_numpy(np.array(JL.kernel_compact(bs, jnp.float32)))
    for seed in (0, 3):
        t_qb, t_bits = _port_inputs(seed, mr, mc, bs, tdt)
        wants = np.asarray(_jax_ref_all_cases(*_to_jax(t_qb, t_bits, jdt)),
                           np.float32)
        for want, (color, rule, beta) in zip(wants, CASES):
            for fn in (kern.update_color_tiles, kern.update_color_lines):
                got = fn(t_qb.clone(), t_bits, beta, color, rule)
                assert got.dtype == tdt
                np.testing.assert_array_equal(
                    got.float().numpy(), want,
                    err_msg=f"{fn.__name__} {color} {rule} {beta}")
            got = kref.update_color_ref(t_qb, t_bits, kh.to(tdt), beta,
                                        color, rule)
            np.testing.assert_array_equal(got.float().numpy(), want)
    assert build.launches == dict.fromkeys(build.launches, 0)


def test_plain_kernels_match_pallas_interpret():
    """One case against the Pallas kernels themselves, in interpret mode."""
    t_qb, t_bits = _port_inputs(5, 2, 2, 16)
    qb, bits = _to_jax(t_qb, t_bits, jnp.bfloat16)
    for color in (0, 1):
        for backend, fn in (("pallas", kern.update_color_tiles),
                            ("pallas_lines", kern.update_color_lines)):
            want = jops.update_color(qb, bits, 0.4406868, color,
                                     backend=backend, interpret=True)
            got = fn(t_qb.clone(), t_bits, 0.4406868, color)
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))


def test_kernels_update_in_place_and_keep_passive_quads():
    t_qb, t_bits = _port_inputs(9, 2, 2, 8)
    for fn in (kern.update_color_tiles, kern.update_color_lines):
        for color, passive in ((0, (1, 2)), (1, (0, 3))):
            x = t_qb.clone()
            out = fn(x, t_bits, 0.44, color)
            assert out is x
            for i in passive:
                torch.testing.assert_close(out[i], t_qb[i], rtol=0, atol=0)


def test_lines_kernel_takes_custom_edges():
    """The edge provider is the hook of the later mesh path: the lines
    reach only the tile-edge rows and columns of the active quads."""
    t_qb, t_bits = _port_inputs(2, 2, 2, 8, torch.float32)
    torus = kern.update_color_tiles(t_qb.clone(), t_bits, 1.5, 0)
    same = kern.update_color_lines(t_qb.clone(), t_bits, 1.5, 0,
                                   edges=cb.default_edges)
    torch.testing.assert_close(same, torus, rtol=0, atol=0)
    zero = kern.update_color_lines(
        t_qb.clone(), t_bits, 1.5, 0,
        edges=lambda xb, side: torch.zeros_like(xb[:, :, 0, :]))
    inner = (slice(None), slice(None), slice(None), slice(1, -1),
             slice(1, -1))
    torch.testing.assert_close(zero[inner], torus[inner], rtol=0, atol=0)
    zeros = tuple(torch.zeros_like(t_qb[0, :, :, 0, :]) for _ in range(4))
    torch.testing.assert_close(
        zero, kern.update_color_lines_plain(t_qb.clone(), t_bits, 1.5, 0,
                                            lines=zeros), rtol=0, atol=0)


def test_ops_run_sweeps_match_jax():
    t_key = jr.PRNGKey(7)
    t_quads = sampler.init_state(t_key, 64, 32)
    want = np.asarray(jops.run_sweeps(
        jnp.asarray(bridge.to_numpy(t_quads, jnp.bfloat16)),
        jnp.asarray(bridge.key_to_numpy(t_key)), n_sweeps=3, beta=0.44,
        bs=8, backend="ref"), np.float32)
    for backend in ("pallas", "pallas_lines", "ref"):
        got = ops.run_sweeps(t_quads, t_key, n_sweeps=3, beta=0.44, bs=8,
                             backend=backend)
        np.testing.assert_array_equal(got.float().numpy(), want)
        one = ops.sweep(t_quads, t_key, 0, beta=0.44, bs=8, backend=backend)
        torch.testing.assert_close(
            one, ops.run_sweeps(t_quads, t_key, n_sweeps=1, beta=0.44, bs=8,
                                backend="ref"), rtol=0, atol=0)


def test_color_bits_match_jax():
    key = jax.random.PRNGKey(11)
    for step, color in ((0, 0), (3, 1), (17, 0)):
        want = np.asarray(jops.color_bits(key, step, color, (2, 3, 4, 4)))
        got = ops.color_bits(bridge.key_from_numpy(np.asarray(key)), step,
                             color, (2, 3, 4, 4))
        assert tuple(got.shape) == (2, 2, 3, 4, 4)
        np.testing.assert_array_equal(bridge.bits_to_numpy(got), want)


def test_wrappers_check_their_operands():
    qb = torch.ones(4, 1, 1, 8, 8)
    bits = jr.bits(jr.PRNGKey(0), (2, 1, 1, 8, 8))
    for fn in (kern.update_color_tiles, kern.update_color_lines):
        with pytest.raises(ValueError):
            fn(qb[:3], bits, 0.4, 0)
        with pytest.raises(ValueError):
            fn(qb, bits[:1], 0.4, 0)
        with pytest.raises(TypeError):
            fn(qb.double(), bits, 0.4, 0)
        with pytest.raises(TypeError):
            fn(qb, bits.long(), 0.4, 0)
        with pytest.raises(ValueError):
            fn(qb, bits, 0.4, 2)
        with pytest.raises(ValueError):
            fn(qb, bits, 0.4, 0, rule="wolff")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.update_color(qb, bits, 0.4, 0, backend="xla")


def test_build_paths_follow_the_sources(tmp_path, monkeypatch):
    """Library names hash the sources and flags; without nvcc the build
    raises instead of falling back."""
    names = set(build.SOURCES)
    assert names == {"checkerboard_tiles", "checkerboard_lines",
                     "blocked_totals", "threefry_fold", "label_components",
                     "threefry_draw", "metropolis_flip"}
    paths = {n: build.library_path(n) for n in names}
    assert len(set(paths.values())) == 7
    assert all(p.parent == build.BUILD_DIR for p in paths.values())
    assert build.library_path("checkerboard_tiles") == \
        paths["checkerboard_tiles"]
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["checkerboard_tiles"])


WRAPPERS = ("update_color_tiles", "update_color_lines",
            "update_color_tiles_keyed", "update_color_lines_keyed",
            "blocked_totals", "fold_in_bits", "label_components")


def _meta_call(name):
    """Wrapper ``name`` and its arguments, every tensor on ``meta``."""
    qb = torch.ones(4, 1, 1, 8, 8, device="meta")
    bits = torch.zeros(2, 1, 1, 8, 8, dtype=torch.int32, device="meta")
    key = jr.PRNGKey(0)
    bonds = torch.zeros(8, 8, dtype=torch.bool, device="meta")
    return {"update_color_tiles": (kern, (qb, bits, 0.4, 0)),
            "update_color_lines": (kern, (qb, bits, 0.4, 0)),
            "update_color_tiles_keyed": (kern, (qb, key, 0.4, 0)),
            "update_color_lines_keyed": (kern, (qb, key, 0.4, 0)),
            "blocked_totals": (kmeasure, (qb,)),
            "fold_in_bits": (krng, (key, bits)),
            "label_components": (klabel, (bonds, bonds))}[name]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_refuse_other_devices(name):
    """Neither CPU nor CUDA: no plain version runs, and every wrapper
    raises the seam's one message and counts nothing."""
    module, args = _meta_call(name)
    build.reset_launches()
    with pytest.raises(ValueError, match=rf"^{name} runs on CUDA or CPU "
                       r"tensors \(the CPU runs its plain version\), got "
                       r"meta$"):
        getattr(module, name)(*args)
    assert build.launches == dict.fromkeys(build.launches, 0)


@pytest.mark.parametrize("err", [0, 700])
def test_launch_sets_the_signature_once_and_counts_what_returns_0(
        err, monkeypatch):
    """``build.launch`` on a stand-in library: the entry's signature is set
    when it is first loaded; a tensor passes its pointer and the stream
    comes last; a nonzero return raises naming the entry and counts
    nothing, a zero return counts one launch under the wrapper's name."""
    calls, loads = [], []

    def fn(*args):
        calls.append(args)
        return err

    def load(name):
        loads.append(name)
        return types.SimpleNamespace(ising_blocked_totals=fn)

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(build, "_FUNCTIONS", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=9))
    entry = build.Entry("blocked_totals", "blocked_totals",
                        "ising_blocked_totals",
                        (ctypes.c_void_p, ctypes.c_int))
    build.reset_launches()
    t = torch.zeros(3)
    for _ in range(2):
        if err:
            with pytest.raises(RuntimeError, match="^ising_blocked_totals "
                               "launch failed: cudaError 700$"):
                build.launch(entry, "cuda", t, 5)
        else:
            build.launch(entry, "cuda", t, 5)
    assert loads == ["blocked_totals"]
    assert fn.restype is ctypes.c_int
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    assert calls == [(t.data_ptr(), 5, 9)] * 2
    assert build.launches == dict(dict.fromkeys(build.launches, 0),
                                  blocked_totals=0 if err else 2)
