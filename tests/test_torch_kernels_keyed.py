"""The kernels' keyed forms, which draw their bits in the kernel.

A keyed wrapper takes the colour key ``fold_in(fold_in(key, step), color)``
instead of a bits operand; its kernel hashes each site's flat index in
``[2, mr, mc, bs, bs]`` with threefry2x32, so it must equal the operand
form fed ``ops.color_bits``, which must equal the JAX package. On the CPU
the wrappers run their plain versions (``random.bits``, then the operand
form's plain version); ``chip_smoke.py`` holds the CUDA kernels against
them on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.core import checkerboard as cb  # noqa: E402
from repro_torch.core import sampler  # noqa: E402
from repro_torch.distributed import ising as dising  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import checkerboard as kern  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

BETA = 0.4406868
RULES = ("metropolis_lut", "heat_bath")
CASES = [(color, rule) for color in (0, 1) for rule in RULES]
GRIDS = [(1, 1), (1, 3), (2, 3), (3, 2)]
DTYPES = [(jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)]
KEYED = [(kern.update_color_tiles_keyed, kern.update_color_tiles),
         (kern.update_color_lines_keyed, kern.update_color_lines)]


def _quads(seed, mr, mc, bs, dtype=torch.bfloat16):
    key = jr.PRNGKey(seed)
    quads = sampler.init_state(key, 2 * mr * bs, 2 * mc * bs, dtype)
    return ops._block_quads(quads, bs)


@jax.jit
def _jax_ref_cases(qb, key, step):
    """repro.kernels.ops: color_bits, then update_color(backend="ref"), for
    every CASE."""
    return jnp.stack([
        jops.update_color(qb, jops.color_bits(key, step, color, qb.shape[1:]),
                          BETA, color, backend="ref", rule=rule)
        for color, rule in CASES])


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("bs", [12, 16, 32])
def test_keyed_forms_equal_color_bits_and_the_operand_form(bs, grid, jdt,
                                                           tdt):
    """Both colours, both rules: keyed == operand form on color_bits ==
    the JAX package, bitwise."""
    build.reset_launches()
    mr, mc = grid
    qb = _quads(bs + mr, mr, mc, bs, tdt)
    key, step = jr.PRNGKey(bs * 10 + mc), 3
    wants = np.asarray(_jax_ref_cases(
        jnp.asarray(bridge.to_numpy(qb, jnp.bfloat16), jdt),
        jnp.asarray(bridge.key_to_numpy(key)), step), np.float32)
    for want, (color, rule) in zip(wants, CASES):
        bits = ops.color_bits(key, step, color, qb.shape[1:])
        ckey = ops.color_key(key, step, color)
        for keyed, operand in KEYED:
            got = keyed(qb.clone(), ckey, BETA, color, rule)
            assert got.dtype == tdt
            np.testing.assert_array_equal(
                got.float().numpy(), want,
                err_msg=f"{keyed.__name__} {color} {rule}")
            torch.testing.assert_close(
                got, operand(qb.clone(), bits, BETA, color, rule), rtol=0,
                atol=0)
    assert build.launches == dict.fromkeys(build.launches, 0)


@pytest.mark.parametrize("color", [0, 1])
def test_keyed_lines_take_the_edge_provider(color):
    """Halo lines that are not the torus roll reach the keyed lines form as
    they reach the operand form."""
    qb = _quads(4, 2, 3, 16)
    key = jr.fold_in(jr.PRNGKey(4), 7)
    bits = jr.bits(key, (2,) + tuple(qb.shape[1:]))

    def negated(xb, side):
        return -cb.default_edges(xb, side)

    got = kern.update_color_lines_keyed(qb.clone(), key, 1.5, color,
                                        edges=negated)
    want = kern.update_color_lines(qb.clone(), bits, 1.5, color,
                                   edges=negated)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, kern.update_color_lines_keyed(
        qb.clone(), key, 1.5, color))


def test_keyed_forms_update_in_place_and_keep_passive_quads():
    qb = _quads(9, 2, 2, 8)
    key = jr.PRNGKey(9)
    for keyed, _ in KEYED:
        for color, passive in ((0, (1, 2)), (1, (0, 3))):
            x = qb.clone()
            out = keyed(x, key, 0.44, color)
            assert out is x
            for i in passive:
                torch.testing.assert_close(out[i], qb[i], rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["pallas", "pallas_lines"])
def test_sweeps_on_the_kernel_backends_equal_the_pallas_kernels(backend):
    """ops.sweep / run_sweeps (keyed forms) against the JAX package's
    sweeps through its Pallas kernels in interpret mode."""
    t_key = jr.PRNGKey(21)
    t_quads = sampler.init_state(t_key, 32, 32)
    quads = jnp.asarray(bridge.to_numpy(t_quads, jnp.bfloat16))
    key = jnp.asarray(bridge.key_to_numpy(t_key))
    want = jops.run_sweeps(quads, key, n_sweeps=2, beta=BETA, bs=8,
                           backend=backend, interpret=True)
    got = ops.run_sweeps(t_quads, t_key, n_sweeps=2, beta=BETA, bs=8,
                         backend=backend)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    want = jops.sweep(quads, key, 5, beta=BETA, bs=8, backend=backend,
                      interpret=True, rule="heat_bath")
    got = ops.sweep(t_quads, t_key, 5, beta=BETA, bs=8, backend=backend,
                    rule="heat_bath")
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_kernel_sweeps_hand_the_kernel_its_colour_key(monkeypatch):
    """A sweep on a kernel backend launches the keyed form under each
    colour's key and draws no ``color_bits`` (only ``ref`` does)."""
    t_key = jr.PRNGKey(2)
    qb = _quads(2, 2, 2, 8)
    want = ops.sweep_blocked(qb.clone(), t_key, 1, BETA, "ref")

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel-path sweep drew color_bits")

    monkeypatch.setattr(ops, "color_bits", refuse)
    for backend in ("pallas", "pallas_lines"):
        keys = []

        def spy(qb, key, *args, _real=ops._KEYED[backend], **kwargs):
            keys.append(key)
            return _real(qb, key, *args, **kwargs)

        monkeypatch.setitem(ops._KEYED, backend, spy)
        got = ops.sweep_blocked(qb.clone(), t_key, 1, BETA, backend)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert keys == [ops.color_key(t_key, 1, c) for c in (0, 1)]


@pytest.mark.parametrize("start", [2 ** 32 - 3, 2 ** 32, 2 ** 33 + 5,
                                   2 ** 40 + 123, 2 ** 62 - 2])
def test_bits_lanes_carry_the_high_counter_word(start):
    """The kernels hash a 64-bit site index as (n >> 32, n & 0xffffffff);
    the port's draws do the same past 2**32."""
    key = jr.fold_in(jr.PRNGKey(13), 5)
    got = jr._bits_lanes(key, start, start + 6, "cpu")
    want = [a ^ b for a, b in (jr._threefry_int(*key, n >> 32,
                                                n & 0xFFFFFFFF)
                               for n in range(start, start + 6))]
    assert got.tolist() == want
    np.testing.assert_array_equal(
        kern.threefry_bits(key, start, 6, "cpu").numpy(),
        np.array(want, np.uint64).astype(np.uint32).view(np.int32))


def test_threefry_bits_match_jax_from_zero():
    jk = jax.random.fold_in(jax.random.PRNGKey(8), 3)
    want = np.asarray(jax.random.bits(jk, (300,), jnp.uint32))
    got = kern.threefry_bits(bridge.key_from_numpy(np.asarray(jk)), 0, 300,
                             "cpu")
    np.testing.assert_array_equal(bridge.bits_to_numpy(got), want)


def test_distributed_lines_update_uses_the_keyed_form(monkeypatch):
    """The grid's pallas_lines colour update hands the lines kernel the
    colour key of the rank's device key."""
    seen = []
    real = kern.update_color_lines_keyed

    def spy(qb, key, *args, **kwargs):
        seen.append(key)
        return real(qb, key, *args, **kwargs)

    monkeypatch.setattr(kern, "update_color_lines_keyed", spy)
    cfg = dising.DistIsingConfig(beta=BETA, backend="pallas_lines")
    qb = _quads(6, 2, 2, 8)
    key = jr.PRNGKey(6)
    got = dising._local_color_update(qb.clone(), key, 4, 1, cfg,
                                     cb.default_edges)
    assert seen == [ops.color_key(key, 4, 1)]
    want = kern.update_color_lines(qb.clone(),
                                   ops.color_bits(key, 4, 1, qb.shape[1:]),
                                   BETA, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_keyed_wrappers_check_their_operands():
    qb = torch.ones(4, 1, 1, 8, 8)
    key = jr.PRNGKey(0)
    for fn, _ in KEYED:
        with pytest.raises(ValueError):
            fn(qb[:3], key, 0.4, 0)
        with pytest.raises(ValueError):
            fn(torch.ones(4, 1, 1, 8, 4), key, 0.4, 0)
        with pytest.raises(TypeError):
            fn(qb.double(), key, 0.4, 0)
        with pytest.raises(ValueError):
            fn(qb, key, 0.4, 2)
        with pytest.raises(ValueError):
            fn(qb, key, 0.4, 0, rule="wolff")
        for bad in ([key, key], (1, 2, 3), (-1, 0), (0, 2 ** 32), (0.5, 1),
                    (True, 1), [0, 1], np.array([0, 1])):
            with pytest.raises(ValueError, match="colour key"):
                fn(qb, bad, 0.4, 0)
    with pytest.raises(ValueError, match="colour key"):
        kern.threefry_bits([key], 0, 4, "cpu")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kern.threefry_bits(key, 0, 4, "meta")
