"""``random``'s draws and their device kernel (``kernels.rng.draw``).

``random.bits``, ``uniform``, ``bernoulli`` and ``randint`` launch one draw
kernel on a CUDA device and run their eager int64 form anywhere else. On
the CPU the wrapper's plain version is that eager form, held here to
threefry2x32 of each element's counter computed on the host, with each
form's epilogue written out in Python ints (``test_torch_random_lattice.py``
holds the eager form to the JAX package). The tests marked ``cuda`` hold
the kernel bit for bit against the eager form on the card and skip without
one. This file imports no JAX.
"""
import math
import struct

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import random as jr  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rng  # noqa: E402

KEY = jr.fold_in(jr.PRNGKey(23), 4)
KEYS = [jr.PRNGKey(0), jr.PRNGKey(-7), (0xFFFFFFFF, 0x80000001)] + [
    jr.fold_in(KEY, i) for i in range(13)]
# the key kinds: one key, and key batches of 1, 3 and 16
KEY_KINDS = {"single": KEY, "batch1": KEYS[:1], "batch3": KEYS[:3],
             "batch16": KEYS[:16]}
SPANS = [1, 2, 7, 2 ** 16, 2 ** 16 + 1, 2 ** 31, 2 ** 32 - 1]
# each form: (dtype, randint bounds); bernoulli is the f32 uniform below p.
# randint's minval is negative: -5, or -2**31 where the span needs it
FORMS = {"bits": (torch.int32, None), "f32": (torch.float32, None),
         "bf16": (torch.bfloat16, None), "f16": (torch.float16, None),
         **{f"randint{s}": (torch.int32, (lo, lo + s)) for s, lo in
            ((s, -5 if s <= 2 ** 31 else -2 ** 31) for s in SPANS)}}
# lengths; 13 leaves rows 1 and 2 of a batch off 16 bytes
LENGTHS = [0, 1, 7, 8, 4097, 13]
BELOW_2_32 = 2 ** 32 - 11       # a draw from here carries the hi word


def _zero():
    jr.reset_counters()
    build.reset_launches()


def _signed(w: int) -> int:
    return w - ((w >> 31) << 32)


def _word(key, c: int) -> int:
    """x0 ^ x1 of threefry2x32 of counter c, on the host."""
    x0, x1 = jr._threefry_int(*jr.key_data(key), c >> 32, c & 0xFFFFFFFF)
    return x0 ^ x1


def _host(key, n: int, dtype, bounds, start: int) -> list:
    """The draw of counters [start, start + n) under one key, each form's
    epilogue in Python ints."""
    out = []
    for c in range(start, start + n):
        if bounds is not None:
            k1, k2 = jr.split(key)
            span = (bounds[1] - bounds[0]) & 0xFFFFFFFF
            m = (((1 << 16) % span) ** 2 & 0xFFFFFFFF) % span
            off = (((_word(k1, c) % span) * m & 0xFFFFFFFF)
                   + _word(k2, c) % span) & 0xFFFFFFFF
            out.append(_signed((off % span + bounds[0]) & 0xFFFFFFFF))
            continue
        w = _word(key, c)
        if dtype == torch.int32:
            out.append(_signed(w))
        elif dtype == torch.float32:
            out.append(struct.unpack("<f", struct.pack(
                "<I", (w >> 9) | 0x3F800000))[0] - 1.0)
        elif dtype == torch.bfloat16:
            out.append(((w & 0xFF) >> 1) / 128)
        else:
            out.append(((w & 0xFFFF) >> 6) / 1024)
    return out


def _as_list(t: torch.Tensor) -> list:
    return t.tolist() if t.dtype == torch.int32 else t.float().tolist()


def _public(form: str, key, shape, device):
    """The draw through ``random``'s own function for ``form``."""
    dtype, bounds = FORMS.get(form, (torch.float32, None))
    if form == "bernoulli":
        return jr.bernoulli(key, 0.5, shape, device)
    if bounds is not None:
        return jr.randint(key, shape, *bounds, device)
    if dtype == torch.int32:
        return jr.bits(key, shape, device)
    return jr.uniform(key, shape, dtype, device)


def _eager(form: str, key, shape, device, start: int = 0):
    if form == "bernoulli":
        return jr._draw_eager(key, shape, torch.float32, device) < 0.5
    dtype, bounds = FORMS[form]
    return jr._draw_eager(key, shape, dtype, device, bounds, start)


def _words(form: str, key, shape) -> int:
    """``random.counters["draw_words"]`` of one draw."""
    rows = len(key) if jr.is_batch(key) else 1
    return (2 if form.startswith("randint") else 1) * rows * math.prod(shape)


# ---------------------------------------------------------------------------
# On the CPU: the wrapper's plain version is the eager form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start", [0, BELOW_2_32])
@pytest.mark.parametrize("form", list(FORMS))
def test_cpu_wrapper_is_the_eager_form(form, start):
    """Every form, a single key and a key batch, from counter 0 and from
    just below 2**32: element e is counter start + e under its row's key,
    as the host hashes it; a CPU draw launches nothing."""
    dtype, bounds = FORMS[form]
    _zero()
    got = rng.draw(KEY, (3, 7), dtype, "cpu", bounds, start)
    assert got.dtype == dtype and got.shape == (3, 7)
    assert _as_list(got.flatten()) == _host(KEY, 21, dtype, bounds, start)
    batch = rng.draw(KEYS[:3], (5,), dtype, "cpu", bounds, start)
    assert batch.shape == (3, 5)
    for i, k in enumerate(KEYS[:3]):
        assert _as_list(batch[i]) == _host(k, 5, dtype, bounds, start)
    assert torch.equal(got, jr._draw_eager(KEY, (3, 7), dtype, "cpu",
                                           bounds, start))
    if form == "bits":
        lanes = jr._bits_lanes(KEY, start, start + 21, "cpu")
        assert torch.equal(got.flatten(), jr._as_int32(lanes))
    assert build.launches == dict.fromkeys(build.launches, 0)
    assert jr.counters == {"fold_in_bits_eager": 0, "draw_words": 0}


@pytest.mark.parametrize("form", [*FORMS, "bernoulli"])
def test_cpu_draws_take_the_eager_form(form):
    """``random``'s own functions on the CPU: the eager form, their words
    counted, no launch."""
    shape = (4, 9)
    for key in (KEY, KEYS[:3]):
        _zero()
        got = _public(form, key, shape, "cpu")
        assert torch.equal(got, _eager(form, key, shape, "cpu"))
        assert jr.counters == {"fold_in_bits_eager": 0,
                               "draw_words": _words(form, key, shape)}
        assert build.launches == dict.fromkeys(build.launches, 0)


def test_meta_draws_keep_the_eager_form():
    """A device that is neither CPU nor CUDA draws eagerly (no values, the
    shapes and dtypes); only the kernel wrapper itself refuses it."""
    _zero()
    assert jr.uniform(KEYS[:3], (4, 5), torch.bfloat16, "meta").shape == \
        (3, 4, 5)
    assert jr.randint(KEY, (6,), 0, 9, "meta").dtype == torch.int32
    assert jr.bits(KEY, (2, 3), "meta").device.type == "meta"
    assert build.launches == dict.fromkeys(build.launches, 0)
    with pytest.raises(ValueError, match=r"^threefry_draw runs on CUDA or "
                       r"CPU tensors \(the CPU runs its plain version\), got "
                       r"meta$"):
        rng.draw(KEY, (4,), torch.int32, "meta")


def test_wrapper_refuses_what_the_kernel_does_not_write():
    with pytest.raises(ValueError, match="float64"):
        rng.draw(KEY, (4,), torch.float64, "cpu")
    with pytest.raises(ValueError, match="randint draws int32"):
        rng.draw(KEY, (4,), torch.float32, "cpu", (0, 5))


def _grid_chunk(device, sweeps: int = 2):
    """A chunk of the simulate launcher's default engine (a 1 x 1 grid, the
    paper pipeline, bf16 uniforms) on a 64^2 lattice from a fixed +-1
    start."""
    from repro_torch.api import IsingEngine
    from repro_torch.launch import simulate
    cfg = simulate.build(simulate.parse_args([
        "--mesh", "1,1", "--blocks-per-device", "4", "--block-size", "8",
        "--chunk", str(sweeps)]))[0]
    g = torch.Generator().manual_seed(5)
    quads = (torch.randint(0, 2, (4, 32, 32), generator=g) * 2 - 1).to(
        torch.bfloat16)
    state = quads.view(4, 4, 8, 4, 8).permute(0, 1, 3, 2, 4).contiguous()
    eng = IsingEngine(cfg, device=device)
    return eng.run_sweeps(state.to(device), jr.fold_in(jr.PRNGKey(3), 0),
                          sweeps)


def test_grid_path_on_the_cpu_launches_no_draw():
    _zero()
    _grid_chunk("cpu")
    assert jr.counters["draw_words"] == 64 * 64 * 2
    assert build.launches == dict.fromkeys(build.launches, 0)


# ---------------------------------------------------------------------------
# On the card (marked cuda; skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtypes, shapes and bit patterns."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in (torch.bfloat16, torch.float16):
        a, b = a.view(torch.int16), b.view(torch.int16)
    elif a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _kernel_equals_eager(form, key, shape, device):
    """``random``'s function for ``form`` on the card: one launch (none
    for an empty draw), its words counted as before, bitwise the eager
    form on the same device."""
    _zero()
    got = _public(form, key, shape, device)
    assert build.launches["threefry_draw"] == int(math.prod(shape) > 0)
    assert jr.counters == {"fold_in_bits_eager": 0,
                           "draw_words": _words(form, key, shape)}
    assert got.device.type == "cuda"
    assert _bitwise(got, _eager(form, key, shape, device))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", list(KEY_KINDS))
@pytest.mark.parametrize("form", [*FORMS, "bernoulli"])
def test_kernel_every_form_key_kind_and_length(cuda, form, kind, n):
    _kernel_equals_eager(form, KEY_KINDS[kind], (n,), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["single", "batch3"])
@pytest.mark.parametrize("form", list(FORMS))
def test_kernel_carries_the_hi_word(cuda, form, kind):
    """From just below 2**32, through the wrapper: counters on both sides
    of 2**32, in vectors and in the tail."""
    dtype, bounds = FORMS[form]
    key = KEY_KINDS[kind]
    for n in (8, 37, 4099):
        _zero()
        got = rng.draw(key, (n,), dtype, cuda, bounds, BELOW_2_32)
        assert build.launches["threefry_draw"] == 1
        want = jr._draw_eager(key, (n,), dtype, cuda, bounds, BELOW_2_32)
        assert _bitwise(got, want)
    row = got[0] if jr.is_batch(key) else got
    k = key[0] if jr.is_batch(key) else key
    assert _as_list(row[:16].cpu()) == _host(k, 16, dtype, bounds,
                                             BELOW_2_32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(), (2, 3, 5, 7, 11)])
@pytest.mark.parametrize("form", ["bits", "f32", "bf16", "f16", "randint7"])
def test_kernel_shapes_and_the_cpu(cuda, form, shape):
    """A scalar draw (Wolff's seed) and a [2, 3, 5, 7, 11] one, under one
    key and a key batch: the card's bits equal the CPU's eager form."""
    for key in (KEY, KEYS[:3]):
        got = _kernel_equals_eager(form, key, shape, cuda)
        assert _bitwise(got.cpu(), _eager(form, key, shape, "cpu"))


@pytest.mark.cuda
def test_kernel_at_the_launchers_shape(cuda):
    """The launcher's colour draw: bf16 uniforms over [2, 80, 80, 128,
    128] (20480^2), and f32 under a 16-key batch at a quarter of it."""
    _kernel_equals_eager("bf16", jr.fold_in(KEY, 0), (2, 80, 80, 128, 128),
                         cuda)
    _kernel_equals_eager("f32", KEYS[:16], (2, 20, 80, 128, 128), cuda)


@pytest.mark.cuda
def test_grid_path_launches_two_draws_a_sweep(cuda):
    """The launcher's default path on the card: one draw launch a colour,
    the chunk equal to the CPU's; the keyed tile path launches none."""
    from repro_torch.api import EngineConfig, IsingEngine
    want = _grid_chunk("cpu", 3)
    _zero()
    got = _grid_chunk(cuda, 3)
    assert build.launches["threefry_draw"] == 2 * 3
    assert jr.counters["draw_words"] == 64 * 64 * 3
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)
    eng = IsingEngine(EngineConfig(size=64, beta=0.4406868, n_sweeps=3,
                                   block_size=8, backend="pallas",
                                   measure=False), device=cuda)
    state = eng.init(jr.PRNGKey(2))
    _zero()
    eng.run_sweeps(state, jr.PRNGKey(3), 3)
    assert build.launches["threefry_draw"] == 0
    assert build.launches["update_color_tiles_keyed"] == 2 * 3
