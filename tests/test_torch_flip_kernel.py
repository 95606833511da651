"""The site update of the paper pipeline and its device kernel
(``kernels.flip.flip_lut``).

``core.checkerboard._flip`` launches one flip kernel on the card for the
LUT rule at a Python-number beta and no field, written in place where the
caller gives ``out``; every other form, and the CPU, runs the rule's eager
chain. On the CPU the wrapper's plain version is held here to the eager
``flip_probs`` bit for bit, the dispatch to its forms, and the
``repro_torch.checkerboard.flip`` span and the two benchmark readers of it
to made-up events. The tests marked ``cuda`` hold the kernel bit for bit
against the eager form on the card and skip without one. This file imports
no JAX.
"""
import collections
import importlib.util
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import random as jr  # noqa: E402
from repro_torch.core import checkerboard as cb  # noqa: E402
from repro_torch.core import update_rules as rules  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flip as kflip  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BETA_C = 0.4406868
# beta at T = 0 (beta 0 is infinite T: every flip accepted), 0.5 T_c, T_c,
# 2 T_c
BETAS = {"zero": 0.0, "half_tc": 2 * BETA_C, "tc": BETA_C,
         "two_tc": BETA_C / 2}
SPINS = {"bf16": torch.bfloat16, "f32": torch.float32}
PROBS = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
# lengths; 13 and 4097 are not a multiple of 8 (nor of 4)
LENGTHS = [1, 7, 8, 13, 4097]
FLIP = "repro_torch.checkerboard.flip"


def _inputs(n: int, spin, prob, beta: float, seed: int = 0, device="cpu"):
    """n sites: +-1 spins, neighbour sums of four +-1 spins, and uniforms,
    a third of them set on a table value or one step of the uniforms'
    dtype either side of it."""
    g = torch.Generator().manual_seed(seed)
    pm = lambda *s: (torch.randint(0, 2, s, generator=g) * 2 - 1)  # noqa
    sigma = pm(n).to(spin)
    nn = pm(4, n).sum(0).to(spin)
    probs = torch.rand(n, generator=g).to(prob)
    table = torch.tensor(kflip.lut_table(beta, spin)).to(prob)
    k = torch.randint(0, 5, (n,), generator=g)
    step = torch.randint(-1, 2, (n,), generator=g)
    on = table[k]
    on = torch.where(step > 0, torch.nextafter(on, on + 1), on)
    on = torch.where(step < 0, torch.nextafter(on, on - 1), on)
    pick = torch.randint(0, 3, (n,), generator=g) == 0
    probs = torch.where(pick, on, probs)
    return sigma.to(device), nn.to(device), probs.to(device)


def _eager(sigma, nn, probs, beta):
    return rules.get_rule("lut").flip_probs(sigma, nn, probs, beta)


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtypes, shapes and bit patterns."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.view(ints), b.view(ints))


def _zero():
    build.reset_launches()


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("beta", list(BETAS))
@pytest.mark.parametrize("prob", list(PROBS))
@pytest.mark.parametrize("spin", list(SPINS))
def test_plain_version_is_the_eager_form(spin, prob, beta):
    """The wrapper on the CPU (its plain version) with the cached table:
    bitwise the eager ``flip_probs``, uniforms on the table values
    included; nothing launches."""
    b = BETAS[beta]
    sigma, nn, probs = _inputs(4097, SPINS[spin], PROBS[prob], b)
    _zero()
    got = kflip.flip_lut(sigma, nn, probs, kflip.lut_table(b, sigma.dtype))
    assert _bitwise(got, _eager(sigma, nn, probs, b))
    assert build.launches == dict.fromkeys(build.launches, 0)


@pytest.mark.parametrize("spin", list(SPINS))
@pytest.mark.parametrize("beta", list(BETAS))
def test_cached_table_is_the_acceptance_table(beta, spin):
    b, dtype = BETAS[beta], SPINS[spin]
    table = kflip.lut_table(b, dtype)
    want = rules.acceptance_table(b, dtype, "cpu")
    assert len(table) == 5 and all(isinstance(v, float) for v in table)
    assert _bitwise(torch.tensor(table).to(dtype), want)
    assert kflip.lut_table(b, dtype) is table


def _forms():
    """(name, arguments of ``_flip`` after sigma, nn, probs) for every
    form, and whether the kernel computes it on the card."""
    n_beta = torch.tensor([0.3, 0.5], dtype=torch.float32)
    return {
        "lut": ((BETA_C, "lut"), True),
        "metropolis": ((BETA_C, "metropolis"), True),
        "metropolis_lut": ((BETA_C, "metropolis_lut"), True),
        "int_beta": ((1, "lut"), True),
        "tensor_beta": ((torch.tensor(BETA_C), "lut"), False),
        "replica_betas": ((n_beta, "lut"), False),
        "field": ((BETA_C, "lut", 0.1), False),
        "exp": ((BETA_C, "exp"), False),
        "heat_bath": ((BETA_C, "heat_bath"), False),
    }


@pytest.mark.parametrize("form", list(_forms()))
def test_dispatch_takes_the_kernel_for_its_forms_only(form):
    """The kernel's forms (the LUT rule, a number beta, no field) and the
    eager ones; on the CPU every form runs the eager chain and launches
    nothing."""
    args, kernel = _forms()[form]
    sigma, nn, probs = _inputs(64, torch.bfloat16, torch.bfloat16, BETA_C)
    sigma, nn, probs = (t.view(2, 32) for t in (sigma, nn, probs))
    assert cb._kernel_takes(sigma, nn, probs, *args[:2],
                            args[2] if len(args) > 2 else 0.0,
                            None) is kernel
    _zero()
    got = cb._flip(sigma, nn, probs, *args)
    want = rules.get_rule(args[1]).flip_probs(sigma, nn, probs, args[0],
                                              *args[2:])
    assert _bitwise(got, want)
    assert build.launches == dict.fromkeys(build.launches, 0)


def test_dispatch_leaves_other_dtypes_and_shapes_eager():
    sigma, nn, probs = _inputs(16, torch.bfloat16, torch.bfloat16, BETA_C)
    assert cb._kernel_takes(sigma, nn, probs, BETA_C, "lut", 0.0, None)
    assert not cb._kernel_takes(sigma.half(), nn.half(), probs, BETA_C,
                                "lut", 0.0, None)
    assert not cb._kernel_takes(sigma, nn.float(), probs, BETA_C, "lut",
                                0.0, None)
    assert not cb._kernel_takes(sigma, nn, probs.double(), BETA_C, "lut",
                                0.0, None)
    assert not cb._kernel_takes(sigma, nn, probs[:8], BETA_C, "lut", 0.0,
                                None)
    assert not cb._kernel_takes(sigma, nn, probs, BETA_C, "lut", 0.0,
                                sigma.float())
    assert not cb._kernel_takes(sigma, nn, probs.to("meta"), BETA_C, "lut",
                                0.0, None)


@pytest.mark.parametrize("form", ["lut", "heat_bath"])
def test_flip_into_out_is_the_flip(form):
    """``_flip(..., out=t)`` writes t and returns it, equal to the new
    tensor of ``_flip(...)``; ``out`` may be sigma itself."""
    sigma, nn, probs = _inputs(333, torch.bfloat16, torch.bfloat16, BETA_C)
    want = cb._flip(sigma, nn, probs, BETA_C, form)
    t = torch.zeros_like(sigma)
    assert cb._flip(sigma, nn, probs, BETA_C, form, out=t) is t
    assert _bitwise(t, want)
    s = sigma.clone()
    assert cb._flip(s, nn, probs, BETA_C, form, out=s) is s
    assert _bitwise(s, want)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    sigma, nn, probs = _inputs(8, torch.bfloat16, torch.bfloat16, BETA_C)
    table = kflip.lut_table(BETA_C, torch.bfloat16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kflip.flip_lut(sigma.half(), nn.half(), probs, table)
    with pytest.raises(ValueError, match="uniforms"):
        kflip.flip_lut(sigma, nn, probs.double(), table)
    with pytest.raises(ValueError, match="one shape"):
        kflip.flip_lut(sigma, nn, probs[:4], table)
    with pytest.raises(ValueError, match="five values"):
        kflip.flip_lut(sigma, nn, probs, table[:4])
    with pytest.raises(ValueError, match="out must match"):
        kflip.flip_lut(sigma, nn, probs, table, out=sigma.float())
    with pytest.raises(ValueError, match=r"^flip_lut runs on CUDA or CPU"):
        kflip.flip_lut(*(t.to("meta") for t in (sigma, nn, probs)), table)


def _profiled(fn):
    """(fn's result, count of each ``repro_torch.`` range it recorded)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, collections.Counter(e.name for e in prof.events()
                                    if e.name.startswith("repro_torch."))


@pytest.mark.parametrize("form", ["lut", "exp"])
def test_the_flip_span_is_entered_on_the_eager_path(form):
    sigma, nn, probs = _inputs(64, torch.bfloat16, torch.bfloat16, BETA_C)
    plain = cb._flip(sigma, nn, probs, BETA_C, form)
    traced, counts = _profiled(
        lambda: cb._flip(sigma, nn, probs, BETA_C, form))
    assert dict(counts) == {FLIP: 1}
    assert _bitwise(traced, plain)


def test_no_flip_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    sigma, nn, probs = _inputs(64, torch.bfloat16, torch.bfloat16, BETA_C)
    cb._flip(sigma, nn, probs, BETA_C, "lut")


def _grid_chunk(device, sweeps: int = 2):
    """A chunk of the simulate launcher's default engine (a 1 x 1 grid, the
    paper pipeline, bf16 uniforms) on a 64^2 lattice in 8^2 blocks from a
    fixed +-1 start."""
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


def _grid_chunk_copying(monkeypatch, sweeps: int = 2):
    """The same chunk with each flip into a new tensor, copied into the
    stack afterwards."""
    flip = cb._flip

    def copying(sigma, nn, probs, beta, accept, field=0.0, out=None):
        new = flip(sigma, nn, probs, beta, accept, field)
        if out is not None:
            out[...] = new
        return new
    with monkeypatch.context() as m:
        m.setattr(cb, "_flip", copying)
        return _grid_chunk("cpu", sweeps)


def test_in_place_grid_chunk_is_the_copying_one(monkeypatch):
    assert _bitwise(_grid_chunk("cpu", 3), _grid_chunk_copying(monkeypatch,
                                                               3))


# --- the benchmark's readers of the span, on made-up events ----------------


def _reader(name):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_flip_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _window(host, device, sweeps=2, sites=64):
    from perfbench import trace
    from perfbench.trace import Op
    return trace.window(device, [Op(trace.WINDOW, 0.0, 10.0),
                                 Op(trace.CHUNK, 0.0, 9.5)] + host,
                        seconds=10.0, sweeps=sweeps, sites=sites,
                        config={"dtype": "bfloat16",
                                "prob_dtype": "bfloat16"},
                        counters={})


def _colour_events():
    """A colour: the nn span with one launch, two flip spans with one
    launch each (the second one's kernel queued past its span's end), and
    a launch outside every span."""
    from perfbench.trace import Op
    host = [Op(cb.NN, 0.1, 0.2), Op("cudaLaunchKernel", 0.15, 0.16, corr=1),
            Op(FLIP, 0.3, 0.4), Op("cudaLaunchKernel", 0.35, 0.36, corr=2),
            Op(FLIP, 0.5, 0.6), Op("cudaLaunchKernel", 0.55, 0.56, corr=3),
            Op("aten::copy_", 0.57, 0.58, corr=5),
            Op("cudaLaunchKernel", 0.7, 0.71, corr=4)]
    device = [Op("bmm", 0.2, 0.5, corr=1), Op("flip", 0.5, 1.5, corr=2),
              Op("flip", 1.5, 3.5, corr=3), Op("stats", 3.5, 4.0, corr=4),
              Op("copy", 4.0, 4.5, corr=5)]
    return host, device


def test_readers_of_the_flip_span():
    host, device = _colour_events()
    w = _window(host, device, sweeps=2, sites=10 ** 9)
    assert _reader("flip_ms_per_sweep").read(w) == pytest.approx(
        1e3 * 3.0 / 2)
    bound = 2 * 10 ** 9 * 8 / 3.35e12
    roof = _reader("flip_roofline_pct")
    assert roof.flip_bound_s(2 * 10 ** 9, 2, 2) == pytest.approx(bound)
    assert roof.read(w) == pytest.approx(100 * bound / 3.0)


def test_the_flip_bound_of_the_launchers_sweep():
    """20480^2 sites of bf16 spins and uniforms: 8 B a site over the HBM
    rate, 1.0016 ms; f32 spins with bf16 uniforms 14 B a site."""
    roof = _reader("flip_roofline_pct")
    assert roof.flip_bound_s(20480 ** 2, 2, 2) == pytest.approx(1.0016e-3,
                                                                rel=1e-4)
    assert roof.flip_bound_s(100, 4, 2) == pytest.approx(1400 / 3.35e12)


@pytest.mark.parametrize("name", ["flip_ms_per_sweep", "flip_roofline_pct"])
def test_readers_find_nothing_without_the_span(name):
    """The parent program has no flip span."""
    from perfbench.trace import Op
    host = [Op(cb.NN, 0.1, 0.2), Op("cudaLaunchKernel", 0.15, 0.16, corr=1)]
    device = [Op("bmm", 0.2, 0.5, corr=1)]
    assert _reader(name).read(_window(host, device)) is None


# ---------------------------------------------------------------------------
# On the card (marked cuda; skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _kernel_equals_eager(sigma, nn, probs, beta, out=None):
    """``_flip`` of the LUT rule on the card: one launch, bitwise the eager
    chain on the same device; returns the result."""
    want = _eager(sigma, nn, probs, beta)
    _zero()
    got = cb._flip(sigma, nn, probs, beta, "lut", out=out)
    assert build.launches["flip_lut"] == 1
    assert got.device.type == "cuda"
    assert _bitwise(got, want)
    if out is not None:
        assert got is out
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("beta", list(BETAS))
@pytest.mark.parametrize("prob", list(PROBS))
@pytest.mark.parametrize("spin", list(SPINS))
def test_kernel_every_dtype_beta_and_length(cuda, spin, prob, beta, n):
    b = BETAS[beta]
    sigma, nn, probs = _inputs(n, SPINS[spin], PROBS[prob], b, n, cuda)
    _kernel_equals_eager(sigma, nn, probs, b)


@pytest.mark.cuda
@pytest.mark.parametrize("prob", list(PROBS))
@pytest.mark.parametrize("spin", list(SPINS))
def test_kernel_in_place_and_on_misaligned_views(cuda, spin, prob):
    """``out`` is sigma itself; views one element off 16 bytes take the
    scalar loop; a strided view is copied in and its result copied out."""
    sigma, nn, probs = _inputs(4099, SPINS[spin], PROBS[prob], BETA_C, 1,
                               cuda)
    want = _eager(sigma, nn, probs, BETA_C)
    s = sigma.clone()
    _kernel_equals_eager(s, nn, probs, BETA_C, out=s)
    s, n_, p = sigma[1:], nn[1:], probs[1:]
    _kernel_equals_eager(s, n_, p, BETA_C)
    s = sigma.clone()[1:]
    _kernel_equals_eager(s, n_, p, BETA_C, out=s)
    assert _bitwise(s, want[1:])
    grid = [t[:4096].view(64, 64).t() for t in (sigma, nn, probs)]
    out = torch.zeros(64, 64, dtype=sigma.dtype, device=cuda).t()
    _kernel_equals_eager(*grid, BETA_C, out=out)


@pytest.mark.cuda
def test_kernel_refuses_an_out_that_overlaps_an_input(cuda):
    sigma, nn, probs = _inputs(64, torch.bfloat16, torch.bfloat16, BETA_C, 2,
                               cuda)
    table = kflip.lut_table(BETA_C, torch.bfloat16)
    with pytest.raises(ValueError, match="overlap"):
        kflip.flip_lut(sigma, nn, probs, table, out=nn)
    with pytest.raises(ValueError, match="overlap"):
        kflip.flip_lut(sigma[:32], nn[:32], probs[:32], table,
                       out=sigma[8:40])


@pytest.mark.cuda
def test_kernel_at_the_launchers_shape(cuda):
    """A quad of the launcher's 20480^2 colour update, [80, 80, 128, 128]
    bf16 spins and bf16 uniforms at T_c, written in place."""
    shape = (80, 80, 128, 128)
    n = 80 * 80 * 128 * 128
    sigma, nn, probs = (t.view(shape) for t in _inputs(
        n, torch.bfloat16, torch.bfloat16, BETA_C, 3, cuda))
    _kernel_equals_eager(sigma, nn, probs, BETA_C, out=sigma)


@pytest.mark.cuda
def test_grid_path_flips_four_quads_a_sweep(cuda):
    """The launcher's default path on the card: one flip launch a quad,
    written into the stack, the chunk bitwise the CPU's eager chunk; the
    keyed tile path and a Swendsen-Wang sweep launch none."""
    from repro_torch.api import EngineConfig, IsingEngine
    want = _grid_chunk("cpu", 3)
    _zero()
    got = _grid_chunk(cuda, 3)
    assert build.launches["flip_lut"] == 4 * 3
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)
    for cfg in (dict(backend="pallas"), dict(algorithm="swendsen_wang")):
        eng = IsingEngine(EngineConfig(size=64, beta=BETA_C, n_sweeps=3,
                                       block_size=8, measure=False, **cfg),
                          device=cuda)
        state = eng.init(jr.PRNGKey(2))
        _zero()
        eng.run_sweeps(state, jr.PRNGKey(3), 3)
        assert build.launches["flip_lut"] == 0


@pytest.mark.cuda
def test_compact_chain_on_the_card_is_the_cpus(cuda):
    """The ``chain`` scenario (Algorithm 2 on strided blocked views, the
    kernel on contiguous copies) equals the CPU's eager chain."""
    from repro_torch.api import EngineConfig, IsingEngine
    cfg = EngineConfig(size=64, beta=BETA_C, n_sweeps=3, block_size=8,
                       dtype="bfloat16")
    want = IsingEngine(cfg, device="cpu").simulate(4)
    _zero()
    got = IsingEngine(cfg, device=cuda).simulate(4)
    assert build.launches["flip_lut"] == 4 * 3
    assert torch.equal(got.state.cpu(), want.state)
    assert torch.equal(got.magnetization.cpu(), want.magnetization)
