"""The port's stage spans (:mod:`repro_torch.spans`): under a profiler each
stage records its ``repro_torch.*`` range as often as it runs; with none
running no range is entered; either way the outputs are bitwise the same."""
import collections

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import random as jr  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.api import EngineConfig, IsingEngine  # noqa: E402
from repro_torch.cluster import label as LBL  # noqa: E402

SWEEPS = 3
KERNEL = dict(size=32, beta=0.4406868, n_sweeps=SWEEPS, block_size=8,
              backend="pallas", hot=True)
CLUSTER = dict(size=32, beta=0.4406868, n_sweeps=SWEEPS,
               algorithm="swendsen_wang", hot=True)


def _chunk(cfg: dict, measure: bool = True):
    """One chunk of the engine from a state made from seed 0: the result's
    (state, m series, E series)."""
    eng = IsingEngine(EngineConfig(**cfg, measure=measure), device="cpu")
    k_init, k_chain = jr.split(jr.PRNGKey(0))
    res = eng.run(eng.init(k_init), k_chain)
    return res.state, res.magnetization, res.energy


def _profiled(fn):
    """(fn's result, count of each ``repro_torch.`` range it recorded)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    counts = collections.Counter(e.name for e in prof.events()
                                 if e.name.startswith("repro_torch."))
    return out, counts


def _same(a, b):
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("measure", [True, False])
def test_kernel_chunk_records_each_stage(measure):
    """A kernel-backend chunk of n sweeps from a hot start: the start's
    one draw, one block and one unblock copy (the keyed kernels draw
    their own bits); measured, n ``blocked_totals`` and one copy of the
    series to the host. On the CPU ``blocked_totals`` takes the f32 chain
    and its ``nn_white``; on the card the measurement kernel."""
    _, counts = _profiled(lambda: _chunk(KERNEL, measure))
    want = {"repro_torch.random.draws": 1,
            "repro_torch.kernels.block": 1,
            "repro_torch.kernels.unblock": 1}
    if measure:
        want |= {"repro_torch.measure.blocked_totals": SWEEPS,
                 "repro_torch.checkerboard.nn": SWEEPS,
                 "repro_torch.engine.series.sync": 1}
    assert dict(counts) == want


def test_cluster_chunk_records_each_stage():
    """A Swendsen-Wang chunk from a hot start: the start's one draw;
    bonds, labels and coins once a sweep, one label sync an iteration,
    one copy of the series to the host."""
    before = LBL.counters["iterations"]
    _, counts = _profiled(lambda: _chunk(CLUSTER))
    iters = LBL.counters["iterations"] - before
    assert iters >= SWEEPS
    assert dict(counts) == {"repro_torch.random.draws": 1,
                            "repro_torch.cluster.bonds": SWEEPS,
                            "repro_torch.cluster.label": SWEEPS,
                            "repro_torch.cluster.label.sync": iters,
                            "repro_torch.cluster.coins": SWEEPS,
                            "repro_torch.engine.series.sync": 1}


@pytest.mark.parametrize("cfg", [KERNEL, CLUSTER], ids=["kernel", "cluster"])
def test_no_range_without_a_profiler(cfg, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert spans.span("repro_torch.x") is spans.span("repro_torch.y")
    _chunk(cfg)


@pytest.mark.parametrize("cfg", [KERNEL, CLUSTER], ids=["kernel", "cluster"])
def test_outputs_bitwise_under_the_profiler(cfg):
    plain = _chunk(cfg)
    traced, counts = _profiled(lambda: _chunk(cfg))
    assert counts
    _same(traced, plain)


# --- the launcher's default path: eager draws and K-hat neighbour sums -------

GRID_SIZE = 64


def _free_chunk(path: str):
    """One ``run_sweeps`` chunk of SWEEPS sweeps on a 64^2 lattice from a
    fixed +-1 start, no init inside: ``grid``, the simulate launcher's
    default engine (a 1 x 1 grid, the paper pipeline, bf16 uniforms), or
    ``tiles``, the keyed tile kernel."""
    from repro_torch.launch import simulate

    g = torch.Generator().manual_seed(5)
    quads = (torch.randint(0, 2, (4, GRID_SIZE // 2, GRID_SIZE // 2),
                           generator=g) * 2 - 1).to(torch.bfloat16)
    if path == "grid":
        cfg = simulate.build(simulate.parse_args([
            "--mesh", "1,1", "--blocks-per-device", "4", "--block-size", "8",
            "--chunk", str(SWEEPS)]))[0]
        m = GRID_SIZE // 2 // 8      # blocked [4, m, m, 8, 8], as the grid
        state = quads.view(4, m, 8, m, 8).permute(0, 1, 3, 2, 4).contiguous()
    else:
        cfg = EngineConfig(**KERNEL, measure=False)
        state = quads
    eng = IsingEngine(cfg, device="cpu")
    return eng.run_sweeps(state, jr.fold_in(jr.PRNGKey(3), 0), SWEEPS)


@pytest.mark.parametrize("path", ["grid", "tiles"])
def test_draws_and_neighbour_sums_on_the_grid_path_only(path):
    """The grid's colour update draws its uniforms and forms its K-hat sums
    once a colour and flips its two quads' sites once each; the keyed tile
    path draws and flips in its kernel and does none of it."""
    _, counts = _profiled(lambda: _free_chunk(path))
    grid = {"repro_torch.random.draws": 2 * SWEEPS,
            "repro_torch.checkerboard.nn": 2 * SWEEPS,
            "repro_torch.checkerboard.flip": 4 * SWEEPS}
    assert dict(counts) == (grid if path == "grid" else
                            {"repro_torch.kernels.block": 1,
                             "repro_torch.kernels.unblock": 1})


@pytest.mark.parametrize("path", ["grid", "tiles"])
def test_draw_words_count_one_word_a_site_a_sweep(path):
    jr.reset_counters()
    _free_chunk(path)
    want = GRID_SIZE ** 2 * SWEEPS if path == "grid" else 0
    assert jr.counters == {"fold_in_bits_eager": 0, "draw_words": want}


def test_draw_words_of_each_draw():
    """One word an element of ``bits`` and ``uniform``, two of ``randint``;
    a key batch draws a row a key; ``kernel_bits`` counts none."""
    key = jr.PRNGKey(9)
    jr.reset_counters()
    jr.bits(key, (3, 5))
    jr.uniform(key, (7,), torch.bfloat16)
    jr.uniform([key, jr.fold_in(key, 1)], (4,))
    jr.randint(key, (6,), 0, 10)
    jr.kernel_bits(key, (100,))
    assert jr.counters["draw_words"] == 15 + 7 + 2 * 4 + 2 * 6
    assert torch.equal(jr.kernel_bits(key, (3, 5)), jr.bits(key, (3, 5)))


def test_grid_path_enters_no_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    _free_chunk("grid")


def test_grid_path_bitwise_under_the_profiler():
    plain = _free_chunk("grid")
    traced, counts = _profiled(lambda: _free_chunk("grid"))
    assert counts
    assert traced.dtype == plain.dtype and torch.equal(traced, plain)
