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
    """A kernel-backend chunk of n sweeps: one block and one unblock
    copy; measured, n ``blocked_totals`` and one copy of the series to
    the host."""
    _, counts = _profiled(lambda: _chunk(KERNEL, measure))
    want = {"repro_torch.kernels.block": 1,
            "repro_torch.kernels.unblock": 1}
    if measure:
        want |= {"repro_torch.measure.blocked_totals": SWEEPS,
                 "repro_torch.engine.series.sync": 1}
    assert dict(counts) == want


def test_cluster_chunk_records_each_stage():
    """A Swendsen-Wang chunk: bonds, labels and coins once a sweep, one
    label sync an iteration, one copy of the series to the host."""
    before = LBL.counters["iterations"]
    _, counts = _profiled(lambda: _chunk(CLUSTER))
    iters = LBL.counters["iterations"] - before
    assert iters >= SWEEPS
    assert dict(counts) == {"repro_torch.cluster.bonds": SWEEPS,
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
