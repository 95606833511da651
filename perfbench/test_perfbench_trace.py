"""The traced window's arithmetic on made-up events: busy time, idle gaps
and what the host was doing in them, the harness's own operations kept
apart, and each per-layer reader."""
from __future__ import annotations

import pytest

from perfbench import trace
from perfbench.run import Cell
from perfbench.trace import Op

KEYED = ("void ising::half_sweep_vec<__nv_bfloat16, 128, 0, true, "
         "ising::TileHalo<__nv_bfloat16> >(x)")


def _window(counters=None, sweeps=2, config=None):
    host = [Op(trace.WINDOW, 0.0, 10.0), Op(trace.CHUNK, 0.1, 9.0),
            Op("aten::item", 4.0, 6.0),
            Op("cudaLaunchKernel", 0.2, 0.21, corr=1),
            Op("cudaLaunchKernel", 0.3, 0.31, corr=2),
            Op(trace.SAMPLE, 8.0, 8.5),
            Op("cudaLaunchKernel", 8.1, 8.11, corr=3)]
    device = [Op(KEYED, 1.0, 3.0, corr=1), Op("reduce_kernel", 2.5, 4.0,
                                                corr=2),
              Op("index_kernel", 8.6, 8.7, corr=3),
              Op("outside", 11.0, 12.0, corr=4)]
    return trace.window(device, host, seconds=10.0, sweeps=sweeps,
                        sites=81920 ** 2,
                        config=config or {"algorithm": "metropolis"},
                        counters=counters or {})


def test_busy_and_gaps():
    w = _window()
    assert [o.name for o in w.harness_ops] == ["index_kernel"]
    assert [o.name for o in w.ops] == [KEYED, "reduce_kernel"]
    assert w.busy_seconds() == pytest.approx(3.1)
    gaps = trace.idle_gaps(w.ops + w.harness_ops, w.t0, w.t1)
    assert gaps == [(0.0, 1.0), (4.0, 8.6), (8.7, 10.0)]
    bd = w.breakdown()
    assert bd["device_ops"][0] == [KEYED, 2.0]
    names = dict((k, v) for k, v in bd["idle_gaps"])
    assert names["perfbench.chunk"] == pytest.approx(1.0 + 4.6)
    assert names["perfbench.window"] == pytest.approx(1.3)
    assert sum(names.values()) == pytest.approx(10.0 - 3.1)


def test_host_index_finds_the_innermost_op():
    idx = trace.HostIndex([Op(trace.CHUNK, 0, 10), Op("aten::a", 1, 5),
                           Op("aten::b", 2, 3)])
    assert idx.at(2.5) == "aten::b"
    assert idx.at(4) == "aten::a"
    assert idx.at(7) == trace.CHUNK
    assert idx.at(11) == "host"


def _read(name, w):
    return Cell("ising2d-free").readers.get(name) or \
        Cell("sw-near-critical").readers[name]


def test_readers():
    w = _window()
    roof = _read("kernel_roofline_pct", w)(w)
    assert roof == pytest.approx(100 * 8.425197e-3 / 2.0, rel=1e-6)
    mfu = _read("sweep_mfu_pct", w)(w)
    assert mfu == pytest.approx(100 * 16.850395e-3 / 5.0, rel=1e-6)
    assert _read("device_idle_pct", w)(w) == pytest.approx(69.0)
    assert Cell("sw-hot").readers["device_idle_pct.cluster"](w) == \
        pytest.approx(69.0)
    stats = Cell("ising2d-measured").readers["stats_ms_per_sweep"]
    assert stats(w) == pytest.approx(1e3 * 1.5 / 2)
    assert _read("label_iters_per_sweep", w)(w) is None
    w = _window(counters={"label_iterations": 130}, sweeps=2,
                config={"algorithm": "swendsen_wang"})
    assert _read("label_iters_per_sweep", w)(w) == 65
    assert _read("sweep_mfu_pct", w)(w) is None


def test_readers_find_nothing_in_an_empty_window():
    w = trace.window([], [Op(trace.WINDOW, 0.0, 1.0)], seconds=1.0,
                     sweeps=0, sites=4, config={}, counters={})
    for cell in ("ising2d-measured", "sw-near-critical"):
        for read in Cell(cell).readers.values():
            assert read(w) is None
