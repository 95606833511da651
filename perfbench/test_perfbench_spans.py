"""The program's spans read on made-up events: device time by the span its
launch fell in, matched only through CUDA launch calls, and idle gaps by
the span open when they began; each reader of them."""
from __future__ import annotations

import pytest

from perfbench import spans, trace
from perfbench.run import Cell
from perfbench.trace import Op

LABEL, SYNC = "repro_torch.cluster.label", "repro_torch.cluster.label.sync"
BONDS, COINS = "repro_torch.cluster.bonds", "repro_torch.cluster.coins"
BLOCK, UNBLOCK = "repro_torch.kernels.block", "repro_torch.kernels.unblock"
TOTALS = "repro_torch.measure.blocked_totals"
NEW = ("relayout_pct", "blocked_stats_ms_per_sweep", "label_ms_per_sweep",
       "bond_coin_ms_per_sweep", "sync_idle_pct")


def _window(host, device, sweeps=2):
    return trace.window(device, [Op(trace.WINDOW, 0.0, 10.0),
                                 Op(trace.CHUNK, 0.0, 9.5)] + host,
                        seconds=10.0, sweeps=sweeps, sites=64,
                        config={}, counters={})


def _cluster():
    """Bonds, then labels with one sync, then coins; an aten op inside the
    labels shares its id with a kernel launched outside every span."""
    host = [Op(BONDS, 0.2, 0.9), Op("cudaLaunchKernel", 0.3, 0.31, corr=14),
            Op(LABEL, 1.0, 5.0),
            Op("cudaLaunchKernel", 1.1, 1.11, corr=10),
            Op(SYNC, 2.0, 3.0),
            Op("cudaMemcpyAsync", 2.1, 2.9, corr=11),
            Op("aten::roll", 4.0, 4.1, corr=12),
            Op(COINS, 5.2, 5.5), Op("cudaLaunchKernel", 5.25, 5.26, corr=15),
            Op("cudaLaunchKernel", 6.2, 6.21, corr=12)]
    device = [Op("bond_hash", 0.4, 0.95, corr=14),
              Op("minimum", 1.2, 1.8, corr=10),
              Op("Memcpy DtoH", 2.3, 2.4, corr=11),
              Op("coin_hash", 5.3, 5.6, corr=15),
              Op("roll_outside", 6.3, 6.5, corr=12)]
    return _window(host, device)


def _read(name, w):
    for cell in ("ising2d-measured", "sw-near-critical"):
        readers = Cell(cell).readers
        if name in readers:
            return readers[name](w)
    raise KeyError(name)


def test_a_launch_inside_a_nested_span_counts_for_its_parents():
    w = _cluster()
    assert spans.launched_seconds(w, (SYNC,)) == pytest.approx(0.1)
    assert spans.launched_seconds(w, (LABEL,)) == pytest.approx(0.6 + 0.1)


def test_aten_ids_do_not_pull_kernels_in():
    """The aten op with id 12 lies inside the labels; kernel 12's launch
    does not, so the kernel is no label work."""
    w = _cluster()
    assert "roll_outside" in [o.name for o in w.ops]
    assert spans.launched_seconds(w, (LABEL,)) == pytest.approx(0.7)


def test_launches_outside_every_span_are_not_counted():
    w = _cluster()
    total = sum(spans.launched_seconds(w, (n,)) for n in (BONDS, LABEL,
                                                          COINS))
    assert total == pytest.approx(0.55 + 0.7 + 0.3)
    assert total < sum(o.seconds for o in w.ops)
    assert spans.launched_seconds(w, (BLOCK,)) is None


def test_a_program_op_filed_with_the_harness_still_counts():
    """An aten op of a sample shares its id with a kernel that the labels
    launched: the window files the kernel with the harness's ops, its
    launch still puts it in the labels."""
    w = _window([Op(LABEL, 1.0, 2.0),
                 Op("cudaLaunchKernel", 1.1, 1.11, corr=7),
                 Op(trace.SAMPLE, 3.0, 4.0), Op("aten::index", 3.1, 3.2,
                                                  corr=7)],
                [Op("minimum", 1.2, 1.5, corr=7)])
    assert [o.name for o in w.harness_ops] == ["minimum"]
    assert spans.launched_seconds(w, (LABEL,)) == pytest.approx(0.3)


def test_cluster_readers():
    w = _cluster()
    assert _read("label_ms_per_sweep", w) == pytest.approx(1e3 * 0.7 / 2)
    assert _read("bond_coin_ms_per_sweep", w) == \
        pytest.approx(1e3 * 0.85 / 2)
    # gaps: [1.8, 2.3) in the labels, [2.4, 5.3) from inside the sync;
    # [0, 0.4), [0.95, 1.2), [5.6, 6.3) and [6.5, 10) outside every span
    idle = spans.idle_by_span(w)
    assert idle == {SYNC: pytest.approx(5.3 - 2.4),
                    LABEL: pytest.approx(0.5),
                    None: pytest.approx(0.4 + 0.25 + 0.7 + 3.5)}
    assert _read("sync_idle_pct", w) == pytest.approx(100 * 2.9 / 10)


def test_a_gap_is_charged_to_the_span_open_at_its_start():
    """The gap from 1.5 to 3.0 begins inside the sync span; at its
    midpoint only the label span is open."""
    host = [Op(LABEL, 0.5, 4.0), Op(SYNC, 1.0, 2.0)]
    device = [Op("a", 0.0, 1.5), Op("b", 3.0, 10.0)]
    w = _window(host, device)
    assert spans.idle_by_span(w) == {SYNC: pytest.approx(1.5)}
    assert _read("sync_idle_pct", w) == pytest.approx(15.0)
    assert trace.HostIndex(w.host).at(2.25) == LABEL


def test_innermost_follows_nesting():
    outer, a, b = Op("o", 0, 10), Op("a", 1, 2), Op("b", 3, 4)
    got = spans._innermost([b, outer, a], [0.5, 1.5, 2.5, 3.5, 10.5])
    assert got == ["o", "a", "o", "b", None]


def test_kernel_path_readers():
    host = [Op(BLOCK, 0.1, 0.2), Op("cudaLaunchKernel", 0.11, 0.12, corr=1),
            Op(TOTALS, 1.0, 1.5), Op("cudaLaunchKernel", 1.1, 1.11, corr=2),
            Op(UNBLOCK, 8.0, 8.5), Op("cudaLaunchKernel", 8.1, 8.11, corr=3),
            Op("cudaLaunchKernel", 8.2, 8.21, corr=4)]
    device = [Op("copy", 0.2, 0.5, corr=1), Op("nn_white", 1.2, 2.0, corr=2),
              Op("copy", 8.2, 8.4, corr=3), Op("copy", 8.4, 8.6, corr=4)]
    w = _window(host, device)
    assert _read("relayout_pct", w) == pytest.approx(100 * 0.7 / 10)
    assert _read("blocked_stats_ms_per_sweep", w) == \
        pytest.approx(1e3 * 0.8 / 2)
    assert _read("sync_idle_pct", w) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_their_spans(name):
    """The parent program has no spans: only the harness's own."""
    device = [Op("kernel", 1.0, 2.0, corr=1)]
    host = [Op("cudaLaunchKernel", 0.5, 0.51, corr=1)]
    assert _read(name, _window(host, device)) is None
