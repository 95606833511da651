"""The launcher's default path, cell ``ising2d-simulate-xla``, on the CPU:
the engine ``launch.simulate`` builds (a 1 x 1 grid, the paper pipeline,
bf16 uniforms) against the plain reference over sampled boxes and the
whole lattice, the control and a planted fault failing the check, the
reference's uniforms against the counter bits and the program's draw, and
the readers of the draws and neighbour-sum spans on made-up events."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

from perfbench import trace, work
from perfbench.metrics import draw_roofline_pct
from perfbench.reference import paper_metropolis, threefry
from perfbench.run import Cell, run_cell
from perfbench.trace import Op

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
from torch_threads import one_torch_thread  # noqa: E402,F401

CELL = "ising2d-simulate-xla"
DRAWS, NN = "repro_torch.random.draws", "repro_torch.checkerboard.nn"
CONTROL = "float8_e4m3fn"


def _small(monkeypatch, size=256, bs=16, sweeps=3) -> Cell:
    """The cell at ``size``^2 in ``bs``^2 tiles, 4 cores of 32^2 a chunk
    of ``sweeps``."""
    cell = Cell(CELL)
    cell.config = dict(cell.config, size=size, block_size=bs)
    consts = cell.driver.__init__.__globals__
    monkeypatch.setitem(consts, "PATCHES", 4)
    monkeypatch.setitem(consts, "CORE", 32)
    cell.traffic = dict(cell.traffic, chunk_sweeps=sweeps)
    return cell


def _driver(cell, seed, chunks=3):
    d = cell.driver(cell.config, cell.traffic, seed, "cpu")
    d.setup()
    for _ in range(chunks - 1):
        d.chunk()
    return d


@pytest.mark.parametrize("seed, size, bs", [(2 ** 33 + 12345, 256, 16),
                                            (4100000007, 128, 32)])
def test_launcher_chunks_are_the_reference(seed, size, bs, monkeypatch):
    """Three chunks of 3 sweeps: no sampled site differs, the stats hold
    to the exact sums, and a fourth chunk equals the reference over the
    whole lattice."""
    cell = _small(monkeypatch, size, bs)
    d = _driver(cell, seed)
    readings, checked, wrong = d.check()
    assert checked == 3 and wrong == 0, readings
    assert all(v <= lim for _, v, lim in readings), readings
    assert dict((n, v) for n, v, _ in readings)["spin_mismatch"] == 0
    assert d.whole_mismatch(band_rows=48) == (0, size * size)


def test_the_driver_builds_the_launchers_engine(monkeypatch):
    cell = _small(monkeypatch)
    eng = cell.driver(cell.config, cell.traffic, 7, "cpu").engine
    c = eng.cfg
    assert (c.topology, c.mesh_shape, c.backend, c.pipeline, c.prob_dtype,
            c.dtype, c.block_size, c.n_sweeps) == \
        ("mesh", (1, 1), "xla", "paper", "bfloat16", "bfloat16", 16, 3)
    assert eng._scenario() == "mesh"
    assert c.beta == pytest.approx(cell.traffic["beta"], abs=1e-6)


def test_the_control_fails_on_spins_and_stats(monkeypatch):
    d = _driver(_small(monkeypatch), 2 ** 31 + 77)
    control = {n: (v, lim) for n, v, lim in d.check(CONTROL)[0]}
    assert all(v > lim for v, lim in control.values()), control


def test_run_cell_is_correct_and_the_control_is_not(monkeypatch):
    out = run_cell(_small(monkeypatch), 2 ** 31 + 77, 0.0, False, "cpu",
                   control=CONTROL)
    line = out["line"]
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert set(line["checks"]) == {"spin_mismatch", "m_gap", "e_gap"}
    assert set(line["metrics"]) == {"flips_per_ns", "peak_mem_gib",
                                    "setup_s"}
    assert any(v > lim for _, v, lim in out["control"]), out["control"]


@pytest.mark.parametrize("kind", ["unchanged", "one_spin"])
def test_a_planted_colour_fault_is_not_correct(kind, monkeypatch):
    from repro_torch.distributed import ising as dising

    update = dising._local_color_update

    def broken(qb, key, step, color, cfg, edges, return_stats=False):
        if kind == "unchanged":
            return qb
        qb = update(qb, key, step, color, cfg, edges, return_stats)
        qb[0, :, :, 5, 7] *= -1         # one spin of every tile
        return qb
    monkeypatch.setattr(dising, "_local_color_update", broken)
    line = run_cell(_small(monkeypatch), 2 ** 31 + 77, 0.0, False,
                    "cpu")["line"]
    assert not line["correct"] and line["failed"] > 0, line["checks"]


def test_the_driver_reads_no_counter_the_program_lacks(monkeypatch):
    from repro_torch import random as jr

    cell = _small(monkeypatch)
    d = cell.driver(cell.config, cell.traffic, 7, "cpu")
    monkeypatch.setattr(jr, "counters", {"fold_in_bits_eager": 0})
    assert d.counters() == {}


# --- the reference's uniforms ----------------------------------------------


KEYS = [(0, 0), (0, 42), (0x12345678, 0x9ABCDEF0)]
COUNTERS = [0, 1, 2, 255, 2 ** 31 + 3, 2 ** 32 - 1, 2 ** 32 + 5]


@pytest.mark.parametrize("key", KEYS)
def test_reference_uniforms_by_hand(key):
    """u = ((bits & 0xFF) >> 1) / 128 of the counter's 32-bit draw, the
    draw x0 ^ x1 of the host threefry of (n >> 32, n & 0xffffffff)."""
    n = torch.tensor(COUNTERS, dtype=torch.int64)
    got = paper_metropolis.uniforms(threefry.counter_bits(key, n))
    for c, u in zip(COUNTERS, got.tolist()):
        x0, x1 = threefry.threefry_host(key, c >> 32, c & 0xFFFFFFFF)
        assert u == ((x0 ^ x1) & 0xFF) // 2 / 128.0
    e4m3 = paper_metropolis.uniforms(threefry.counter_bits(key, n), CONTROL)
    assert e4m3.tolist() == [((x & 0xFF) >> 5) / 8.0 for x in
                             threefry.counter_bits(key, n).tolist()]


@pytest.mark.parametrize("key", KEYS)
def test_reference_uniforms_are_the_programs_draw(key):
    from repro_torch import random as jr

    shape = (2, 3, 2, 4, 4)
    want = jr.uniform(key, shape, torch.bfloat16).double().reshape(-1)
    n = torch.arange(want.numel(), dtype=torch.int64)
    assert torch.equal(paper_metropolis.uniforms(
        threefry.counter_bits(key, n)), want)


def test_reference_acceptance_is_the_programs_table():
    from repro_torch.core import update_rules

    beta = 0.44068679350977147
    acc = update_rules.acceptance_table(beta, torch.bfloat16).double()
    tab = paper_metropolis.table(beta)
    assert (tab[2], tab[4]) == (acc[3].item(), acc[4].item())
    assert paper_metropolis.table(beta, CONTROL)[2] != tab[2] or \
        paper_metropolis.table(beta, CONTROL)[4] != tab[4]


# --- the readers on made-up events -----------------------------------------


def _window(host, device, words=None, sweeps=2):
    counters = {} if words is None else {"draw_words": words}
    return trace.window(device, [Op(trace.WINDOW, 0.0, 10.0),
                                 Op(trace.CHUNK, 0.0, 9.5)] + host,
                        seconds=10.0, sweeps=sweeps, sites=64,
                        config={"algorithm": "metropolis",
                                "prob_dtype": "bfloat16"},
                        counters=counters)


def _sweep_events():
    """A colour: the draws span with two launches, the nn span with one,
    and a flip launch outside both."""
    host = [Op(DRAWS, 0.1, 0.4), Op("cudaLaunchKernel", 0.15, 0.16, corr=1),
            Op("cudaLaunchKernel", 0.2, 0.21, corr=2),
            Op(NN, 0.5, 0.6), Op("cudaLaunchKernel", 0.55, 0.56, corr=3),
            Op("cudaLaunchKernel", 0.7, 0.71, corr=4)]
    device = [Op("arange", 0.2, 1.2, corr=1), Op("xor", 1.2, 3.2, corr=2),
              Op("bmm", 3.2, 3.5, corr=3), Op("where", 3.5, 3.6, corr=4)]
    return host, device


def test_readers_of_the_simulate_cell():
    readers = Cell(CELL).readers
    host, device = _sweep_events()
    w = _window(host, device, words=10 ** 9)
    assert readers["draws_ms_per_sweep"](w) == pytest.approx(1e3 * 3.0 / 2)
    assert readers["nn_sums_ms_per_sweep"](w) == pytest.approx(1e3 * 0.3 / 2)
    bound = draw_roofline_pct.draw_bound_s(10 ** 9, 2)
    assert readers["draw_roofline_pct"](w) == pytest.approx(100 * bound / 3)


def test_the_draw_bound_counts_one_hash_a_word():
    """41 integer-only instructions a hash at 64 a clock bind before the
    68 issue slots at 128; bf16 words are 2 bytes."""
    words = 4 * 10 ** 8
    clocks = max(41 / work.INT_PER_CLOCK, 68 / work.ISSUE_PER_CLOCK)
    ops = words * clocks / (work.SM_CLOCK_HZ * work.SMS)
    assert draw_roofline_pct.word_clocks() == 41 / 64
    assert draw_roofline_pct.draw_bound_s(words, 2) == pytest.approx(ops)
    assert ops > words * 2 / work.HBM_BYTES_PER_S


@pytest.mark.parametrize("name", ["draws_ms_per_sweep", "draw_roofline_pct",
                                  "nn_sums_ms_per_sweep"])
def test_readers_find_nothing_without_their_spans(name):
    """The parent program has neither span nor the counter."""
    host = [Op("cudaLaunchKernel", 0.15, 0.16, corr=1)]
    device = [Op("bmm", 0.2, 0.3, corr=1)]
    assert Cell(CELL).readers[name](_window(host, device)) is None


def test_the_roofline_reads_nothing_without_the_counter():
    host, device = _sweep_events()
    assert Cell(CELL).readers["draw_roofline_pct"](
        _window(host, device)) is None


def test_the_cell_loads_its_files():
    cell = Cell(CELL)
    assert cell.config["name"] == "ising-160x128-xla"
    assert cell.config["driver"] == "ising_simulate"
    assert (cell.config["size"], cell.config["block_size"]) == (20480, 128)
    assert cell.traffic == {"beta": 0.4406868, "temperature_ratio": 1.0,
                            "chunk_sweeps": 10, "measure": False}
    assert {m["name"] for m in cell.end_to_end} == {
        "flips_per_ns", "peak_mem_gib", "setup_s"}
    assert set(cell.readers) == {
        "sweep_mfu_pct", "device_idle_pct", "draws_ms_per_sweep",
        "draw_roofline_pct", "nn_sums_ms_per_sweep"}
