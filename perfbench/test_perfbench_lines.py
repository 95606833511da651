"""The halo-line cell ``ising2d-lines-free`` on the CPU: the engine's
``pallas_lines`` chain against the plain reference and bitwise against the
tile form, the control failing the check, the readers of the lines
kernel and of the ``repro_torch.kernels.lines`` span on made-up events,
and the span entered once a colour on the lines path and never on the
tile path."""
from __future__ import annotations

import collections

import pytest
import torch

from perfbench import inputs, trace, work
from perfbench.metrics import lines_kernel_roofline_pct
from perfbench.reference import metropolis
from perfbench.run import Cell, run_cell
from perfbench.trace import Op

BETA_C = 0.4406868
CELL = "ising2d-lines-free"
LINES = "repro_torch.kernels.lines"
KEYED_LINES = ("void ising::half_sweep_vec<__nv_bfloat16, 128, 0, true, "
               "ising::LineHalo<__nv_bfloat16> >(ising::Params<__nv_bfloat16>"
               ", ising::LineHalo<__nv_bfloat16>)")
KEYED_LINES_MANGLED = ("_ZN5ising14half_sweep_vecI13__nv_bfloat16Li128ELi1ELb1"
                       "ENS_8LineHaloIS1_EEEEvNS_6ParamsIT_EET3_")


def _chunk(backend, size, bs, beta, seed, sweeps=3):
    """(input, chunk key, output) of one ``run_sweeps`` chunk of the engine
    from the benchmark's hot start, keyed as the driver keys chunk 2."""
    from repro_torch.api import EngineConfig, IsingEngine

    q = inputs.hot_quads(size, torch.bfloat16, seed, "cpu")
    key = inputs.chunk_key(inputs.chain_key(seed), 2 * sweeps)
    engine = IsingEngine(EngineConfig(
        size=size, beta=beta, n_sweeps=sweeps, backend=backend,
        block_size=bs, measure=False, hot=True), device="cpu")
    return q, key, engine.run_sweeps(q, key, sweeps)


CASES = [(2 ** 33 + 12345, 256, 32, BETA_C),
         (2 ** 31 + 5, 256, 64, BETA_C / 2),
         (4100000007, 512, 64, BETA_C),
         (7, 512, 32, BETA_C / 2)]


@pytest.mark.parametrize("seed, size, bs, beta", CASES)
def test_lines_chain_is_the_reference_and_the_tile_form(seed, size, bs,
                                                         beta):
    sweeps, core = 3, 32
    q, key, out = _chunk("pallas_lines", size, bs, beta, seed, sweeps)
    sampler = inputs.PatchSampler(size, 6, core, 2 * sweeps, seed, "cpu",
                                  slots=3)
    sampler.take_input(0, q, key, sweeps)
    sampler.take_output(out)
    (_, k, n, boxes, origins, cores), = sampler.records()
    got = metropolis.sweep_boxes(boxes, origins, size, bs, k, n, beta)
    assert got.shape == cores.shape and torch.equal(got, cores)
    assert not torch.equal(out, q)
    _, _, tiles = _chunk("pallas", size, bs, beta, seed, sweeps)
    assert torch.equal(out, tiles)


def _small(monkeypatch) -> Cell:
    """The cell at 128^2 in 16^2 tiles, 4 cores of 32^2 a chunk of 3."""
    cell = Cell(CELL)
    cell.config = dict(cell.config, size=128, block_size=16)
    consts = cell.driver.__init__.__globals__
    monkeypatch.setitem(consts, "PATCHES", 4)
    monkeypatch.setitem(consts, "CORE", 32)
    cell.traffic = dict(cell.traffic, chunk_sweeps=3)
    return cell


def test_the_cell_is_the_lines_form_of_ising2d_free():
    cell, tiles = Cell(CELL), Cell("ising2d-free")
    assert cell.config["backend"] == "pallas_lines"
    assert tiles.config["backend"] == "pallas"
    same = ("size", "block_size", "dtype", "algorithm", "accept", "driver",
            "reduced", "guarantees", "limits")
    assert {k: cell.config[k] for k in same} == \
        {k: tiles.config[k] for k in same}
    assert cell.traffic == tiles.traffic
    assert {m["name"] for m in cell.per_layer} == {
        "sweep_mfu_pct", "device_idle_pct", "lines_kernel_roofline_pct",
        "halo_lines_ms_per_sweep"}


def test_the_program_passes_and_the_control_fails(monkeypatch):
    out = run_cell(_small(monkeypatch), 2 ** 31 + 77, 0.0, False, "cpu",
                   control="bfloat16")
    line = out["line"]
    assert line["correct"] and line["failed"] == 0, line["checks"]
    control = {n: v for n, v, _ in out["control"]}
    assert control["spin_mismatch"] > 0, out["control"]


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_a_planted_lines_fault_is_not_correct(kind, monkeypatch):
    from repro_torch.kernels import checkerboard as kern
    from repro_torch.kernels import ops

    update = kern.update_color_lines_keyed

    def broken(qb, *args, **kw):
        if kind == "unchanged":
            return qb
        qb = update(qb, *args, **kw)
        qb[1, :, :, -1, 0] *= -1        # one spin of every tile's edge
        return qb
    monkeypatch.setitem(ops._KEYED, "pallas_lines", broken)
    line = run_cell(_small(monkeypatch), 2 ** 31 + 77, 0.0, False,
                    "cpu")["line"]
    assert not line["correct"] and line["failed"] > 0, line["checks"]


# --- the readers on made-up events -----------------------------------------


def _window(host, device, sweeps=2):
    return trace.window(device, [Op(trace.WINDOW, 0.0, 10.0),
                                 Op(trace.CHUNK, 0.0, 9.5)] + host,
                        seconds=10.0, sweeps=sweeps, sites=64,
                        config={"algorithm": "metropolis"}, counters={})


def _lines_sweep():
    """Per colour: the lines span with two launches, then a keyed lines
    launch outside it; a tile launch and a copy outside every span."""
    host = [Op(LINES, 0.1, 0.4), Op("cudaLaunchKernel", 0.15, 0.16, corr=1),
            Op("cudaLaunchKernel", 0.2, 0.21, corr=2),
            Op("cudaLaunchKernel", 0.5, 0.51, corr=3),
            Op(LINES, 3.0, 3.3), Op("cudaLaunchKernel", 3.1, 3.11, corr=4),
            Op("cudaLaunchKernel", 3.4, 3.41, corr=5),
            Op("cudaLaunchKernel", 6.0, 6.01, corr=6)]
    device = [Op("roll", 0.2, 0.3, corr=1), Op("copy", 0.3, 0.35, corr=2),
              Op(KEYED_LINES, 0.6, 2.6, corr=3),
              Op("roll", 3.15, 3.3, corr=4),
              Op(KEYED_LINES_MANGLED, 3.4, 6.4, corr=5),
              Op(KEYED_LINES.replace("LineHalo", "TileHalo"), 6.4, 7.0,
                 corr=6)]
    return _window(host, device)


def test_readers_of_the_lines_cell():
    readers = Cell(CELL).readers
    w = _lines_sweep()
    assert readers["halo_lines_ms_per_sweep"](w) == \
        pytest.approx(1e3 * (0.1 + 0.05 + 0.15) / 2)
    assert readers["lines_kernel_roofline_pct"](w) == \
        pytest.approx(100 * work.colour_bound_s(64) / 2.5)


@pytest.mark.parametrize("name", ["halo_lines_ms_per_sweep",
                                  "lines_kernel_roofline_pct"])
def test_readers_find_nothing_on_the_tile_path(name):
    """The tile path (and the parent program) has neither the span nor a
    keyed lines launch."""
    host = [Op("repro_torch.kernels.block", 0.1, 0.2),
            Op("cudaLaunchKernel", 0.15, 0.16, corr=1),
            Op("cudaLaunchKernel", 0.5, 0.51, corr=2)]
    device = [Op("copy", 0.2, 0.3, corr=1),
              Op(KEYED_LINES.replace("LineHalo", "TileHalo"), 0.6, 2.6,
                 corr=2)]
    assert Cell(CELL).readers[name](_window(host, device)) is None


def test_the_launch_patterns_tell_the_halo_forms_apart():
    is_lines = lines_kernel_roofline_pct.is_keyed_lines_launch
    tile = KEYED_LINES.replace("LineHalo", "TileHalo")
    tile_mangled = KEYED_LINES_MANGLED.replace("8LineHalo", "8TileHalo")
    assert is_lines(KEYED_LINES) and is_lines(KEYED_LINES_MANGLED)
    assert not is_lines(tile) and not is_lines(tile_mangled)
    assert not is_lines(KEYED_LINES.replace(", true,", ", false,"))
    assert not is_lines(KEYED_LINES_MANGLED.replace("Lb1E", "Lb0E"))
    assert work.is_keyed_tile_launch(tile)
    assert work.is_keyed_tile_launch(tile_mangled)
    assert not work.is_keyed_tile_launch(KEYED_LINES)
    assert not work.is_keyed_tile_launch(KEYED_LINES_MANGLED)


# --- the span in the program -----------------------------------------------


def _ranges(fn) -> dict:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return dict(collections.Counter(e.name for e in prof.events()
                                    if e.name.startswith("repro_torch.")))


@pytest.mark.parametrize("form", ["update_color_lines_keyed",
                                  "update_color_tiles_keyed"])
def test_the_lines_span_is_entered_on_the_lines_path_only(form):
    from repro_torch.kernels import checkerboard as kern
    from repro_torch.kernels import ops

    qb = ops._block_quads(inputs.hot_quads(64, torch.bfloat16, 11, "cpu"), 8)
    counts = _ranges(lambda: getattr(kern, form)(qb, (3, 5), BETA_C, 1))
    assert counts == ({LINES: 1} if form == "update_color_lines_keyed"
                      else {})


def test_no_lines_range_without_a_profiler(monkeypatch):
    from repro_torch.kernels import checkerboard as kern

    def refuse(name):
        raise AssertionError(f"a range {name!r} with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    qb = torch.ones(4, 2, 2, 8, 8, dtype=torch.bfloat16)
    kern.update_color_lines_keyed(qb, (1, 2), BETA_C, 0)
