"""The check that decides ``correct``, driven through a whole run of each
cell at a test size on the CPU (the look for a chip skipped): the program
passes it, the control (the reference at the precision below the stated
one, in the program's place) fails it, and so does the program with each
fault a cell can have planted underneath the timed path. One chip runs
each cell, so no cell has an exchange between chips to leave out."""
from __future__ import annotations

import pytest
import torch

from perfbench.run import Cell, run_cell

SEED = 2 ** 31 + 77
CELLS = ["ising2d-free", "ising2d-measured", "sw-near-critical", "sw-hot"]


def small(name: str, monkeypatch) -> Cell:
    """The cell at a size a test can hold: 128^2 in 16^2 tiles (32^2
    cores, 4 a chunk) or 64^2, chunks of 3 sweeps."""
    cell = Cell(name)
    if cell.config["driver"] == "ising_checkerboard":
        cell.config = dict(cell.config, size=128, block_size=16)
        consts = cell.driver.__init__.__globals__
        monkeypatch.setitem(consts, "PATCHES", 4)
        monkeypatch.setitem(consts, "CORE", 32)
    else:
        cell.config = dict(cell.config, size=64)
    cell.traffic = dict(cell.traffic, chunk_sweeps=3)
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_the_program_passes_and_the_control_fails(name, monkeypatch):
    out = run_cell(small(name, monkeypatch), SEED, 0.0, False, "cpu",
                   control="bfloat16")
    line = out["line"]
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert list(line)[-1] == "checks"
    assert any(v > lim for _, v, lim in out["control"]), out["control"]


def _kernel_fault(kind):
    from repro_torch.kernels import ops

    sweep = ops.sweep_blocked

    def broken(qb, *args, **kw):
        if kind == "unchanged":
            return qb
        if kind == "half":       # half the lattice swept as if the whole
            h = qb.shape[1] // 2
            qb[:, :h] = sweep(qb[:, :h].contiguous(), *args, **kw)
            return qb
        qb = sweep(qb, *args, **kw)
        qb[0, :, :, 0, 0] *= -1     # one spin of every tile altered
        return qb
    return ops, "sweep_blocked", broken


def _kernel_stats_fault():
    from repro_torch.core import measure

    stats = measure.blocked_stats
    return measure, "blocked_stats", \
        lambda qb, *a, **k: stats(qb[:, :qb.shape[1] // 2], *a, **k)


def _cluster_fault(kind):
    from repro_torch.cluster import sweep as csweep

    if kind == "half":          # (m, E) of half the lattice
        stats = csweep.full_stats
        return csweep, "full_stats", \
            lambda full: stats(full[..., :full.shape[-2] // 2, :])
    sweep = csweep.cluster_sweep

    def broken(full, *args, **kw):
        if kind == "unchanged":
            return full
        out = sweep(full, *args, **kw).clone()
        out[..., 0, 0] *= -1
        return out
    return csweep, "cluster_sweep", broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, kind, monkeypatch):
    cell = small(name, monkeypatch)
    if cell.config["driver"] == "ising_swendsen_wang":
        target = _cluster_fault(kind)
    elif kind == "half" and cell.traffic["measure"]:
        target = _kernel_stats_fault()
    else:
        target = _kernel_fault(kind)
    monkeypatch.setattr(*target)
    line = run_cell(cell, SEED, 0.0, False, "cpu")["line"]
    assert not line["correct"] and line["failed"] > 0, line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_cells_run_on_the_card(name, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    line = run_cell(small(name, monkeypatch), SEED, 0.5, True, "cuda")["line"]
    assert line["correct"] and line["device"]["busy_s"] > 0
