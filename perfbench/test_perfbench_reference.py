"""The plain reference against the program's own plain paths on the CPU,
from the same inputs: threefry, the checkerboard chain (its kernel
backends' plain versions and ``ref``), the exact sums, and Swendsen-Wang."""
from __future__ import annotations

import pytest
import torch

from perfbench import inputs
from perfbench.reference import metropolis, sums, threefry
from perfbench.reference import swendsen_wang as sw

BETA_C = 0.4406868
SEED = 2 ** 33 + 12345          # wider than 32 bits, as the check's seeds


def test_threefry_is_the_programs():
    from repro_torch import random as jr

    key = inputs.chain_key(SEED)
    assert threefry.fold_in(key, 77) == jr.fold_in(key, 77)
    for start in (0, (1 << 32) - 3):
        n = torch.arange(start, start + 8, dtype=torch.int64)
        want = jr._bits_lanes(key, start, start + 8, "cpu")
        assert torch.equal(threefry.counter_bits(key, n), want)
    c = torch.arange(-4, 60, dtype=torch.int32)
    assert torch.equal(threefry.fold_in_word(key, c),
                       jr.fold_in_bits(key, c).to(torch.int64) & 0xFFFFFFFF)


@pytest.mark.parametrize("backend", ["pallas", "ref"])
def test_metropolis_boxes_are_the_programs_chain(backend):
    from repro_torch.api import EngineConfig, IsingEngine

    size, bs, sweeps, core = 128, 16, 3, 24
    q = inputs.hot_quads(size, torch.bfloat16, SEED, "cpu")
    key = inputs.chunk_key(inputs.chain_key(SEED), 50)
    engine = IsingEngine(EngineConfig(
        size=size, beta=BETA_C, n_sweeps=sweeps, backend=backend,
        block_size=bs, measure=False, hot=True), device="cpu")
    out = engine.run_sweeps(q, key, sweeps)
    sampler = inputs.PatchSampler(size, 6, core, 2 * sweeps, SEED, "cpu",
                                  slots=3)
    sampler.take_input(0, q, key, sweeps)
    sampler.take_output(out)
    (_, k, n, boxes, origins, cores), = sampler.records()
    assert origins[0].tolist() == [(size - core // 2 - 2 * sweeps) % size] * 2
    got = metropolis.sweep_boxes(boxes, origins, size, bs, k, n, BETA_C)
    assert got.shape == cores.shape and torch.equal(got, cores)
    low = metropolis.sweep_boxes(boxes, origins, size, bs, k, n, BETA_C,
                                 "bfloat16")
    assert not torch.equal(low, cores)


def test_exact_sums_and_layouts_are_the_programs():
    from repro_torch.core import lattice, measure
    from repro_torch.kernels import ops

    q = inputs.hot_quads(64, torch.bfloat16, SEED, "cpu")
    full = sums.to_full(q)
    assert torch.equal(full, lattice.from_quads(q))
    assert torch.equal(sums.to_quads(full), q)
    m, e = measure.blocked_stats(ops._block_quads(q, 16))
    want_m, want_e = sums.m_e(q)
    assert float(m) == want_m and float(e) == pytest.approx(want_e,
                                                            abs=1e-7)
    assert sums.totals(q) == sums.totals(q, block_rows=3)


@pytest.mark.parametrize("beta", [BETA_C, BETA_C / 2])
def test_swendsen_wang_is_the_programs(beta):
    from repro_torch.api import EngineConfig, IsingEngine

    size, sweeps = 64, 3
    q = inputs.hot_quads(size, torch.bfloat16, SEED, "cpu")
    key = inputs.chunk_key(inputs.chain_key(SEED), 10)
    res = IsingEngine(EngineConfig(
        size=size, beta=beta, n_sweeps=sweeps, algorithm="swendsen_wang",
        measure=True, hot=True), device="cpu").run(q, key)
    full = sums.to_full(q)
    t = sw.threshold(beta)
    for step in range(sweeps):
        full = sw.sweep(full, threefry.fold_in(key, step), t)
        m, e = sums.m_e(sums.to_quads(full))
        assert float(res.magnetization[step]) == pytest.approx(m, abs=1e-7)
        assert float(res.energy[step]) == pytest.approx(e, abs=1e-7)
    assert torch.equal(sums.to_quads(full), res.state)
    assert sw.threshold(beta, "bfloat16") != t


def test_components_are_the_programs_labels():
    from repro_torch.cluster import label

    gen = torch.Generator().manual_seed(SEED % (1 << 63))
    right = torch.rand((48, 40), generator=gen) < 0.55
    down = torch.rand((48, 40), generator=gen) < 0.55
    want = label.label_components(right, down)
    assert torch.equal(sw.components(right, down), want.to(torch.int64))
