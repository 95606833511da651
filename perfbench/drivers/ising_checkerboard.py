"""Checkerboard Metropolis chains through ``repro_torch.api.IsingEngine``.

One chunk is ``chunk_sweeps`` sweeps keyed ``fold_in(key, done)``, as the
program's launcher keys them: ``IsingEngine.run_sweeps`` when the traffic
does not measure, ``IsingEngine.run`` with ``measure=True`` (the per-sweep
(m, E) series, moved to the host once a chunk) when it does.

The check. Every chunk, the warm-up's included, leaves a record: boxes of
its input and the cores of its output at positions drawn from the seed
(:class:`perfbench.inputs.PatchSampler`). The reference sweeps each box
(:mod:`perfbench.reference.metropolis`) and counts the core sites where the
program's spins differ (``spin_mismatch``). The warm-up's boxes come from
the benchmark's own starting lattice; later chunks start from the
program's state. A measured chunk's last (m, E) is that of the state it
leaves; for the last chunk of the window and the one before, the exact
sums of those states (:mod:`perfbench.reference.sums`) are compared with
the series (``m_gap``, ``e_gap``).
"""
from __future__ import annotations

import torch

from perfbench import inputs
from perfbench.reference import metropolis, sums

# The sample: patches of CORE x CORE sites a chunk, each recomputed from a
# box 2 x (sweeps in a chunk) wider on every side.
PATCHES, CORE, SLOTS = 32, 128, 24


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.api import EngineConfig, IsingEngine

        self.size = config["size"]
        self.bs = config["block_size"]
        self.dtype = getattr(torch, config["dtype"])
        self.beta = traffic["beta"]
        self.sweeps = traffic["chunk_sweeps"]
        self.measure = traffic["measure"]
        self.seed, self.device = seed, torch.device(device)
        self.limits = config["limits"]
        self.sites = self.size * self.size
        self.engine = IsingEngine(EngineConfig(
            size=self.size, beta=self.beta, n_sweeps=self.sweeps,
            backend=config["backend"], block_size=self.bs,
            dtype=config["dtype"], accept=config["accept"],
            measure=self.measure, hot=True), device=self.device)
        self.key = inputs.chain_key(seed)
        self.done = 0
        self.chunks = 0
        self.series = []        # the last two chunks' (m, E) series
        self.prev = self.state = None

    def _run(self, state, key):
        if self.measure:
            res = self.engine.run(state, key)
            return res.state, (res.magnetization, res.energy)
        return self.engine.run_sweeps(state, key, self.sweeps), None

    def setup(self) -> None:
        before = torch.cuda.memory_allocated(self.device) \
            if self.device.type == "cuda" else 0
        self.sampler = inputs.PatchSampler(
            self.size, PATCHES, min(CORE, self.size), 2 * self.sweeps,
            self.seed, self.device, SLOTS)
        self.harness_bytes = (torch.cuda.memory_allocated(self.device)
                              - before) if self.device.type == "cuda" else 0
        self.state = inputs.hot_quads(self.size, self.dtype, self.seed,
                                      self.device)
        self.chunk()            # the warm-up: every shape the window uses

    def chunk(self) -> int:
        key = inputs.chunk_key(self.key, self.done)
        self.sampler.take_input(self.chunks, self.state, key, self.sweeps)
        self.prev = None        # hold no more than the program's caller would
        new, series = self._run(self.state, key)
        self.sampler.take_output(new)
        self.prev, self.state = self.state, new
        if series is not None:
            self.series = (self.series + [series])[-2:]
        self.done += self.sweeps
        self.chunks += 1
        return self.sweeps

    def release(self) -> None:
        """Free what the check does not read: the engine's caches, and the
        states unless the series are checked against them."""
        self.engine = None
        if not self.measure:
            self.prev = self.state = None

    def check(self, precision: str = "float32") -> tuple:
        """(readings, chunks checked, chunks found wrong). ``precision``
        other than float32 puts the reference at that precision in the
        program's place: the control."""
        mismatch, wrong, checked = 0, set(), set()
        for chunk, key, n, boxes, origins, cores in self.sampler.records():
            want = metropolis.sweep_boxes(boxes, origins, self.size, self.bs,
                                          key, n, self.beta)
            got = (cores if precision == "float32" else
                   metropolis.sweep_boxes(boxes, origins, self.size, self.bs,
                                          key, n, self.beta, precision))
            bad = int((want != got).sum())
            mismatch += bad
            checked.add(chunk)
            if bad:
                wrong.add(chunk)
        readings = [("spin_mismatch", mismatch, self.limits["spin_mismatch"])]
        if self.measure:
            gaps = {"m": 0.0, "e": 0.0}
            last = self.chunks - 1
            for state, (ms, es), chunk in zip((self.prev, self.state),
                                              self.series, (last - 1, last)):
                m, e = sums.m_e(state)
                if precision != "float32":
                    ms, es = [torch.tensor([sums.in_bfloat16(v)])
                              for v in (m, e)]
                gm, ge = abs(float(ms[-1]) - m), abs(float(es[-1]) - e)
                gaps["m"], gaps["e"] = max(gaps["m"], gm), max(gaps["e"], ge)
                checked.add(chunk)
                if gm > self.limits["m_gap"] or ge > self.limits["e_gap"]:
                    wrong.add(chunk)
            readings += [("m_gap", gaps["m"], self.limits["m_gap"]),
                         ("e_gap", gaps["e"], self.limits["e_gap"])]
        return readings, len(checked), len(wrong)
