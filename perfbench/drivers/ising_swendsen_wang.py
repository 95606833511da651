"""Swendsen-Wang chains through ``repro_torch.api.IsingEngine``.

One chunk is ``IsingEngine.run`` of ``chunk_sweeps`` sweeps keyed
``fold_in(key, done)``, with ``measure=True``: the per-sweep (m, E) series
moved to the host once a chunk.

The check. Cluster labels are global, so the reference recomputes whole
chunks (:mod:`perfbench.reference.swendsen_wang`): the warm-up, from the
benchmark's own starting lattice made again from the seed, and the last
chunk of the window, from the program's state before it. Each is held to
the program at every site of the state it leaves (``spin_mismatch``), and
its every (m, E) to the exact sums of the reference's state after that
sweep (``m_gap``, ``e_gap``).
"""
from __future__ import annotations

import torch

from perfbench import inputs
from perfbench.reference import sums, threefry
from perfbench.reference import swendsen_wang as sw


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.api import EngineConfig, IsingEngine

        self.size = config["size"]
        self.dtype = getattr(torch, config["dtype"])
        self.beta = traffic["beta"]
        self.sweeps = traffic["chunk_sweeps"]
        if not traffic["measure"]:
            raise ValueError("the Swendsen-Wang driver runs measured chunks")
        self.seed, self.device = seed, torch.device(device)
        self.limits = config["limits"]
        self.sites = self.size * self.size
        self.engine = IsingEngine(EngineConfig(
            size=self.size, beta=self.beta, n_sweeps=self.sweeps,
            algorithm="swendsen_wang", dtype=config["dtype"], measure=True,
            hot=True), device=self.device)
        self.key = inputs.chain_key(seed)
        self.done = self.chunks = 0
        self.harness_bytes = 0
        self.state = None

    def counters(self) -> dict:
        from repro_torch.cluster import label

        return {"label_iterations": label.counters["iterations"]}

    def _start(self) -> torch.Tensor:
        return inputs.hot_quads(self.size, self.dtype, self.seed, self.device)

    def setup(self) -> None:
        self.state = self._start()
        self.chunk()            # the warm-up: every shape the window uses
        key, _, out, ms, es = self.last
        self.warm = (key, out.cpu(), ms, es)
        self.last = None

    def chunk(self) -> int:
        key = inputs.chunk_key(self.key, self.done)
        self.last = None        # hold no more than the program's caller would
        res = self.engine.run(self.state, key)
        self.last = (key, self.state, res.state, res.magnetization,
                     res.energy)
        self.state = res.state
        self.done += self.sweeps
        self.chunks += 1
        return self.sweeps

    def release(self) -> None:
        self.engine = None

    def check(self, precision: str = "float32") -> tuple:
        """(readings, chunks checked, chunks found wrong); a ``precision``
        other than float32 puts the reference at that precision in the
        program's place (the control)."""
        want_t = sw.threshold(self.beta)
        got_t = sw.threshold(self.beta, precision)
        wkey, warm_out, wms, wes = self.warm
        key, before, after, ms, es = self.last
        runs = [(wkey, self._start(), warm_out.to(self.device), wms, wes),
                (key, before, after, ms, es)]
        mismatch, gaps, wrong = 0, {"m": 0.0, "e": 0.0}, 0
        for key, start, out, ms, es in runs:
            want = got = sums.to_full(start)
            bad = False
            for step in range(self.sweeps):
                sweep_key = threefry.fold_in(key, step)
                want = sw.sweep(want, sweep_key, want_t)
                m, e = sums.m_e(sums.to_quads(want))
                if precision == "float32":
                    gm, ge = float(ms[step]), float(es[step])
                else:
                    got = sw.sweep(got, sweep_key, got_t)
                    gm, ge = (sums.in_bfloat16(v)
                              for v in sums.m_e(sums.to_quads(got)))
                gm, ge = abs(gm - m), abs(ge - e)
                gaps["m"], gaps["e"] = max(gaps["m"], gm), max(gaps["e"], ge)
                bad |= gm > self.limits["m_gap"] or ge > self.limits["e_gap"]
            final = out if precision == "float32" else sums.to_quads(got)
            n = int((sums.to_quads(want) != final).sum())
            mismatch += n
            wrong += bool(n) or bad
        return ([("spin_mismatch", mismatch, self.limits["spin_mismatch"]),
                 ("m_gap", gaps["m"], self.limits["m_gap"]),
                 ("e_gap", gaps["e"], self.limits["e_gap"])], len(runs), wrong)
