"""The simulate launcher's default path: one rank of a 1 x 1 grid.

The engine is built as ``python -m repro_torch.launch.simulate`` builds
it, through ``launch.simulate.build(parse_args([...]))`` with ``--mesh
1,1``, the configuration's blocks and the traffic's temperature ratio, so
the cell runs the launcher's defaults (the ``"mesh"`` scenario, backend
``xla``, the paper pipeline with bfloat16 uniforms) and a change to them
shows here. One chunk is the launcher's loop without its printing and
checkpoints: ``engine.run_sweeps(state, fold_in(key, done), n)``, then
``engine.stats(state)``, the exact global (m, E/spin) on the host.

The lattice starts from the benchmark's hot start (:func:`perfbench.inputs.
hot_quads`), laid out as the grid holds it, blocked ``[4, MR, MC, bs,
bs]``; the launcher's ``engine.init`` is not used.

The check. Every chunk, the warm-up's included, leaves a record: boxes of
its input and the cores of its output at positions drawn from the seed,
read from the blocked state at the sampled sites alone. The reference
(:mod:`perfbench.reference.paper_metropolis`) sweeps each box and counts
the core sites where the program's spins differ (``spin_mismatch``). For
the last chunk of the window and the one before, the exact sums of the
states they leave (:mod:`perfbench.reference.sums`) are compared with the
program's ``stats`` (``m_gap``, ``e_gap``).
"""
from __future__ import annotations

import torch

from perfbench import inputs, trace
from perfbench.reference import paper_metropolis, sums

# The sample: patches of CORE x CORE sites a chunk, each recomputed from a
# box 2 x (sweeps in a chunk) wider on every side.
PATCHES, CORE, SLOTS = 32, 128, 24
# Lattice rows a band of the whole-lattice comparison.
BAND_ROWS = 512


def take(qb: torch.Tensor, size: int, origins: torch.Tensor, h: int,
         w: int, steps: torch.Tensor) -> torch.Tensor:
    """The h x w patches (int8 ``[P, h, w]``) of the full torus whose
    top-left sites are ``origins`` [P, 2], read from blocked quads
    ``qb[4, m, m, bs, bs]`` at those sites alone."""
    m, bs = qb.shape[1], qb.shape[-1]
    rows = (origins[:, :1] + steps[:h]) % size
    cols = (origins[:, 1:] + steps[:w]) % size
    qr, qc = rows >> 1, cols >> 1
    quad = 2 * (rows & 1)[:, :, None] + (cols & 1)[:, None, :]
    tile = (quad * m + (qr // bs)[:, :, None]) * m + (qc // bs)[:, None, :]
    flat = (tile * bs + (qr % bs)[:, :, None]) * bs + (qc % bs)[:, None, :]
    return qb.reshape(-1)[flat].to(torch.int8)


class BlockedSampler(inputs.PatchSampler):
    """:class:`perfbench.inputs.PatchSampler` over blocked quads."""

    def _take(self, qb, origins, side: int, out) -> None:
        with torch.profiler.record_function(trace.SAMPLE):
            out.copy_(take(qb, self.size, origins, side, side, self._steps))


def compact(qb: torch.Tensor) -> torch.Tensor:
    """Blocked quads ``[4, m, m, bs, bs]`` as compact quads ``[4, R, C]``
    (a copy)."""
    q, m, _, bs, _ = qb.shape
    return qb.permute(0, 1, 3, 2, 4).reshape(q, m * bs, m * bs)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.api import IsingEngine
        from repro_torch.launch import simulate

        self.size = config["size"]
        self.bs = config["block_size"]
        self.sweeps = traffic["chunk_sweeps"]
        self.seed, self.device = seed, torch.device(device)
        self.limits = config["limits"]
        self.sites = self.size * self.size
        cfg, spins, _, _, _ = simulate.build(simulate.parse_args([
            "--mesh", "1,1",
            "--blocks-per-device", str(self.size // 2 // self.bs),
            "--block-size", str(self.bs), "--chunk", str(self.sweeps),
            "--temperature-ratio", repr(traffic["temperature_ratio"])]))
        stated = {k: config[k] for k in ("dtype", "prob_dtype")}
        built = {"dtype": cfg.dtype, "prob_dtype": cfg.prob_dtype}
        if spins != self.sites or built != stated \
                or abs(cfg.beta - traffic["beta"]) > 1e-6:
            raise ValueError(f"the launcher builds {spins} sites, {built}, "
                             f"beta {cfg.beta}; the cell states "
                             f"{self.sites}, {stated}, {traffic['beta']}")
        self.beta = cfg.beta
        self.dtype = getattr(torch, cfg.dtype)
        self.engine = IsingEngine(cfg, device=self.device)
        self.key = inputs.chain_key(seed)
        self.done = 0
        self.chunks = 0
        self.stats = []         # the last two chunks' (m, E/spin)
        self.prev = self.state = None

    def setup(self) -> None:
        before = torch.cuda.memory_allocated(self.device) \
            if self.device.type == "cuda" else 0
        self.sampler = BlockedSampler(
            self.size, PATCHES, min(CORE, self.size), 2 * self.sweeps,
            self.seed, self.device, SLOTS)
        self.harness_bytes = (torch.cuda.memory_allocated(self.device)
                              - before) if self.device.type == "cuda" else 0
        q = inputs.hot_quads(self.size, self.dtype, self.seed, self.device)
        m = self.size // 2 // self.bs
        self.state = q.view(4, m, self.bs, m, self.bs).permute(
            0, 1, 3, 2, 4).contiguous()
        del q
        self.chunk()            # the warm-up: every shape the window uses

    def chunk(self) -> int:
        key = inputs.chunk_key(self.key, self.done)
        self.sampler.take_input(self.chunks, self.state, key, self.sweeps)
        self.prev = None        # hold no more than the launcher would
        new = self.engine.run_sweeps(self.state, key, self.sweeps)
        self.stats = (self.stats + [self.engine.stats(new)])[-2:]
        self.sampler.take_output(new)
        self.prev, self.state = self.state, new
        self.done += self.sweeps
        self.chunks += 1
        return self.sweeps

    def counters(self) -> dict:
        """The program's count of drawn words, where it has one."""
        from repro_torch import random as jr

        words = jr.counters.get("draw_words")
        return {} if words is None else {"draw_words": words}

    def release(self) -> None:
        """Free the engine's caches; the last two states stay for the
        check of their stats."""
        self.engine = None

    def check(self, precision: str | None = None) -> tuple:
        """(readings, chunks checked, chunks found wrong). A ``precision``
        puts the reference computed at that precision in the program's
        place, its stats carried in it too: the control is the one below
        the stated bfloat16, ``float8_e4m3fn``."""
        mismatch, wrong, checked = 0, set(), set()
        for chunk, key, n, boxes, origins, cores in self.sampler.records():
            want = paper_metropolis.sweep_boxes(boxes, origins, self.size,
                                                self.bs, key, n, self.beta)
            got = (cores if precision is None else
                   paper_metropolis.sweep_boxes(boxes, origins, self.size,
                                                self.bs, key, n, self.beta,
                                                precision))
            bad = int((want != got).sum())
            mismatch += bad
            checked.add(chunk)
            if bad:
                wrong.add(chunk)
        gaps = {"m": 0.0, "e": 0.0}
        last = self.chunks - 1
        for state, (mp, ep), chunk in zip((self.prev, self.state),
                                          self.stats, (last - 1, last)):
            m, e = sums.m_e(compact(state))
            if precision is not None:
                mp, ep = (paper_metropolis.rounded(v, precision)
                          for v in (m, e))
            gm, ge = abs(mp - m), abs(ep - e)
            gaps["m"], gaps["e"] = max(gaps["m"], gm), max(gaps["e"], ge)
            checked.add(chunk)
            if gm > self.limits["m_gap"] or ge > self.limits["e_gap"]:
                wrong.add(chunk)
        readings = [("spin_mismatch", mismatch, self.limits["spin_mismatch"]),
                    ("m_gap", gaps["m"], self.limits["m_gap"]),
                    ("e_gap", gaps["e"], self.limits["e_gap"])]
        return readings, len(checked), len(wrong)

    def whole_mismatch(self, band_rows: int = BAND_ROWS) -> tuple:
        """(sites that differ, sites compared) of one chunk from the
        current state over the whole lattice: the reference computed in
        bands of ``band_rows`` rows, each from a box of the input
        ``2 x sweeps`` wider on every side."""
        key = inputs.chunk_key(self.key, self.done)
        start = self.state
        out = self.engine.run_sweeps(start, key, self.sweeps)
        margin = 2 * self.sweeps
        steps = torch.arange(self.size + 2 * margin, dtype=torch.int64,
                             device=self.device)
        bad = 0
        for r0 in range(0, self.size, band_rows):
            h = min(band_rows, self.size - r0)
            at = torch.tensor([[r0, 0]], dtype=torch.int64,
                              device=self.device)
            box_at = (at - margin) % self.size
            box = take(start, self.size, box_at, h + 2 * margin,
                       self.size + 2 * margin, steps)
            want = paper_metropolis.sweep_boxes(box, box_at, self.size,
                                                self.bs, key, self.sweeps,
                                                self.beta)
            got = take(out, self.size, at, h, self.size, steps)
            bad += int((want != got).sum())
        return bad, self.sites
