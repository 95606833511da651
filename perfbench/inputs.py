"""What the benchmark makes from ``--seed``: the starting lattice, the chain
key, and the sites whose outputs the check compares.

Both sides get the same: the program is handed the lattice and the keys,
and the reference recomputes from the same lattice, keys and samples.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import trace
from perfbench.reference import threefry


def hot_quads(size: int, dtype: torch.dtype, seed: int,
              device) -> torch.Tensor:
    """A hot start as compact quads ``[4, size/2, size/2]``: every spin +-1
    with probability 1/2, drawn on ``device`` by one generator call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    half = size // 2
    q = torch.empty((4, half, half), dtype=dtype, device=device)
    return q.bernoulli_(0.5, generator=gen).mul_(2).sub_(1)


def chain_key(seed: int) -> tuple:
    return threefry.seed_key(seed)


def chunk_key(key, done: int) -> tuple:
    """The key of the chunk that starts after ``done`` sweeps, as the
    program's launcher keys its chunks."""
    return threefry.fold_in(key, done)


class PatchSampler:
    """Square patches of the full lattice, taken from compact quads.

    Chunk j's record is a box of its input around ``n`` cores at positions
    drawn from the seed, ``margin`` wider on each side, and the cores of
    its output. Patch 0's core straddles the torus corner; the others lie
    anywhere, so they cross tile and wrap boundaries as they fall. Records
    live in ``slots`` preallocated device slots (int8); chunks past the
    first ``slots - 2`` share the last two, so the first chunks and the
    last two are kept whole.
    """

    def __init__(self, size: int, n: int, core: int, margin: int, seed: int,
                 device, slots: int = 24):
        if slots < 3:
            raise ValueError("a sampler needs at least 3 slots")
        self.size, self.core, self.margin = size, core, margin
        self.box = core + 2 * margin
        rng = np.random.default_rng([int(seed) % (1 << 64), 0x5EED])
        origins = rng.integers(0, size, size=(slots, n, 2), dtype=np.int64)
        origins[:, 0] = (size - core // 2) % size
        self.origins = torch.from_numpy(origins).to(device)
        self.boxes = torch.empty((slots, n, self.box, self.box),
                                 dtype=torch.int8, device=device)
        self.cores = torch.empty((slots, n, core, core), dtype=torch.int8,
                                 device=device)
        self._steps = torch.arange(self.box, dtype=torch.int64, device=device)
        self.held = {}      # slot -> (chunk index, chunk key, sweeps)
        self.slots = slots

    def slot(self, chunk: int) -> int:
        first = self.slots - 2
        return chunk if chunk < first else first + (chunk - first) % 2

    def _take(self, quads, origins, side: int, out) -> None:
        """``out[p]`` = the side x side patch of the full lattice whose
        top-left site is ``origins[p]``, wrapping around the torus."""
        half = self.size // 2
        with torch.profiler.record_function(trace.SAMPLE):
            steps = self._steps[:side]
            rows = (origins[:, :1] + steps) % self.size
            cols = (origins[:, 1:] + steps) % self.size
            quad = 2 * (rows & 1)[:, :, None] + (cols & 1)[:, None, :]
            flat = ((quad * half + (rows >> 1)[:, :, None]) * half
                    + (cols >> 1)[:, None, :])
            out.copy_(quads.reshape(-1)[flat])

    def take_input(self, chunk: int, quads, key, sweeps: int) -> None:
        s = self.slot(chunk)
        self.held.pop(s, None)
        self._take(quads, self.origins[s] - self.margin, self.box,
                   self.boxes[s])
        self._pending = (s, (chunk, key, sweeps))

    def take_output(self, quads) -> None:
        s, record = self._pending
        self._take(quads, self.origins[s], self.core, self.cores[s])
        self.held[s] = record

    def records(self):
        """(chunk, key, sweeps, boxes, box origins, cores) of every whole
        record, in chunk order."""
        for s, (chunk, key, sweeps) in sorted(self.held.items(),
                                              key=lambda kv: kv[1][0]):
            yield (chunk, key, sweeps, self.boxes[s],
                   (self.origins[s] - self.margin) % self.size, self.cores[s])
