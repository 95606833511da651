"""The traced window: device operations, host spans, and what they add up to.

A ``--trace 1`` run records the window with ``torch.profiler`` (CPU and
CUDA activities). :func:`from_profiler` turns the profiler's events into
plain :class:`Op` lists; everything else here works on those lists, so it
runs the same on recorded or made-up events.

The harness marks its own spans by name: ``perfbench.window`` around the
window, ``perfbench.chunk`` around each call into the program, and
``perfbench.sample`` around the copies it takes for the check. Device
operations launched inside a ``perfbench.sample`` span (matched to their
host launch by correlation id) are the harness's, not the program's.
"""
from __future__ import annotations

import bisect
import dataclasses

WINDOW, CHUNK, SAMPLE = "perfbench.window", "perfbench.chunk", \
    "perfbench.sample"


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    start: float        # seconds, the profiler's clock
    end: float
    corr: int = 0       # correlation id (host launch <-> device op)

    @property
    def seconds(self) -> float:
        return self.end - self.start


def from_profiler(prof) -> tuple:
    """(device ops, host ops) of a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and (
                e.name().startswith("perfbench.")
                or getattr(e, "is_user_annotation", bool)()):
            continue    # a host span mirrored on the device's timeline
        start = e.start_ns() * 1e-9
        op = Op(e.name(), start, start + e.duration_ns() * 1e-9,
                e.correlation_id())
        (device if e.device_type() == DeviceType.CUDA else host).append(op)
    return device, host


def union_seconds(ops, t0: float, t1: float) -> float:
    """Seconds of [t0, t1] covered by at least one op."""
    total, end = 0.0, t0
    for op in sorted(ops, key=lambda o: o.start):
        s, e = max(op.start, end), min(op.end, t1)
        if e > s:
            total += e - s
        end = max(end, min(op.end, t1))
    return total


def idle_gaps(ops, t0: float, t1: float) -> list:
    """(start, end) of every stretch of [t0, t1] with no device op."""
    gaps, end = [], t0
    for op in sorted(ops, key=lambda o: o.start):
        if op.start > end:
            gaps.append((end, min(op.start, t1)))
        end = max(end, op.end)
        if end >= t1:
            break
    if end < t1:
        gaps.append((end, t1))
    return [g for g in gaps if g[1] > g[0]]


class HostIndex:
    """What the host was inside at a moment: the innermost host op (the
    latest started one that has not ended), else the innermost harness
    span."""

    SCAN = 64

    def __init__(self, host):
        self.ops = sorted(host, key=lambda o: o.start)
        self.starts = [o.start for o in self.ops]
        self.spans = [o for o in self.ops if o.name.startswith("perfbench.")]

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t)
        for op in reversed(self.ops[max(0, i - self.SCAN):i]):
            if op.end > t and not op.name.startswith("perfbench."):
                return op.name
        inside = [s for s in self.spans if s.start <= t < s.end]
        return max(inside, key=lambda s: s.start).name if inside else "host"


def short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def top(pairs, n: int = 10) -> list:
    """The n largest (name, seconds) sums by name."""
    sums = {}
    for name, s in pairs:
        sums[name] = sums.get(name, 0.0) + s
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]


@dataclasses.dataclass
class Window:
    """What a per-layer metric reads: the traced window of one cell."""
    seconds: float          # the window on the host clock
    sweeps: int
    sites: int
    config: dict
    ops: list               # the program's device ops in the window
    harness_ops: list       # the harness's own device ops
    host: list
    t0: float
    t1: float
    counters: dict          # program counters: their change over the window

    def busy_seconds(self) -> float:
        return union_seconds(self.ops + self.harness_ops, self.t0, self.t1)

    def breakdown(self) -> dict:
        index = HostIndex(self.host)
        gaps = idle_gaps(self.ops + self.harness_ops, self.t0, self.t1)
        return {"device_ops": top((short(o.name), o.seconds)
                                  for o in self.ops + self.harness_ops),
                "idle_gaps": top((short(index.at((a + b) / 2)), b - a)
                                 for a, b in gaps)}


def window(device, host, **kw) -> Window:
    """Split the recorded ops at the ``perfbench.window`` span and sort the
    device ops into the program's and the harness's."""
    span = next(o for o in host if o.name == WINDOW)
    samples = sorted((o for o in host if o.name == SAMPLE),
                     key=lambda o: o.start)
    starts = [o.start for o in samples]

    def in_sample(op):
        i = bisect.bisect_right(starts, op.start) - 1
        return i >= 0 and op.start < samples[i].end

    harness_corr = {o.corr for o in host if o.corr and in_sample(o)}
    inside = [o for o in device if o.end > span.start and o.start < span.end]
    return Window(ops=[o for o in inside if o.corr not in harness_corr],
                  harness_ops=[o for o in inside if o.corr in harness_corr],
                  host=[o for o in host
                        if o.end > span.start and o.start < span.end],
                  t0=span.start, t1=span.end, **kw)
