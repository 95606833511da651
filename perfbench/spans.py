"""What the program's own stage spans say about the traced window.

While a profiler records, the program marks its stages with
``repro_torch.*`` ranges (listed in ``repro_torch.spans``); they are among
the window's host ops, on the device ops' clock. Two readings:

* :func:`launched_seconds`: the device seconds of the operations launched
  inside spans of the given names, nested spans included. A device
  operation is matched to its host launch by correlation id, taken only
  from CUDA runtime and driver calls (host ops named ``cu*``, such as
  ``cudaLaunchKernel`` and ``cudaMemcpyAsync``): the ids of aten ops are
  not in the same space. It looks at every device operation of the window,
  the harness's included: those are launched inside ``perfbench.sample``
  spans, between chunks, never inside the program's, and the match by
  launch keeps a program operation that :func:`perfbench.trace.window`
  filed with the harness's (an aten op of a sample can share its id).
* :func:`idle_by_span`: the device's idle seconds, each gap charged to the
  innermost ``repro_torch.`` span open on the host when the gap began,
  which is where the host was when the device ran dry.

Both return None on a window that holds none of the spans asked for, as a
program without them gives.
"""
from __future__ import annotations

import bisect

from perfbench import trace

PREFIX = "repro_torch."


def _merged(spans) -> list:
    """The union of the spans' intervals, as sorted disjoint (start, end)."""
    out = []
    for s in sorted(spans, key=lambda o: o.start):
        if out and s.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s.end)
        else:
            out.append([s.start, s.end])
    return out


def launched_seconds(w, names) -> float | None:
    """Device seconds of the program's operations whose host launch fell
    inside a span named in ``names``; None without such a span."""
    names = set(names)
    intervals = _merged(o for o in w.host if o.name in names)
    if not intervals:
        return None
    starts = [a for a, _ in intervals]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < intervals[i][1]

    corr = {o.corr for o in w.host
            if o.corr and o.name.startswith("cu") and inside(o.start)}
    return sum(op.seconds for op in w.ops + w.harness_ops
               if op.corr in corr)


def _innermost(spans, times) -> list:
    """For ascending ``times``, the name of the innermost span open at each
    (None where none is): the latest started of those not yet ended, the
    spans of one thread nesting properly."""
    spans = sorted(spans, key=lambda o: o.start)
    out, open_, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i].start <= t:
            while open_ and open_[-1].end <= spans[i].start:
                open_.pop()
            open_.append(spans[i])
            i += 1
        while open_ and open_[-1].end <= t:
            open_.pop()
        out.append(open_[-1].name if open_ else None)
    return out


def idle_by_span(w) -> dict | None:
    """Idle seconds of the window by the ``repro_torch.`` span open when
    each gap began (None for gaps outside every one); None without such a
    span."""
    spans = [o for o in w.host if o.name.startswith(PREFIX)]
    if not spans:
        return None
    gaps = trace.idle_gaps(w.ops + w.harness_ops, w.t0, w.t1)
    out = {}
    for (a, b), name in zip(gaps, _innermost(spans, [a for a, _ in gaps])):
        out[name] = out.get(name, 0.0) + (b - a)
    return out
