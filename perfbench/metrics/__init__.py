"""One reader a per-layer metric, found by the metric's name: ``read(w)``
takes the traced :class:`perfbench.trace.Window` and returns the number,
or None where the window holds nothing to read."""
