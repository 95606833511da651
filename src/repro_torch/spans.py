"""Named stage spans on the profiler's clock.

``with span(name):`` marks a stage of the program as a profiler range
while a profiler is recording, so the range lands in the same trace as the
device operations it launched and the host waits inside it. With no
profiler running it is a shared ``contextlib.nullcontext()``: one flag
read a span, no range, no sync. The profiler being on is the only switch.

The range is the profiler's ``RecordFunction``, entered through
``torch._C._profiler._RecordFunctionFast`` rather than
``torch.profiler.record_function``: on an H100 under a CPU and CUDA
profiler the latter costs about 18.6 us a span, the former about 2.4 us.
A span around a host wait ends while the device sits idle, so that cost
lands in the idle time the spans are there to measure. The fast range
records a host event of the same name and puts no mirror on the device's
timeline.

The spans, each where its work happens so that every caller gets it:

* ``repro_torch.kernels.block``: ``kernels.ops._block_quads``, the copy of
  compact quads [4, R, C] into the blocked layout the kernels take;
* ``repro_torch.kernels.unblock``: ``kernels.ops._unblock_quads``, the
  copies of blocked quads back to [4, R, C];
* ``repro_torch.kernels.lines``: ``kernels.checkerboard._lines``, the
  four halo lines of one colour on the edge-line path
  (``update_color_lines`` and ``update_color_lines_keyed``, never the tile
  path); on a grid the ``edges`` provider, and so its exchange with the
  neighbouring ranks, runs inside it;
* ``repro_torch.measure.blocked_totals``: ``core.measure.blocked_totals``,
  the spin and bond sums: the measurement kernel on a CUDA stack, else
  the white colour's neighbour sums (``nn_white``) and the f32 sums;
* ``repro_torch.checkerboard.nn``: ``core.checkerboard.nn_black`` and
  ``nn_white``, the Algorithm-2 neighbour sums (the K-hat matmuls and the
  four halo lines; on a grid the ``edges`` provider, and so its exchange
  with the neighbouring ranks, runs inside it). The XLA-form colour
  updates enter it (one rank of a grid, the ``chain`` scenario, the
  ``ref`` backend), and ``blocked_totals``' f32 chain inside its own
  span; the keyed kernels and the measurement kernel never do;
* ``repro_torch.checkerboard.flip``: ``core.checkerboard._flip``, one
  quad's site update from its spins, neighbour sums and uniforms: on the
  card the flip kernel's launch for the LUT rule at a number beta and no
  field, else the rule's eager chain (and its copy into ``out`` where the
  caller gives one). The XLA-form colour updates enter it once a quad
  (one rank of a grid's paper pipeline, the ``chain`` scenario, the
  oracle); the keyed kernels, the opt pipeline and the cluster sweeps
  never do;
* ``repro_torch.random.draws``: ``random.bits``, ``random.uniform`` and
  ``random.randint``, the threefry draws on the caller's device: on the
  card the draw kernel's launch, elsewhere the eager int64 form
  (``random.counters["draw_words"]`` counts their words); inside
  ``cluster.bonds`` / ``cluster.coins`` where those call them.
  ``random.fold_in_bits`` is not in it (its kernel is counted in
  ``kernels.build.launches``), nor the keyed kernels' plain versions'
  ``random.kernel_bits``;
* ``repro_torch.cluster.bonds``: ``cluster.bonds.fk_bonds``, the
  neighbour rolls and compares and the two bond hashes;
* ``repro_torch.cluster.label``: ``cluster.label.label_components``: on
  the card the union-find kernel's launch, on the CPU every label
  iteration;
* ``repro_torch.cluster.label.sync``: inside it, on the CPU alone, the
  changed flag's ``.item()``, one host sync an iteration;
* ``repro_torch.cluster.coins``: ``cluster.sweep._cluster_signs``, the
  per-site coin hash (or Wolff's seed mask);
* ``repro_torch.engine.series.sync``: ``api.engine.IsingEngine``'s
  ``_run_kernel`` and ``_chain_loop``, the measured series' copy to the
  host, once a call.

Open a profiler around the program (``torch.profiler.profile`` with the CPU
activity, and the CUDA one on the card) and read the ``repro_torch.*``
ranges from its events or trace.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a
    context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
