"""Generic domain decomposition: one loop over sweeps, any model.

The port of ``repro.distributed.decomp``. The reference runs its loop
inside ``shard_map``; here every rank runs the same Python loop over its
own block, and the halo exchange and the reductions inside a model's
``sweep`` and ``stats`` are collectives over the grid's group. A
:class:`MeshModel` binds a model to the loop:

* ``sweep(carry, key, step)``: one full rank-local sweep (halos, RNG and
  acceptance are the model's business; ``key`` is the chain key, the same
  on every rank, and ``step`` the sweep counter);
* ``stats(carry)``: the sweep's global sums
  (:class:`repro_torch.core.measure.Totals`, already summed over the
  grid), which the moments are accumulated from in the reference's
  compiled order;
* ``sweep_measured`` (optional): a fused sweep + stats;
* ``unpack`` / ``pack`` (optional): carry-layout converters.

:func:`make_run_chain_fn` accumulates :class:`repro_torch.core.measure.
Moments` on every rank from the summed scalars, so every rank holds the
same moments.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core import measure


@dataclasses.dataclass(frozen=True)
class MeshModel:
    """One spin model x state layout bound to the generic loop.

    ``state_spec`` is the placement of the global state
    (:meth:`repro_torch.launch.mesh.DeviceGrid.gather`); ``sweep`` and
    ``stats`` work on the rank-local block (or its unpacked carry).
    """
    state_spec: tuple
    sweep: Callable          # (carry, key, step) -> carry
    stats: Callable          # (carry) -> measure.Totals over the grid
    sweep_measured: Optional[Callable] = None   # (carry, key, step)
    unpack: Optional[Callable] = None           # local state -> carry
    pack: Optional[Callable] = None             # carry -> local state

    def _unpack(self, st):
        return self.unpack(st) if self.unpack is not None else st

    def _pack(self, carry):
        return self.pack(carry) if self.pack is not None else carry

    def _sweep_measured(self):
        if self.sweep_measured is not None:
            return self.sweep_measured

        def fused(carry, key, step):
            carry = self.sweep(carry, key, step)
            return carry, self.stats(carry)

        return fused


def make_run_sweeps_fn(grid, model: MeshModel, n_sweeps: int):
    """Measurement-free chain ``run(local_state, key) -> local_state``:
    the paper's throughput loop."""
    del grid    # the model's collectives carry it

    def run(st, key):
        carry = model._unpack(st)
        for step in range(n_sweeps):
            carry = model.sweep(carry, key, step)
        return model._pack(carry)

    return run


def make_run_chain_fn(grid, model: MeshModel, n_sweeps: int,
                      measure_every: int = 1):
    """Measured chain ``run(local_state, key) -> (local_state, Moments)``:
    per-sweep sums over the grid, accumulated with ``measure_every``
    thinning in the reference's compiled order."""
    measured = model._sweep_measured()

    def run(st, key):
        carry = model._unpack(st)
        mom = measure.init_moments(device=grid.device)
        for step in range(n_sweeps):
            carry, totals = measured(carry, key, step)
            mom = measure.accumulate_totals(mom, totals, step,
                                            measure_every)
        return model._pack(carry), mom

    return run


def global_stats(grid, model: MeshModel):
    """Exact global ``(m, E/spin)`` of the decomposed state without
    gathering it."""
    del grid

    def stats(st):
        return model.stats(model._unpack(st)).means()

    return stats
