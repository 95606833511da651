"""q-state Potts model plane.

The port of ``repro.potts`` (its sharded form is :mod:`~repro_torch.potts.
mesh`): int32 colour states and observables (:mod:`~repro_torch.potts.state`),
checkerboard heat-bath / Metropolis (:mod:`~repro_torch.potts.rules`), FK
bonds (:mod:`~repro_torch.potts.bonds`) and Swendsen-Wang / Wolff
(:mod:`~repro_torch.potts.sweep`).
"""
from repro_torch.potts.state import (  # noqa: F401
    beta_c, random_state, cold_state, order_parameter, energy_per_spin,
    full_stats,
)
from repro_torch.potts.sweep import cluster_sweep, labels_for  # noqa: F401
from repro_torch.potts.rules import checkerboard_sweep  # noqa: F401
