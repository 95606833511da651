"""Cluster-update plane: Swendsen-Wang / Wolff.

The port of ``repro.cluster`` (its sharded form is :mod:`~repro_torch.
cluster.mesh`): FK bonds with u24 thresholds and counter-based bond bits
(:mod:`~repro_torch.cluster.bonds`), canonical labels (:mod:`~repro_torch.
cluster.label`: union-find on the card, neighbour-min and pointer jumps on
the CPU), and gather-free
per-cluster coins (:mod:`~repro_torch.cluster.sweep`).
"""
from repro_torch.cluster.bonds import (bond_prob_f32, bond_threshold_u24,
                                       bond_threshold_traced, counter_bits,
                                       fk_bonds)
from repro_torch.cluster.label import label_components
from repro_torch.cluster.sweep import (cluster_sweep, cluster_sweep_measured,
                                       full_stats, labels_for)

ALGORITHMS = ("swendsen_wang", "wolff")

__all__ = [
    "ALGORITHMS",
    "bond_prob_f32",
    "bond_threshold_u24",
    "bond_threshold_traced",
    "counter_bits",
    "fk_bonds",
    "label_components",
    "cluster_sweep",
    "cluster_sweep_measured",
    "full_stats",
    "labels_for",
]
