"""``device_idle_pct`` in the Swendsen-Wang cells, where it moves
``cluster_flips_per_ns``."""
from perfbench.metrics import device_idle_pct


def read(w):
    return device_idle_pct.read(w)
