"""The keyed edge-line kernel's share of its roofline: one colour's bound
(:func:`perfbench.work.colour_bound_s`) over the mean device time of one
keyed lines launch (``ising::half_sweep_{vec,any}<..., KEYED = true,
LineHalo>``, by its demangled or mangled name) in the traced window. The
halo lines' gather is not in it: ``halo_lines_ms_per_sweep`` reads that."""
import re

from perfbench import work

_KEYED_LINES = re.compile(r"half_sweep_(?:vec|any)<.*\btrue\b.*LineHalo")
_KEYED_LINES_MANGLED = re.compile(r"half_sweep_(?:vec|any)I.*Lb1E.*LineHalo")


def is_keyed_lines_launch(name: str) -> bool:
    return bool(_KEYED_LINES.search(name)
                or _KEYED_LINES_MANGLED.search(name))


def read(w):
    keyed = [op.seconds for op in w.ops if is_keyed_lines_launch(op.name)]
    if not keyed:
        return None
    return 100.0 * work.colour_bound_s(w.sites) / (sum(keyed) / len(keyed))
