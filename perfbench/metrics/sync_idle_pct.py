"""The share of the traced window in which the device sat idle after the
host began waiting on it: the idle gaps that began inside one of the
program's ``repro_torch.*.sync`` spans (the label loop's changed flag, the
measured series' copy to the host)."""
from perfbench import spans


def _sync(name) -> bool:
    return bool(name) and name.startswith(spans.PREFIX) \
        and name.endswith(".sync")


def read(w):
    if not any(_sync(o.name) for o in w.host):
        return None
    idle = spans.idle_by_span(w)
    return 100.0 * sum(s for n, s in idle.items() if _sync(n)) / (w.t1 - w.t0)
