"""Collectives and their per-rank wire bytes under ring algorithms: the
port of ``repro.analysis.hlo``.

The reference parses the collectives out of the partitioned HLO text. The
port has no HLO: a :class:`~repro_torch.launch.mesh.DeviceGrid` records
each collective it issues (its kind, operand and result bytes and the
ring's ranks) as a :class:`Collective`, on a real process group as on a rankless
grid (``launch.mesh.rankless_grid``), and :func:`collective_summary` runs
over those records.
"""
from __future__ import annotations

import dataclasses

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


@dataclasses.dataclass(frozen=True)
class Collective:
    kind: str
    result_bytes: int
    operand_bytes: int
    ranks: tuple            # the ring's ranks, in its order

    @property
    def group_size(self) -> int:
        return len(self.ranks)

    @property
    def wire_bytes(self) -> float:
        """Bytes each rank moves over the interconnect (ring algorithms)."""
        n = max(self.group_size, 1)
        if n == 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * (n - 1) / n * self.result_bytes
        if self.kind == "all-gather":
            return (n - 1) / n * self.result_bytes
        if self.kind == "reduce-scatter":
            return (n - 1) / n * self.operand_bytes
        if self.kind == "all-to-all":
            return (n - 1) / n * self.operand_bytes
        if self.kind == "collective-permute":
            return float(self.operand_bytes)
        return 0.0


def collective_summary(collectives) -> dict:
    """Count, wire bytes a rank and wire bytes by kind of the recorded
    ``collectives``."""
    colls = list(collectives)
    by_kind: dict[str, float] = {}
    for c in colls:
        by_kind[c.kind] = by_kind.get(c.kind, 0.0) + c.wire_bytes
    return {
        "count": len(colls),
        "wire_bytes_per_device": sum(c.wire_bytes for c in colls),
        "by_kind": by_kind,
    }
