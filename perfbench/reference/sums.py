"""Exact magnetisation and energy of a lattice, and the layout conversion.

Compact quads ``[4, R, C]`` hold the full ``[2R, 2C]`` torus as its four
parity sub-lattices: quad 2a + b is the sites (2i + a, 2j + b). Sums are
taken in int64 over blocks of full rows, so they are exact at any size and
fit in memory beside a lattice that fills the card.
"""
from __future__ import annotations

import torch

# Quad rows per block: 1024 full rows of an 81920-wide lattice is 335 MB
# of int32.
BLOCK_ROWS = 512


def full_rows(quads: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """Full rows [2 r0, 2 r1) of the lattice of ``quads``, as int32."""
    q = quads[:, r0:r1].to(torch.int32)
    n, c = r1 - r0, q.shape[-1]
    full = torch.empty((2 * n, 2 * c), dtype=torch.int32, device=q.device)
    full[0::2, 0::2] = q[0]
    full[0::2, 1::2] = q[1]
    full[1::2, 0::2] = q[2]
    full[1::2, 1::2] = q[3]
    return full


def to_full(quads: torch.Tensor) -> torch.Tensor:
    """The whole [2R, 2C] lattice (small lattices only)."""
    return full_rows(quads, 0, quads.shape[1]).to(quads.dtype)


def to_quads(full: torch.Tensor) -> torch.Tensor:
    return torch.stack([full[0::2, 0::2], full[0::2, 1::2],
                        full[1::2, 0::2], full[1::2, 1::2]])


def totals(quads: torch.Tensor, block_rows: int = BLOCK_ROWS) -> tuple:
    """(sum of the spins, sum over bonds of s_i s_j, number of sites), each
    bond (right and down neighbour on the torus) counted once."""
    rq = quads.shape[1]
    first = full_rows(quads, 0, 1)[:1]
    spins = bonds = 0
    for r0 in range(0, rq, block_rows):
        r1 = min(r0 + block_rows, rq)
        f = full_rows(quads, r0, r1)
        below = full_rows(quads, r1, r1 + 1)[:1] if r1 < rq else first
        spins += int(f.sum(dtype=torch.int64))
        bonds += int((f * torch.roll(f, -1, 1)).sum(dtype=torch.int64))
        bonds += int((f[:-1] * f[1:]).sum(dtype=torch.int64))
        bonds += int((f[-1] * below[0]).sum(dtype=torch.int64))
    return spins, bonds, 4 * quads[0].numel()


def m_e(quads: torch.Tensor) -> tuple:
    """Exact (m, E per spin) as float64: m = sum s / N, E = -sum_bonds / N."""
    spins, bonds, n = totals(quads)
    return spins / n, -bonds / n


def in_bfloat16(x: float) -> float:
    """``x`` rounded to bfloat16: a statistic carried in the lattice's own
    precision (the control's)."""
    return float(torch.tensor(x, dtype=torch.float64).to(torch.bfloat16))
