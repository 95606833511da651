"""The yardstick's peaks, and the least time the chip needs for a sweep.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
the HBM3 rate, the SM clock and count, and each SM's issue rates a clock
(CUDA programming guide, compute capability 9.0: 64 32-bit integer ALU
operations, 128 f32 operations, 4 schedulers x 32 lanes = 128
instructions of any kind).

The work of one site of a checkerboard Metropolis sweep, counted from the
function and not from any implementation: threefry2x32 of its counter,
with 20 rotations, 21 xors (20 rounds and the output x0 ^ x1) and the
bits >> 8 shift, which only the integer ALU issues (42); 27 adds (one a
round, the key word into x1 before each of the 5 groups, both words of
the last injection), which either pipe may issue; and the rule's 15 f32
operations (3 adds of the neighbour sum, sigma * nn, 4 compares and 4
selects of the table, the convert of bits >> 8, u < t and the select of
the new spin). The integer ALU then needs 42 / 64 of a clock a site, and
the issue slots (42 + 27 + 15) / 128: both 0.65625 clocks.

Bytes: a sweep reads each spin once and writes it once (2 + 2 bytes in
bf16); one colour's launch reads all four quads and writes two (3 bytes a
site of the lattice).
"""
from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12
SM_CLOCK_HZ = 1.98e9
SMS = 132
INT_PER_CLOCK, F32_PER_CLOCK, ISSUE_PER_CLOCK = 64, 128, 128

SITE_INT_ONLY, SITE_ADDS, SITE_F32 = 20 + 21 + 1, 20 + 5 + 2, 15
SPIN_BYTES = 2      # bf16


def site_clocks() -> float:
    """SM clocks a site of a Metropolis update needs at the tightest of the
    ALU, FMA-pipe and issue limits."""
    return max(SITE_INT_ONLY / INT_PER_CLOCK, SITE_F32 / F32_PER_CLOCK,
               (SITE_INT_ONLY + SITE_ADDS + SITE_F32) / ISSUE_PER_CLOCK)


def op_seconds(updates: float) -> float:
    return updates * site_clocks() / (SM_CLOCK_HZ * SMS)


def sweep_bounds_s(sites: int) -> tuple:
    """(operations, bytes) bounds of one sweep, in seconds."""
    return op_seconds(sites), 2 * SPIN_BYTES * sites / HBM_BYTES_PER_S


def sweep_bound_s(sites: int) -> float:
    return max(sweep_bounds_s(sites))


def colour_bound_s(sites: int) -> float:
    """One colour's launch: half the sites updated, against reading all
    four quads and writing two."""
    return max(op_seconds(sites / 2),
               3 * SPIN_BYTES * sites / 2 / HBM_BYTES_PER_S)


_KEYED_TILES = re.compile(r"half_sweep_(?:vec|any)<.*\btrue\b.*TileHalo")
_KEYED_TILES_MANGLED = re.compile(r"half_sweep_(?:vec|any)I.*Lb1E.*TileHalo")


def is_keyed_tile_launch(name: str) -> bool:
    """A launch of the keyed form of the tile-fetch kernel
    (``ising::half_sweep_{vec,any}<..., KEYED = true, TileHalo>``), by its
    demangled or mangled name."""
    return bool(_KEYED_TILES.search(name) or _KEYED_TILES_MANGLED.search(name))
