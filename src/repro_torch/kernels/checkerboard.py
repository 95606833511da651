"""The two checkerboard half-sweep kernels: CUDA wrappers and plain versions.

Each kernel updates one colour of blocked compact quads
``qb[4, mr, mc, bs, bs]`` in place and returns ``qb``:

* :func:`update_color_tiles` replaces the Pallas kernel
  ``update_color_pallas`` (``src/repro/kernels/checkerboard.py``, body
  ``_update_kernel``): the halo comes from the torus-neighbour tiles.
  Source: ``csrc/checkerboard_tiles.cu``.
* :func:`update_color_lines` replaces ``update_color_pallas_lines`` (body
  ``_update_kernel_lines``): the four halo lines come from
  ``core.checkerboard.edge_lines`` (or a grid's edge provider) outside the
  kernel. Source: ``csrc/checkerboard_lines.cu``.

Each kernel has two forms from one CUDA body
(``csrc/checkerboard_common.cuh``):

* the operand form takes uint32 bits ``[2, mr, mc, bs, bs]`` held as an
  int32 bit pattern; it is bound by memory (four quads and two bit planes
  read, two quads written: 2.10 GB per colour at L = 20480 in bf16, 0.63 ms
  at the H100's 3.35 TB/s);
* the keyed form (:func:`update_color_tiles_keyed`,
  :func:`update_color_lines_keyed`) takes the colour key
  ``fold_in(fold_in(key, step), color)`` instead and draws the same bits in
  the kernel: threefry2x32 of each site's flat index, as
  ``random.bits(key, (2, mr, mc, bs, bs))`` lays them out. It moves 1.26 GB
  per colour and is bound by integer issue (the hash).

No single PyTorch call computes this function.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor,
and only there, it runs the plain PyTorch version beside it, which repeats
the kernel's arithmetic (four-neighbour adds in f32, then the rule's
select and compare; the keyed form's plain version draws the bits with
``random.kernel_bits`` first, outside the draws span and its counter, as
the kernel draws them). Each launch is counted in ``build.launches`` under
the wrapper's name.
"""
from __future__ import annotations

import ctypes
import numbers

import torch

from repro_torch import random as jr
from repro_torch.core import checkerboard as cb
from repro_torch.core import lattice as L
from repro_torch.core import update_rules
from repro_torch.kernels import build
from repro_torch.spans import span

_RULE_CODE = {"metropolis_lut": 0, "metropolis_exp": 0, "heat_bath": 1}
# The launch grid: blockIdx.y is the tile row, blockIdx.x a tile column
# (or a group of them).
_MAX_GRID_Y, _MAX_GRID_X = 65535, 2 ** 31 - 1

# The C entry points. A half-sweep takes the quads' pointer, the key's two
# words (keyed form), its other pointers (bits; the four halo lines),
# mr, mc, bs, color, rule and dtype, then the rule's five table floats.
_P, _U32 = ctypes.c_void_p, ctypes.c_uint32
_TAIL = (ctypes.c_int,) * 6 + (ctypes.c_float,) * 5
_TILES = build.Entry("update_color_tiles", "checkerboard_tiles",
                     "ising_update_tiles", (_P, _P) + _TAIL)
_TILES_KEYED = build.Entry("update_color_tiles_keyed", "checkerboard_tiles",
                           "ising_update_tiles_keyed", (_P, _U32, _U32)
                           + _TAIL)
_LINES = build.Entry("update_color_lines", "checkerboard_lines",
                     "ising_update_lines", (_P,) * 6 + _TAIL)
_LINES_KEYED = build.Entry("update_color_lines_keyed", "checkerboard_lines",
                           "ising_update_lines_keyed", (_P, _U32, _U32)
                           + (_P,) * 4 + _TAIL)
_THREEFRY = build.Entry("threefry_bits", "checkerboard_tiles",
                        "ising_threefry_bits",
                        (_P, _U32, _U32, ctypes.c_uint64, ctypes.c_int64))


# ---------------------------------------------------------------------------
# Argument checks shared by both wrappers
# ---------------------------------------------------------------------------


def _check_quads(qb: torch.Tensor, color: int, rule: str) -> str:
    if qb.dim() != 5 or qb.shape[0] != 4 or qb.shape[3] != qb.shape[4]:
        raise ValueError(f"quads must be [4, mr, mc, bs, bs], got "
                         f"{tuple(qb.shape)}")
    if qb.dtype not in build.DTYPE_CODE:
        raise TypeError(f"quads must be float32 or bfloat16, got {qb.dtype}")
    if color not in (0, 1):
        raise ValueError(f"color must be 0 or 1, got {color}")
    canonical = update_rules.get_rule(rule).name
    if canonical not in _RULE_CODE:
        raise ValueError(f"rule {rule!r} has no kernel form")
    return canonical


def _check(qb: torch.Tensor, bits: torch.Tensor, color: int, rule: str):
    rule = _check_quads(qb, color, rule)
    if tuple(bits.shape) != (2,) + tuple(qb.shape[1:]):
        raise ValueError(f"bits must be [2, mr, mc, bs, bs] = "
                         f"{(2,) + tuple(qb.shape[1:])}, got "
                         f"{tuple(bits.shape)}")
    if bits.dtype != torch.int32:
        raise TypeError(f"bits must be int32 (a uint32 bit pattern), got "
                        f"{bits.dtype}")
    if bits.device != qb.device:
        raise ValueError(f"bits on {bits.device}, quads on {qb.device}")
    return rule


def _check_key(key) -> tuple:
    """A colour key: a tuple of two uint32 words (not a key batch)."""
    if not (isinstance(key, tuple) and len(key) == 2
            and all(isinstance(k, numbers.Integral) and not isinstance(k, bool)
                    and 0 <= k <= 0xFFFFFFFF for k in key)):
        raise ValueError(f"key must be one colour key (k0, k1) of two uint32 "
                         f"words, got {key!r}")
    return int(key[0]), int(key[1])


def _roles(color: int):
    """(s0, s1, p0, p1) quad indices and the column step dx of one colour."""
    return (0, 3, 1, 2, -1) if color == 0 else (1, 2, 0, 3, 1)


def _flip_in_place(qb, bits, beta, color, rule, nn0, nn1):
    i0, i1, *_ = _roles(color)
    flip = update_rules.get_rule(rule).kernel_form(float(beta))
    new0 = flip(qb[i0], nn0, bits[0])
    new1 = flip(qb[i1], nn1, bits[1])
    qb[i0] = new0
    qb[i1] = new1
    return qb


# ---------------------------------------------------------------------------
# Kernel 1: tile-fetch halo
# ---------------------------------------------------------------------------


def _torus_shift(x: torch.Tensor, dim: int, d: int) -> torch.Tensor:
    """y[r, c, i, j] = x at (i + d, j) (dim=0) or (i, j + d) (dim=1) of the
    unblocked quad on the torus: off-tile reads land on the neighbour tile."""
    bs = x.shape[-1]
    return L.block(torch.roll(L.unblock(x), -d, dim), bs)


def update_color_tiles_plain(qb, bits, beta: float, color: int,
                             rule: str = "metropolis_lut"):
    """Plain PyTorch version of the tile-fetch kernel, in place."""
    _, _, i_p0, i_p1, dx = _roles(color)
    p0, p1 = qb[i_p0].float(), qb[i_p1].float()
    nn0 = p0 + _torus_shift(p0, 1, dx) + p1 + _torus_shift(p1, 0, -1)
    nn1 = p1 + _torus_shift(p1, 1, -dx) + p0 + _torus_shift(p0, 0, 1)
    return _flip_in_place(qb, bits, beta, color, rule, nn0, nn1)


def update_color_tiles(qb, bits, beta: float, color: int,
                       rule: str = "metropolis_lut"):
    """One colour's half-sweep of ``qb`` in place (tile-fetch halo)."""
    rule = _check(qb, bits, color, rule)
    if not build.on_cuda(_TILES, qb.device, qb, bits):
        return update_color_tiles_plain(qb, bits, beta, color, rule)
    return _launch(_TILES, qb, (bits,), color, rule, beta)


def update_color_tiles_keyed_plain(qb, key, beta: float, color: int,
                                   rule: str = "metropolis_lut"):
    """Plain version of the keyed tile-fetch kernel: ``random.kernel_bits``
    (``random.bits`` as the kernel hashes it) under the colour key, then
    the operand form's plain version."""
    bits = jr.kernel_bits(key, (2,) + tuple(qb.shape[1:]), qb.device)
    return update_color_tiles_plain(qb, bits, beta, color, rule)


def update_color_tiles_keyed(qb, key, beta: float, color: int,
                             rule: str = "metropolis_lut"):
    """One colour's half-sweep of ``qb`` in place (tile-fetch halo), the
    bits drawn in the kernel under the colour key ``(k0, k1)``
    (``fold_in(fold_in(key, step), color)``)."""
    rule = _check_quads(qb, color, rule)
    key = _check_key(key)
    if not build.on_cuda(_TILES_KEYED, qb.device, qb):
        return update_color_tiles_keyed_plain(qb, key, beta, color, rule)
    return _launch(_TILES_KEYED, qb, (), color, rule, beta, key)


# ---------------------------------------------------------------------------
# Kernel 2: edge-line halo
# ---------------------------------------------------------------------------


def _tile_shift(x: torch.Tensor, dim: int, d: int) -> torch.Tensor:
    """y[r, c, i, j] = x[r, c] at (i + d, j) (dim=0) or (i, j + d) (dim=1)
    inside the tile, zero where that leaves the tile."""
    axis = 2 + dim
    y = torch.zeros_like(x)
    n = x.shape[axis]
    if d > 0:
        y.narrow(axis, 0, n - d).copy_(x.narrow(axis, d, n - d))
    else:
        y.narrow(axis, -d, n + d).copy_(x.narrow(axis, 0, n + d))
    return y


def update_color_lines_plain(qb, bits, beta: float, color: int,
                             rule: str = "metropolis_lut", lines=None):
    """Plain PyTorch version of the edge-line kernel, in place. ``lines`` is
    (row0, col0, row1, col1); default: the torus lines of ``qb``."""
    row0, col0, row1, col1 = (_lines(qb, color) if lines is None else lines)
    _, _, i_p0, i_p1, dx = _roles(color)
    p0, p1 = qb[i_p0].float(), qb[i_p1].float()
    nn0 = p0 + _tile_shift(p0, 1, dx) + p1 + _tile_shift(p1, 0, -1)
    nn1 = p1 + _tile_shift(p1, 1, -dx) + p0 + _tile_shift(p0, 0, 1)
    c0 = 0 if dx < 0 else -1          # the j + dx edge of nn0
    nn0[:, :, 0, :] += row0.float()
    nn0[:, :, :, c0] += col0.float()
    nn1[:, :, -1, :] += row1.float()
    nn1[:, :, :, -1 - c0] += col1.float()
    return _flip_in_place(qb, bits, beta, color, rule, nn0, nn1)


def _lines(qb, color: int, edges=None):
    """The colour's four halo lines, contiguous, inside the
    ``repro_torch.kernels.lines`` span (a grid's ``edges`` exchange too)."""
    edges = cb.default_edges if edges is None else edges
    with span("repro_torch.kernels.lines"):
        return tuple(t.contiguous() for t in
                     cb.edge_lines(qb[0], qb[1], qb[2], qb[3], color, edges))


def update_color_lines(qb, bits, beta: float, color: int,
                       rule: str = "metropolis_lut", edges=None):
    """One colour's half-sweep of ``qb`` in place (edge-line halo).
    ``edges(xb, side) -> [mr, mc, bs]`` supplies the halo lines (default:
    torus rolls)."""
    rule = _check(qb, bits, color, rule)
    lines = _lines(qb, color, edges)
    if not build.on_cuda(_LINES, qb.device, qb, bits, *lines):
        return update_color_lines_plain(qb, bits, beta, color, rule, lines)
    return _launch(_LINES, qb, (bits,) + lines, color, rule, beta)


def update_color_lines_keyed_plain(qb, key, beta: float, color: int,
                                   rule: str = "metropolis_lut", lines=None):
    """Plain version of the keyed edge-line kernel: ``random.kernel_bits``
    (``random.bits`` as the kernel hashes it) under the colour key, then
    the operand form's plain version."""
    bits = jr.kernel_bits(key, (2,) + tuple(qb.shape[1:]), qb.device)
    return update_color_lines_plain(qb, bits, beta, color, rule, lines)


def update_color_lines_keyed(qb, key, beta: float, color: int,
                             rule: str = "metropolis_lut", edges=None):
    """One colour's half-sweep of ``qb`` in place (edge-line halo), the
    bits drawn in the kernel under the colour key ``(k0, k1)``."""
    rule = _check_quads(qb, color, rule)
    key = _check_key(key)
    lines = _lines(qb, color, edges)
    if not build.on_cuda(_LINES_KEYED, qb.device, qb, *lines):
        return update_color_lines_keyed_plain(qb, key, beta, color, rule,
                                              lines)
    return _launch(_LINES_KEYED, qb, lines, color, rule, beta, key)


# ---------------------------------------------------------------------------
# Launching
# ---------------------------------------------------------------------------


def _launch(entry: build.Entry, qb, operands: tuple, color: int, rule: str,
            beta: float, key=()):
    """Launch a half-sweep ``entry`` on ``qb`` (its other tensor operands
    in the C entry's order; ``key`` for a keyed form)."""
    _, mr, mc, bs, _ = qb.shape
    if mr > _MAX_GRID_Y or mc > _MAX_GRID_X:
        raise ValueError(f"tile grid {mr} x {mc} exceeds the launch grid "
                         f"({_MAX_GRID_Y} tile rows)")
    build.launch(entry, qb.device, qb, *key, *operands, mr, mc, bs, color,
                 _RULE_CODE[rule], build.DTYPE_CODE[qb.dtype],
                 *update_rules.kernel_table(rule, beta).tolist())
    return qb


def threefry_bits(key, start: int, n: int, device) -> torch.Tensor:
    """The 32-bit draws of counters ``[start, start + n)`` under ``key``
    (int32 bit patterns): on a CUDA device the kernels' own device hash
    (``ising_threefry_bits``, counted in ``build.launches["threefry_bits"]``;
    no sweep calls it), on the CPU ``random._bits_lanes``. It holds the hash
    against the port's RNG on the card."""
    k0, k1 = _check_key(key)
    device = torch.device(device)
    if not build.on_cuda(_THREEFRY, device):
        return jr._as_int32(jr._bits_lanes((k0, k1), start, start + n,
                                           device))
    out = torch.empty(n, dtype=torch.int32, device=device)
    build.launch(_THREEFRY, device, out, k0, k1, start, n)
    return out
