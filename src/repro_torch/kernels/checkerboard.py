"""The two checkerboard half-sweep kernels: CUDA wrappers and plain versions.

Each kernel updates one colour of blocked compact quads
``qb[4, mr, mc, bs, bs]`` in place, from uint32 bits ``[2, mr, mc, bs, bs]``
held as an int32 bit pattern, and returns ``qb``:

* :func:`update_color_tiles` replaces the Pallas kernel
  ``update_color_pallas`` (``src/repro/kernels/checkerboard.py``, body
  ``_update_kernel``): the halo comes from the torus-neighbour tiles.
  Source: ``csrc/checkerboard_tiles.cu``.
* :func:`update_color_lines` replaces ``update_color_pallas_lines`` (body
  ``_update_kernel_lines``): the four halo lines come from
  ``core.checkerboard.edge_lines`` outside the kernel.
  Source: ``csrc/checkerboard_lines.cu``.

Both are memory-bound stencils: per colour they read four quads and two
bit planes and write two quads, 2.10 GB at L = 20480 in bf16, 0.63 ms at
the H100's 3.35 TB/s. No single PyTorch call computes this function.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor,
and only there, it runs the plain PyTorch version beside it, which repeats
the kernel's arithmetic (four-neighbour adds in f32, then the rule's
select and compare). Each wrapper counts its launches in a plain integer,
``launches[name]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import checkerboard as cb
from repro_torch.core import lattice as L
from repro_torch.core import update_rules
from repro_torch.kernels import build

launches = {"update_color_tiles": 0, "update_color_lines": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_RULE_CODE = {"metropolis_lut": 0, "metropolis_exp": 0, "heat_bath": 1}
# Threads per block in the kernels (kThreads); gridDim.y caps the tile area.
_THREADS, _MAX_GRID_Y = 256, 65535


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Argument checks shared by both wrappers
# ---------------------------------------------------------------------------


def _check(qb: torch.Tensor, bits: torch.Tensor, color: int, rule: str):
    if qb.dim() != 5 or qb.shape[0] != 4 or qb.shape[3] != qb.shape[4]:
        raise ValueError(f"quads must be [4, mr, mc, bs, bs], got "
                         f"{tuple(qb.shape)}")
    if tuple(bits.shape) != (2,) + tuple(qb.shape[1:]):
        raise ValueError(f"bits must be [2, mr, mc, bs, bs] = "
                         f"{(2,) + tuple(qb.shape[1:])}, got "
                         f"{tuple(bits.shape)}")
    if qb.dtype not in _DTYPE_CODE:
        raise TypeError(f"quads must be float32 or bfloat16, got {qb.dtype}")
    if bits.dtype != torch.int32:
        raise TypeError(f"bits must be int32 (a uint32 bit pattern), got "
                        f"{bits.dtype}")
    if bits.device != qb.device:
        raise ValueError(f"bits on {bits.device}, quads on {qb.device}")
    if color not in (0, 1):
        raise ValueError(f"color must be 0 or 1, got {color}")
    canonical = update_rules.get_rule(rule).name
    if canonical not in _RULE_CODE:
        raise ValueError(f"rule {rule!r} has no kernel form")
    return canonical


def _check_cuda(qb: torch.Tensor, bits: torch.Tensor, *lines):
    if qb.device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA or (plain) CPU tensors, "
                         f"got {qb.device}")
    for t in (qb, bits) + lines:
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    bs, tiles = qb.shape[-1], qb.shape[1] * qb.shape[2]
    if -(-bs * bs // _THREADS) > _MAX_GRID_Y or tiles >= 2 ** 31:
        raise ValueError(f"grid {tuple(qb.shape[1:3])} x bs {bs} exceeds the "
                         "launch grid")


def _table_args(rule: str, beta: float):
    return [ctypes.c_float(float(v))
            for v in update_rules.kernel_table(rule, beta)]


def _kernel(lib_name: str, fn_name: str, n_ptrs: int):
    """The C entry point of a kernel library, with its signature set:
    ``n_ptrs`` pointers, six ints, five table floats, the stream."""
    fn = getattr(build.load(lib_name), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    return fn


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


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
    if qb.device.type == "cpu":
        return update_color_tiles_plain(qb, bits, beta, color, rule)
    _check_cuda(qb, bits)
    fn = _kernel("checkerboard_tiles", "ising_update_tiles", 2)
    _, mr, mc, bs, _ = qb.shape
    with torch.cuda.device(qb.device):
        err = fn(_ptr(qb), _ptr(bits), mr, mc, bs, color, _RULE_CODE[rule],
                 _DTYPE_CODE[qb.dtype], *_table_args(rule, beta),
                 _stream(qb.device))
    if err:
        raise RuntimeError(f"ising_update_tiles launch failed: "
                           f"cudaError {err}")
    launches["update_color_tiles"] += 1
    return qb


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
    edges = cb.default_edges if edges is None else edges
    return tuple(t.contiguous() for t in
                 cb.edge_lines(qb[0], qb[1], qb[2], qb[3], color, edges))


def update_color_lines(qb, bits, beta: float, color: int,
                       rule: str = "metropolis_lut", edges=None):
    """One colour's half-sweep of ``qb`` in place (edge-line halo).
    ``edges(xb, side) -> [mr, mc, bs]`` supplies the halo lines (default:
    torus rolls)."""
    rule = _check(qb, bits, color, rule)
    lines = _lines(qb, color, edges)
    if qb.device.type == "cpu":
        return update_color_lines_plain(qb, bits, beta, color, rule, lines)
    _check_cuda(qb, bits, *lines)
    fn = _kernel("checkerboard_lines", "ising_update_lines", 6)
    _, mr, mc, bs, _ = qb.shape
    with torch.cuda.device(qb.device):
        err = fn(_ptr(qb), _ptr(bits), *(_ptr(t) for t in lines), mr, mc,
                 bs, color, _RULE_CODE[rule], _DTYPE_CODE[qb.dtype],
                 *_table_args(rule, beta), _stream(qb.device))
    if err:
        raise RuntimeError(f"ising_update_lines launch failed: "
                           f"cudaError {err}")
    launches["update_color_lines"] += 1
    return qb
