"""Public wrappers around the checkerboard kernels.

The port of ``repro.kernels.ops``. ``sweep(quads, key, step, beta)`` runs
one full lattice sweep (black + white) with counter-based bits, on one of
three backends:

* ``pallas``       — the tile-fetch kernel (``update_color_tiles``)
* ``pallas_lines`` — the edge-line kernel (``update_color_lines``)
* ``ref``          — the plain oracle with identical bit-level semantics

The backend names are the JAX package's; on a CUDA tensor the first two
launch the CUDA kernels, on a CPU tensor their plain versions run. A sweep
on them launches each kernel's keyed form, which draws the colour's bits in
the kernel from the colour key; :func:`update_color` with explicit bits
launches the operand form.
"""
from __future__ import annotations

import torch

from repro_torch import random as jr
from repro_torch.core import lattice as L
from repro_torch.kernels import checkerboard as kern
from repro_torch.kernels import ref as kref
from repro_torch.spans import span


def _block_quads(quads: torch.Tensor, bs: int) -> torch.Tensor:
    """[4, R, C] -> contiguous [4, R/bs, C/bs, bs, bs]."""
    with span("repro_torch.kernels.block"):
        return torch.stack([L.block(quads[i], bs) for i in range(4)])


def _unblock_quads(qb: torch.Tensor) -> torch.Tensor:
    with span("repro_torch.kernels.unblock"):
        return torch.stack([L.unblock(qb[i]) for i in range(4)])


def color_key(key, step: int, color: int):
    """The key of one colour update: ``fold_in(fold_in(key, step), color)``."""
    return jr.fold_in(jr.fold_in(key, step), color)


def color_bits(key, step: int, color: int, shape, device="cpu"):
    """uint32 bits (int32 pattern) for the two active quads of one colour
    update: ``bits(color_key(key, step, color), (2,) + shape)``."""
    return jr.bits(color_key(key, step, color), (2,) + tuple(shape), device)


def update_color(quads_blocked, bits, beta: float, color: int,
                 backend: str = "pallas", edges=None,
                 rule: str = "metropolis_lut"):
    """One colour update; returns the updated stack.

    The ``pallas`` and ``pallas_lines`` kernels update ``quads_blocked`` in
    place and return it; ``ref`` returns a new stack.
    """
    if backend == "pallas":
        return kern.update_color_tiles(quads_blocked, bits, beta, color, rule)
    if backend == "pallas_lines":
        return kern.update_color_lines(quads_blocked, bits, beta, color, rule,
                                       edges)
    if backend == "ref":
        kh = L.kernel_compact(quads_blocked.shape[-1], quads_blocked.dtype,
                              quads_blocked.device)
        return kref.update_color_ref(quads_blocked, bits, kh, beta, color,
                                     rule)
    raise ValueError(f"unknown backend {backend!r}")


# The kernels' keyed forms, which draw ``color_bits`` themselves.
_KEYED = {"pallas": kern.update_color_tiles_keyed,
          "pallas_lines": kern.update_color_lines_keyed}


def sweep_blocked(qb, key, step: int, beta: float, backend: str,
                  rule: str = "metropolis_lut"):
    """One sweep of blocked quads [4, mr, mc, bs, bs]: black, then white,
    each under its own ``color_key`` (the kernels draw the bits; ``ref``
    takes ``color_bits``)."""
    for color in (0, 1):
        if backend in _KEYED:
            qb = _KEYED[backend](qb, color_key(key, step, color), beta,
                                 color, rule)
        else:
            bits = color_bits(key, step, color, qb.shape[1:], qb.device)
            qb = update_color(qb, bits, beta, color, backend, rule=rule)
    return qb


def sweep(quads, key, step: int, *, beta: float, bs: int = L.MXU_BLOCK,
          backend: str = "pallas",
          rule: str = "metropolis_lut") -> torch.Tensor:
    """One full sweep of [4, R, C] compact quads. Returns new quads."""
    qb = sweep_blocked(_block_quads(quads, bs), key, step, beta, backend,
                        rule)
    return _unblock_quads(qb)


def run_sweeps(quads, key, *, n_sweeps: int, beta: float,
               bs: int = L.MXU_BLOCK, backend: str = "pallas",
               rule: str = "metropolis_lut") -> torch.Tensor:
    """Measurement-free multi-sweep loop on the kernel path."""
    qb = _block_quads(quads, bs)
    for step in range(n_sweeps):
        qb = sweep_blocked(qb, key, step, beta, backend, rule)
    return _unblock_quads(qb)
