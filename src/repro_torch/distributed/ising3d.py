"""3-D domain decomposition: the [D, H, W] Ising cube over a process grid.

The port of ``repro.distributed.ising3d``: the 3-D binding of the generic
loop (:mod:`repro_torch.distributed.decomp`) over a 3-axis
:class:`repro_torch.distributed.halo.HaloSpec`.

Layout: the plain ``[D, H, W]`` cube placed as ``(depth_axes, row_axes,
col_axes)``; a 2-axis grid leaves depth whole (``depth_axes=()``). Each
rank holds a contiguous ``[ld, lh, lw]`` block; the 6-neighbour stencil is
six ``HaloSpec.neighbor`` calls, local torus rolls whose wrap plane comes
from the adjacent rank.

Bitwise contract: per-site uniforms hash *global* site indices
(:func:`repro_torch.core.ising3d.site_uniforms3d`), parity masks come from
global offsets, and neighbour sums are small integers, exact in bf16, so a
decomposed chain equals :func:`repro_torch.core.ising3d.run_sweeps3d` on
one device bitwise, on any grid.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as jr
from repro_torch.core import ising3d as I3
from repro_torch.core import measure
from repro_torch.distributed import decomp
from repro_torch.distributed import halo


@dataclasses.dataclass(frozen=True)
class Dist3DConfig:
    """Which grid axes shard which lattice axis (empty tuple: unsharded)."""
    beta: float
    depth_axes: tuple = ()
    row_axes: tuple = ("data",)
    col_axes: tuple = ("model",)


def halo_spec(grid, cfg: Dist3DConfig) -> halo.HaloSpec:
    return halo.HaloSpec.from_mesh(
        grid, (cfg.depth_axes, cfg.row_axes, cfg.col_axes))


def lattice_spec(grid, cfg: Dist3DConfig) -> tuple:
    """Placement of the global [D, H, W] cube."""
    return halo_spec(grid, cfg).partition_spec()


def mesh_model(grid, cfg: Dist3DConfig) -> decomp.MeshModel:
    """The 3-D cube binding of the generic decomposition loop."""
    spec = halo_spec(grid, cfg)
    beta = cfg.beta
    n_dev = spec.n_devices()

    def nn_halo(lf):
        """6-neighbour sums with rank-boundary planes shifted in (integer
        sums, exact in bf16)."""
        out = torch.zeros_like(lf)
        for dim in range(3):
            out = out + spec.neighbor(lf, dim, +1) \
                      + spec.neighbor(lf, dim, -1)
        return out

    def sweep(lf, key, step):
        gi = spec.global_index(lf.shape, lf.device)
        offs = spec.offsets(lf.shape)
        for color in (0, 1):
            k = jr.fold_in(jr.fold_in(key, step), color)
            probs = I3.site_uniforms3d(k, gi)
            mask = I3.parity_mask3d(lf.shape, color, lf.device, offs)
            lf = I3.update_color3d(lf, probs, beta, color, nn_fn=nn_halo,
                                   mask=mask)
        return lf

    def stats(lf):
        f = lf.float()
        bonds = sum(spec.neighbor(lf, dim, +1).float() for dim in range(3))
        return measure.Totals(grid.psum(torch.sum(f)),
                              grid.psum(torch.sum(f * bonds)),
                              lf.numel() * n_dev)

    return decomp.MeshModel(state_spec=spec.partition_spec(),
                            sweep=sweep, stats=stats)


def make_run_sweeps_fn(grid, cfg: Dist3DConfig, n_sweeps: int):
    """Measurement-free decomposed 3-D chain ``run(local, key) -> local``,
    bitwise :func:`repro_torch.core.ising3d.run_sweeps3d` under the same
    key."""
    return decomp.make_run_sweeps_fn(grid, mesh_model(grid, cfg), n_sweeps)


def make_run_chain_fn(grid, cfg: Dist3DConfig, n_sweeps: int,
                      measure_every: int = 1):
    """Measured decomposed 3-D chain
    ``run(local, key) -> (local, Moments)``."""
    return decomp.make_run_chain_fn(grid, mesh_model(grid, cfg), n_sweeps,
                                    measure_every)


def global_stats(grid, cfg: Dist3DConfig):
    """Exact global ``(m, E/spin)`` of the decomposed cube."""
    return decomp.global_stats(grid, mesh_model(grid, cfg))
