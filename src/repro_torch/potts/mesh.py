"""Decomposed q-state Potts updates over a process grid: cluster and
checkerboard dynamics, both bindings of the generic loop
(:mod:`repro_torch.distributed.decomp`) over the one halo vocabulary
(:mod:`repro_torch.distributed.halo`).

The port of ``repro.potts.mesh``.

**Cluster plane** (:func:`make_potts_run_fn` / :func:`make_potts_sweeps_fn`):
the colour lattice in the blocked ``[4, MR, MC, bs, bs]`` layout (int32
colours), each sweep rebuilding the rank-local full view and running
:func:`repro_torch.cluster.mesh.global_labels_local` unchanged (FK bonds on
equal colours with the Potts threshold p = 1 - exp(-beta)). Only the
per-cluster decision is new: Swendsen-Wang hashes the merged label into a
colour; Wolff draws its seed site and colour shift from the chain key every
rank shares and recovers the seed's label with one masked-sum all-reduce.

**Checkerboard plane** (:func:`make_potts_cb_run_fn` /
:func:`make_potts_cb_sweeps_fn`): the heat-bath / Metropolis half-updates
of :mod:`repro_torch.potts.rules` on the rank's block of the full
``[H, W]`` int32 view (placement ``(row_axes, col_axes)``, no blocked
layout), with the patch's global site indices, halo neighbour colours and
offset parity masks plugged into the same ``checkerboard_sweep`` one
device runs. Its beta is the config's Python number, so the tables take
the literal (folded) form, as the reference's compiled sweep does.

Every random decision is a counter hash of global indices or a draw from
the shared key, so both planes are bitwise the single-device chains.
Measurement: the order parameter from all-reduced colour counts and the
bond energy from halo-corrected agreement sums, accumulated in the
reference's compiled order (:class:`repro_torch.core.measure.Totals` with
the order parameter's scale).
"""
from __future__ import annotations

import torch

from repro_torch import random as jr
from repro_torch.cluster import bonds as B
from repro_torch.cluster import mesh as cmesh
from repro_torch.core import measure
from repro_torch.distributed import decomp
from repro_torch.distributed import ising as dising
from repro_torch.potts import bonds as PB
from repro_torch.potts import rules as PR
from repro_torch.potts import state as PS
from repro_torch.potts import sweep as psweep


def _local_potts_sweep(lf, key, spec, q: int, algorithm: str, threshold,
                       geometry) -> torch.Tensor:
    """One SW/Wolff colour update of the rank-local full view ``lf``."""
    lh, lw, roff, coff, H, W, gi = geometry
    glab = cmesh.global_labels_local(lf, key, spec, threshold, geometry)
    if algorithm == "swendsen_wang":
        kf = jr.fold_in(key, psweep._K_COINS)
        return PB.cluster_states(PB.counter_bits(kf, glab), q)
    if algorithm == "wolff":
        seed_label = cmesh.seed_label(glab, key, gi, H * W, spec.grid)
        shift = psweep.wolff_target_shift(key, q, lf.device)
        return torch.where(glab == seed_label, (lf + shift) % q, lf)
    raise ValueError(f"unknown cluster algorithm {algorithm!r}; "
                     f"use one of {psweep.ALGORITHMS}")


def _local_totals(lf, spec, q: int, n_spins: int, psum) -> measure.Totals:
    """The sweep's global sums of the rank-local patch: agreement bonds
    (east and south, halo-corrected, each bond once) and the order
    parameter from the all-reduced colour counts, all integer-exact f32."""
    east = spec.neighbor(lf, 1, +1)
    south = spec.neighbor(lf, 0, +1)
    agree = (torch.sum((lf == east).float())
             + torch.sum((lf == south).float()))
    counts = psum(PS.state_counts(lf, q))
    num, scale = PS.order_parameter_terms(counts, q, n_spins)
    return measure.Totals(num, psum(agree), n_spins, m_scale=scale)


# ---------------------------------------------------------------------------
# Cluster plane (blocked layout, shared label machinery)
# ---------------------------------------------------------------------------


def mesh_model(grid, cfg: dising.DistIsingConfig, q: int,
               algorithm: str) -> decomp.MeshModel:
    """The decomposed Potts-cluster binding of the generic loop."""
    spec = dising.halo_spec(grid, cfg)
    threshold = PB.bond_threshold_u24(cfg.beta)
    n_dev = spec.n_devices()

    def sweep(qb, key, step):
        geom = cmesh._device_geometry(qb, spec)
        new = _local_potts_sweep(cmesh._local_full(qb), jr.fold_in(key, step),
                                 spec, q, algorithm, threshold, geom)
        return cmesh._local_blocked(new, qb.shape[-1])

    def stats(qb):
        n_spins = 4 * qb[0].numel() * n_dev
        return _local_totals(cmesh._local_full(qb), spec, q, n_spins,
                             grid.psum)

    return decomp.MeshModel(state_spec=dising.lattice_spec(cfg),
                            sweep=sweep, stats=stats)


def make_potts_run_fn(grid, cfg, q: int, algorithm: str, n_sweeps: int,
                      measure_every: int = 1):
    """Measured decomposed Potts cluster chain:
    ``run(qb_local, key) -> (qb_local, Moments)``."""
    return decomp.make_run_chain_fn(grid, mesh_model(grid, cfg, q, algorithm),
                                    n_sweeps, measure_every)


def make_potts_sweeps_fn(grid, cfg, q: int, algorithm: str, n_sweeps: int):
    """Measurement-free decomposed Potts cluster chain:
    ``run(qb_local, key) -> qb_local``."""
    return decomp.make_run_sweeps_fn(grid, mesh_model(grid, cfg, q,
                                                      algorithm), n_sweeps)


def global_stats(grid, cfg, q: int):
    """``stats(qb_local) -> (order, E/spin)`` of the decomposed blocked
    colour lattice, without gathering it."""
    return decomp.global_stats(grid, mesh_model(grid, cfg, q,
                                                "swendsen_wang"))


# ---------------------------------------------------------------------------
# Checkerboard plane (full [H, W] view, single-site dynamics)
# ---------------------------------------------------------------------------


def cb_mesh_model(grid, cfg: dising.DistIsingConfig, q: int,
                  rule: str) -> decomp.MeshModel:
    """The decomposed Potts-checkerboard binding: the single-device
    ``checkerboard_sweep`` with the patch's geometry plugged in."""
    spec = dising.halo_spec(grid, cfg)
    ncols = spec.shard_counts()[1]
    beta = cfg.beta
    n_dev = spec.n_devices()

    def neighbors_fn(lf):
        # (east, west, south, north), the order of potts.state
        return (spec.neighbor(lf, 1, +1), spec.neighbor(lf, 1, -1),
                spec.neighbor(lf, 0, +1), spec.neighbor(lf, 0, -1))

    def sweep(lf, key, step):
        lh, lw = lf.shape
        roff, coff = spec.offsets((lh, lw))
        gi = B.global_index(lh, lw, roff, coff, lw * ncols, device=lf.device)
        masks = tuple(PR.parity_mask(lh, lw, c, roff, coff, device=lf.device)
                      for c in (0, 1))
        return PR.checkerboard_sweep(lf, jr.fold_in(key, step), beta, q,
                                     rule, gi=gi, neighbors_fn=neighbors_fn,
                                     masks=masks)

    def stats(lf):
        return _local_totals(lf, spec, q, lf.numel() * n_dev, grid.psum)

    return decomp.MeshModel(state_spec=spec.partition_spec(), sweep=sweep,
                            stats=stats)


def make_potts_cb_run_fn(grid, cfg, q: int, rule: str, n_sweeps: int,
                         measure_every: int = 1):
    """Measured decomposed Potts checkerboard chain over the full view:
    ``run(full_local, key) -> (full_local, Moments)``."""
    return decomp.make_run_chain_fn(grid, cb_mesh_model(grid, cfg, q, rule),
                                    n_sweeps, measure_every)


def make_potts_cb_sweeps_fn(grid, cfg, q: int, rule: str, n_sweeps: int):
    """Measurement-free decomposed Potts checkerboard chain:
    ``run(full_local, key) -> full_local``."""
    return decomp.make_run_sweeps_fn(grid, cb_mesh_model(grid, cfg, q, rule),
                                     n_sweeps)


def cb_global_stats(grid, cfg, q: int):
    """``stats(full_local) -> (order, E/spin)`` of the decomposed full-view
    colour lattice."""
    return decomp.global_stats(grid, cb_mesh_model(grid, cfg, q,
                                                   "heat_bath"))
