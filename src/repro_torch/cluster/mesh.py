"""Decomposed cluster updates: Swendsen-Wang / Wolff over a process grid.

The port of ``repro.cluster.mesh``. The lattice stays in the blocked layout
``[4, MR, MC, bs, bs]`` split over the grid
(:func:`repro_torch.distributed.ising.lattice_spec`). Each sweep a rank
rebuilds its local full view (a contiguous ``[lh, lw]`` patch of the
global lattice), then:

1. **Bonds.** Spin halo lines arrive from the neighbouring ranks
   (:class:`repro_torch.distributed.halo.HaloSpec`); bond bits are counter
   hashes of *global* bond indices, so every rank draws exactly the bonds
   one device draws, boundary bonds on both sides alike.
2. **Local labelling.** Connected components of the rank-interior bond
   graph (:func:`repro_torch.cluster.label.label_components`), each local
   root rewritten as its global linear index.
3. **Global merge.** A host loop: exchange boundary label lines, take the
   minimum across active cross-rank bonds, collapse each local cluster to
   its new minimum with one ``scatter_reduce("amin")`` over the fixed local
   roots, and stop when the all-reduced changed flag clears (one
   ``.item()`` an iteration). Labels converge to each cluster's minimum
   global index, the canonical labels of one device.
4. **Flip.** The per-cluster coin is the label hash of one device; a Wolff
   seed site is drawn from the chain key every rank shares and its label
   recovered with one masked-sum all-reduce (an exact integer sum).

Every random decision is a counter hash of global indices, so the
decomposed chain is bitwise the single-device chain. A grid of one rank
never enters the merge. :data:`repro_torch.launch.mesh.counters` counts
merge iterations (``"label_merge"``) beside the all-reduces and sends.

Measurement streams the sweep's global sums through
:func:`repro_torch.core.measure.blocked_totals` with halo edges.
"""
from __future__ import annotations

import torch

from repro_torch import random as jr
from repro_torch.cluster import bonds as B
from repro_torch.cluster import label as LBL
from repro_torch.core import lattice as L
from repro_torch.core import measure
from repro_torch.distributed import decomp
from repro_torch.distributed import halo
from repro_torch.distributed import ising as dising
from repro_torch.launch import mesh as mesh_lib

_INT_MAX = torch.iinfo(torch.int32).max


def _local_full(qb) -> torch.Tensor:
    """[4, mr, mc, bs, bs] rank-local blocked quads -> [lh, lw] full view."""
    return L.from_quads(torch.stack([L.unblock(qb[i]) for i in range(4)]))


def _local_blocked(full, bs: int) -> torch.Tensor:
    q = L.to_quads(full)
    return torch.stack([L.block(q[i], bs) for i in range(4)])


def _device_geometry(qb_local, spec: halo.HaloSpec):
    """(lh, lw, roff, coff, H, W, gi): the local patch's extents, its
    global origin, the global extents and its global site indices."""
    _, mrl, mcl, bs, _ = qb_local.shape
    lh, lw = 2 * mrl * bs, 2 * mcl * bs
    roff, coff = spec.offsets((lh, lw))
    nrows, ncols = spec.shard_counts()
    H, W = lh * nrows, lw * ncols
    gi = B.global_index(lh, lw, roff, coff, W, device=qb_local.device)
    return lh, lw, roff, coff, H, W, gi


def _min_into(dst, cand, bond):
    """``dst = min(dst, cand where bond)`` in place (one boundary line)."""
    dst.copy_(torch.minimum(dst, torch.where(bond, cand, _INT_MAX)))


def global_labels_local(lf, key, spec: halo.HaloSpec, threshold, geometry):
    """Stages 1-3 of a decomposed cluster sweep: FK bonds with spin halos,
    rank-local labelling, and the cross-rank merge.

    Returns this rank's ``[lh, lw]`` patch of the global canonical labels
    (each cluster's minimum global index): bitwise the single-device
    ``label_components`` of the whole lattice. Bonds activate on equality,
    so +-1 spins and Potts colours (:mod:`repro_torch.potts.mesh`) share it.
    """
    lh, lw, roff, coff, H, W, gi = geometry
    nrows, ncols = spec.shard_counts()
    dev = lf.device
    kb = jr.fold_in(key, 0)

    # -- 1. bonds (with spin halos at rank boundaries) ----------------------
    east = spec.neighbor(lf, 1, +1)
    south = spec.neighbor(lf, 0, +1)
    br, bd = B.fk_bonds(lf, kb, threshold, east=east, south=south, gi=gi)

    # the boundary bonds the west / north neighbour owns, drawn here from
    # the same global counters (only across real rank edges)
    if ncols > 1:
        west_spin = spec.plane(lf, 1, -1)
        gi_w = ((roff + torch.arange(lh, dtype=torch.int32, device=dev)) * W
                + (coff - 1) % W)
        bl0 = (lf[:, 0] == west_spin) & B.active(B.bond_bits(kb, gi_w, 0),
                                                 threshold)
    if nrows > 1:
        north_spin = spec.plane(lf, 0, -1)
        gi_n = (((roff - 1) % H) * W + coff
                + torch.arange(lw, dtype=torch.int32, device=dev))
        bu0 = (lf[0, :] == north_spin) & B.active(B.bond_bits(kb, gi_n, 1),
                                                  threshold)

    # -- 2. local labelling (rank-interior bonds, local indices) -----------
    br_loc, bd_loc = br, bd
    if ncols > 1:
        br_loc = br.clone()
        br_loc[:, -1] = False
    if nrows > 1:
        bd_loc = bd.clone()
        bd_loc[-1, :] = False
    root = LBL.label_components(br_loc, bd_loc)             # local index
    glab = (roff + root // lw) * W + coff + root % lw         # -> global

    # -- 3. global merge: boundary labels until no rank changes ------------
    if nrows == 1 and ncols == 1:
        return glab
    grid = spec.grid
    root_flat = root.reshape(-1).long()
    fill = torch.full((lh * lw,), _INT_MAX, dtype=torch.int32, device=dev)
    lab = glab
    while True:
        new = lab.clone()
        if ncols > 1:
            _min_into(new[:, -1], spec.plane(lab, 1, +1), br[:, -1])
            _min_into(new[:, 0], spec.plane(lab, 1, -1), bl0)
        if nrows > 1:
            _min_into(new[-1, :], spec.plane(lab, 0, +1), bd[-1, :])
            _min_into(new[0, :], spec.plane(lab, 0, -1), bu0)
        # collapse every local cluster to its new minimum, so a boundary
        # improvement reaches the opposite boundary in one iteration
        seg = fill.scatter_reduce(0, root_flat, new.reshape(-1), "amin",
                                  include_self=False)
        new = seg[root_flat].view(lh, lw)
        changed = grid.psum(torch.any(new != lab).to(torch.int32))
        mesh_lib.counters["label_merge"] += 1
        lab = new
        if not changed.item():
            return lab


def _local_cluster_sweep(lf, key, spec, algorithm: str, threshold,
                         geometry):
    """One SW/Wolff update of the rank-local full view ``lf``: the new
    view and the global labels."""
    lh, lw, roff, coff, H, W, gi = geometry
    glab = global_labels_local(lf, key, spec, threshold, geometry)
    if algorithm == "swendsen_wang":
        coin = B.counter_bits(jr.fold_in(key, 1), glab)
        flip = ((coin >> 31) & 1) == 1
    elif algorithm == "wolff":
        flip = glab == seed_label(glab, key, gi, H * W, spec.grid)
    else:
        raise ValueError(f"unknown cluster algorithm {algorithm!r}")
    return torch.where(flip, -lf, lf), glab


def seed_label(glab, key, gi, n_sites: int, grid):
    """The global label of the Wolff seed site (``randint`` under
    ``fold_in(key, 2)``, the same on every rank): the rank holding it
    contributes its label, the others 0, summed over the grid."""
    seed = jr.randint(jr.fold_in(key, 2), (), 0, n_sites, glab.device)
    local = torch.sum(torch.where(gi == seed, glab, 0))
    return grid.psum(local)


def mesh_model(grid, cfg: dising.DistIsingConfig,
               algorithm: str) -> decomp.MeshModel:
    """The decomposed cluster binding of the generic loop: one SW/Wolff
    sweep of the rank-local full view as the site rule, blocked totals
    with halo edges as the measurement."""
    spec = dising.halo_spec(grid, cfg)
    threshold = B.bond_threshold_u24(cfg.beta)
    edges = halo.blocked_quad_edges(spec)
    n_dev = spec.n_devices()

    def sweep(qb, key, step):
        geom = _device_geometry(qb, spec)
        new, _ = _local_cluster_sweep(_local_full(qb), jr.fold_in(key, step),
                                      spec, algorithm, threshold, geom)
        return _local_blocked(new, qb.shape[-1])

    def stats(qb):
        n_spins = 4 * qb[0].numel() * n_dev
        return measure.blocked_totals(qb.unbind(0), n_spins, edges=edges,
                                      psum=grid.psum)

    return decomp.MeshModel(state_spec=dising.lattice_spec(cfg),
                            sweep=sweep, stats=stats)


def make_cluster_run_fn(grid, cfg, algorithm: str, n_sweeps: int,
                        measure_every: int = 1):
    """Measured decomposed cluster chain:
    ``run(qb_local, key) -> (qb_local, Moments)``."""
    return decomp.make_run_chain_fn(grid, mesh_model(grid, cfg, algorithm),
                                    n_sweeps, measure_every)


def make_cluster_sweeps_fn(grid, cfg, algorithm: str, n_sweeps: int):
    """Measurement-free decomposed cluster chain:
    ``run(qb_local, key) -> qb_local``."""
    return decomp.make_run_sweeps_fn(grid, mesh_model(grid, cfg, algorithm),
                                     n_sweeps)


def make_labels_fn(grid, cfg):
    """Test entry point: ``labels(qb_local, key) -> [lh, lw] int32``, this
    rank's patch of the global canonical labels of one sweep's bond draw
    (placement ``(row_axes, col_axes)``), held against the single-device
    ``cluster.sweep.labels_for``."""
    spec = dising.halo_spec(grid, cfg)
    threshold = B.bond_threshold_u24(cfg.beta)

    def labels(qb, key):
        geom = _device_geometry(qb, spec)
        _, glab = _local_cluster_sweep(_local_full(qb), key, spec,
                                       "swendsen_wang", threshold, geom)
        return glab

    return labels
