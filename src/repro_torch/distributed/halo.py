"""N-dimensional halo exchange for spatially decomposed lattices (§4.2.2).

The port of ``repro.distributed.halo``. The paper splits the lattice into
per-core sub-lattices that exchange boundary lines; here each sub-lattice
is the block of one rank of a :class:`repro_torch.launch.mesh.DeviceGrid`
and the exchange is a ring shift over ``torch.distributed``.

* :class:`HaloSpec` maps the d lattice axes onto grid axes (one
  :class:`HaloAxis` per lattice dimension: grid axis names and shard
  count) and, bound to a grid, gives the primitives every decomposed plane
  uses:

  - ``send(plane, dim, delta)``: shift a boundary plane ``delta`` hops
    along the ring of lattice axis ``dim`` (the identity when that axis has
    one shard, so single-rank runs take the local torus wrap);
  - ``neighbor(x, dim, delta)``: each site's neighbour ``delta`` steps
    along ``dim`` on the global torus, a local roll whose wrap plane is
    the one received from the adjacent rank;
  - ``offsets`` / ``global_index``: global coordinates of the local
    block, the counters of the decomposition-independent RNG.

* :func:`blocked_quad_edges` is the 2-D blocked-quad edge provider with
  the ``edges(xb, side)`` contract of
  :func:`repro_torch.core.checkerboard.default_edges`: interior blocks
  resolve by local rolls, blocks on a rank boundary take the neighbouring
  rank's line. It feeds the XLA-form half-update and the CUDA lines
  kernel alike.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import checkerboard as cb
from repro_torch.launch.mesh import as_axes


def _slc(ndim: int, dim: int, i):
    """Index tuple selecting plane ``i`` of axis ``dim`` (others full)."""
    idx = [slice(None)] * ndim
    idx[dim] = i
    return tuple(idx)


@dataclasses.dataclass(frozen=True)
class HaloAxis:
    """One lattice axis of a decomposition: which grid axes shard it (an
    empty tuple: unsharded) and the shard count."""
    mesh_axes: tuple = ()
    n_shards: int = 1


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """d-axis decomposition: ``axes[i]`` shards lattice axis i; ``grid``
    is this rank's grid (None: one rank)."""
    axes: tuple  # of HaloAxis, one per lattice dimension
    grid: object = None

    @classmethod
    def from_mesh(cls, grid, lattice_axes) -> "HaloSpec":
        """Build from per-lattice-dim grid axis names (str, tuple, or None
        for an unsharded dim); shard counts come from the grid."""
        return cls(tuple(HaloAxis(as_axes(a), grid.axis_size(a))
                         for a in lattice_axes), grid)

    @property
    def ndim(self) -> int:
        return len(self.axes)

    def shard_counts(self) -> tuple:
        return tuple(ax.n_shards for ax in self.axes)

    def n_devices(self) -> int:
        n = 1
        for ax in self.axes:
            n *= ax.n_shards
        return n

    def mesh_axis_names(self) -> tuple:
        """All grid axis names this decomposition shards over, flattened in
        lattice-dim order."""
        names: tuple = ()
        for ax in self.axes:
            names += ax.mesh_axes
        return names

    def partition_spec(self, leading: int = 0, trailing: int = 0) -> tuple:
        """The placement of each lattice dim on its grid axes (see
        :meth:`repro_torch.launch.mesh.DeviceGrid.gather`), with
        ``leading``/``trailing`` extra unsharded dims."""
        return ((None,) * leading
                + tuple(ax.mesh_axes or None for ax in self.axes)
                + (None,) * trailing)

    # -- this rank's geometry ----------------------------------------------

    def axis_index(self, dim: int) -> int:
        """This rank's position along lattice axis ``dim``'s shard grid
        (0 when unsharded)."""
        ax = self.axes[dim]
        if not ax.mesh_axes:
            return 0
        return self.grid.axis_index(ax.mesh_axes)

    def linear_device_index(self) -> int:
        """Row-major linear index over the full shard grid."""
        idx = 0
        for dim in range(self.ndim):
            idx = idx * self.axes[dim].n_shards + self.axis_index(dim)
        return idx

    def offsets(self, local_shape: tuple) -> tuple:
        """Global coordinate of the local block's origin, per dim."""
        return tuple(self.axis_index(d) * local_shape[d]
                     for d in range(self.ndim))

    def global_shape(self, local_shape: tuple) -> tuple:
        return tuple(local_shape[d] * self.axes[d].n_shards
                     for d in range(self.ndim))

    def global_index(self, local_shape: tuple, device="cpu") -> torch.Tensor:
        """int32 [*local_shape] global linear site indices of the local
        block: the counters the decomposition-independent RNG hashes."""
        offs = self.offsets(local_shape)
        gshape = self.global_shape(local_shape)
        gi = torch.zeros((1,) * self.ndim, dtype=torch.int32, device=device)
        for d in range(self.ndim):
            coord = offs[d] + torch.arange(local_shape[d], dtype=torch.int32,
                                           device=device)
            shape = [1] * self.ndim
            shape[d] = local_shape[d]
            gi = gi * gshape[d] + coord.view(shape)
        return gi.expand(tuple(local_shape)).contiguous()

    # -- the exchange primitives -------------------------------------------

    def send(self, plane: torch.Tensor, dim: int, delta: int) -> torch.Tensor:
        """Shift ``plane`` by ``delta`` hops along axis ``dim``'s ring of
        ranks (rank k receives the plane of rank k - delta); the identity
        when the axis is unsharded, matching the local torus wrap."""
        ax = self.axes[dim]
        if ax.n_shards == 1:
            return plane
        return self.grid.send(plane, ax.mesh_axes, delta)

    def plane(self, x: torch.Tensor, dim: int, delta: int) -> torch.Tensor:
        """The boundary plane this rank's ``delta``-neighbour along ``dim``
        contributes to the halo: its first plane for delta=+1, its last for
        delta=-1 (local wrap when unsharded)."""
        src = 0 if delta > 0 else -1
        return self.send(x[_slc(x.dim(), dim, src)], dim, -delta)

    def neighbor(self, x: torch.Tensor, dim: int, delta: int) -> torch.Tensor:
        """Each site's neighbour value ``delta`` steps along ``dim`` on the
        global torus: a local roll with the wrap plane overwritten by the
        adjacent rank's boundary plane."""
        ax = self.axes[dim]
        out = torch.roll(x, -delta, dim)
        if ax.n_shards > 1:
            dst = -1 if delta > 0 else 0
            out[_slc(x.dim(), dim, dst)] = self.plane(x, dim, delta)
        return out


# ---------------------------------------------------------------------------
# 2-D blocked-quad edge provider (the Algorithm-2 halo contract)
# ---------------------------------------------------------------------------


def spec2d(row_axes, col_axes, nrows: int, ncols: int,
           grid=None) -> HaloSpec:
    """2-axis HaloSpec from the (row_axes, col_axes) vocabulary."""
    return HaloSpec((HaloAxis(as_axes(row_axes), nrows),
                     HaloAxis(as_axes(col_axes), ncols)), grid)


def blocked_quad_edges(spec: HaloSpec):
    """Edge provider for rank-local blocked quads [mr, mc, bs, bs].

    Same contract as ``core.checkerboard.default_edges``: interior blocks
    resolve locally by rolls; blocks on a sharded rank boundary take the
    line shifted in from the neighbouring rank.
    """
    rows, cols = spec.axes[0], spec.axes[1]

    def edges(xb: torch.Tensor, side: str) -> torch.Tensor:
        e = cb.default_edges(xb, side)          # local torus roll
        if side == "north" and rows.n_shards > 1:
            e[0] = spec.send(xb[-1, :, -1, :], 0, +1)
        elif side == "south" and rows.n_shards > 1:
            e[-1] = spec.send(xb[0, :, 0, :], 0, -1)
        elif side == "west" and cols.n_shards > 1:
            e[:, 0] = spec.send(xb[:, -1, :, -1], 1, +1)
        elif side == "east" and cols.n_shards > 1:
            e[:, -1] = spec.send(xb[:, 0, :, 0], 1, -1)
        return e

    return edges


def halo_edges(row_axes, col_axes, nrows: int, ncols: int, grid=None):
    """The 2-D entry point: an ``edges(xb, side)`` provider over rank-local
    [mr, mc, bs, bs] quads, :func:`blocked_quad_edges` over a 2-axis
    :class:`HaloSpec`."""
    return blocked_quad_edges(spec2d(row_axes, col_axes, nrows, ncols, grid))
