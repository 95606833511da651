"""Process grids: the port's counterpart of ``launch.mesh.make_mesh``.

A JAX mesh names the axes of a device array, ``shard_map`` runs one copy
of a program per device, and ``lax.axis_index`` tells each copy where it
sits. Here every rank of a ``torch.distributed`` group is one shard. A
:class:`DeviceGrid` holds the grid's shape and axis names, this rank's
coordinates (the rank laid out row-major over the shape), the torch device
its blocks live on, and whether a process group carries its collectives:

* :meth:`DeviceGrid.axis_index` flattens a tuple of axes as
  ``lax.axis_index`` does (the first axis slowest);
* :meth:`DeviceGrid.psum` / :meth:`DeviceGrid.pmax` are ``lax.psum`` /
  ``lax.pmax``: over the whole grid (an ``all_reduce`` over the group),
  or over the rings of some of its axes (one ``dist.new_group`` per
  ring, every ring created on every rank in the same order the first
  time those axes reduce); the identity with no group or a one-rank ring;
* :meth:`DeviceGrid.all_gather` concatenates the blocks of a ring of
  ``axes`` in ``axis_index`` order, and :meth:`DeviceGrid.reduce_scatter`
  (its transpose) gives each rank its block of the ring's sum;
* :meth:`DeviceGrid.send` is ``lax.ppermute`` along one ring of the grid:
  rank ``k`` of the ring receives the plane of rank ``k - delta``
  (``batch_isend_irecv``), the identity when the ring has one rank;
* :meth:`DeviceGrid.local_block` / :meth:`DeviceGrid.gather` move between
  a global tensor and the rank blocks under a *placement*: one entry per
  leading tensor dim, the axes that shard it or None (the port's
  ``PartitionSpec``).

The group is the default one (gloo on CPU tensors, NCCL on the card) and
its world size must equal the grid's shard count. ``counters`` counts the
collectives a grid issued (and the cluster label merge's iterations).
:func:`run_ranks` starts a function on N gloo ranks of CPU tensors (the
launcher's ``--devices N`` and the tests).

A :class:`Layout` is a grid's shape and axis names alone, with no ranks:
the sharding rules resolve on it as on a grid
(:func:`production_layout`: the reference's 16 x 16 and 2 x 16 x 16).
:func:`rankless_grid` is one chosen rank of a layout on ``meta`` tensors
(or on a real device) with no process group: its collectives take a real
rank's branches and only record what they would send (the dry-run's
grid). Any grid whose
``records`` is a list appends its collectives there, as
:class:`~repro_torch.analysis.collectives.Collective`.
"""
from __future__ import annotations

import dataclasses
import math
import os
import shutil
import tempfile
import warnings

import torch
import torch.distributed as dist
from torch.utils import _python_dispatch

from repro_torch.analysis.collectives import Collective

# collectives a grid issued (all-reduces, sends, gathers, reduce-scatters),
# and iterations of the cross-rank label merge (repro_torch.cluster.mesh),
# one all-reduce of a changed flag each
counters = {"all_reduce": 0, "send": 0, "gather": 0, "reduce_scatter": 0,
            "label_merge": 0}

# the reference's production meshes (``repro.launch.mesh``)
_PRODUCTION = {False: ((16, 16), ("data", "model")),
               True: ((2, 16, 16), ("pod", "data", "model"))}


def reset_counters() -> None:
    for name in counters:
        counters[name] = 0


def as_axes(axes) -> tuple:
    """Axis names as a tuple (None -> (), a name -> (name,))."""
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def resolve_device(device=None) -> torch.device:
    """The device a rank's blocks live on: ``device`` if given, else the
    CUDA device of this rank (one card per rank), or an error when there
    is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on the CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True)
class Layout:
    """A grid's shape and axis names, with no ranks (what the sharding
    rules read)."""
    shape: tuple
    axes: tuple


def production_layout(multi_pod: bool = False) -> Layout:
    """Single pod: (16, 16), axes (data, model); multi-pod: (2, 16, 16),
    axes (pod, data, model)."""
    return Layout(*_PRODUCTION[multi_pod])


def data_axes(grid) -> tuple:
    """The batch-parallel axes of a grid or layout (pod folds into data)."""
    return tuple(a for a in ("pod", "data") if a in grid.axes)


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """This rank's place on a process grid of ``shape`` named ``axes``."""
    shape: tuple
    axes: tuple
    rank: int
    device: torch.device
    distributed: bool = False   # a process group carries the collectives
    # the collectives issued, in order, when a list (None: not recorded)
    records: list = dataclasses.field(default=None, repr=False,
                                      compare=False, hash=False)
    # axes -> (this rank's ring group, the ring's ranks), made on first use
    _rings: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False, hash=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def coords(self) -> tuple:
        """This rank's coordinates, row-major over ``shape``."""
        return self.coords_of(self.rank)

    def coords_of(self, rank: int) -> tuple:
        out = []
        for n in reversed(self.shape):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def rank_of(self, coords) -> int:
        rank = 0
        for n, c in zip(self.shape, coords):
            rank = rank * n + c
        return rank

    def _dims(self, axes) -> list:
        return [self.axes.index(a) for a in as_axes(axes)]

    def axis_size(self, axes) -> int:
        """Shards along ``axes`` (a name or a tuple; 1 for none)."""
        return math.prod(self.shape[i] for i in self._dims(axes))

    def axis_index(self, axes, coords=None) -> int:
        """Position along ``axes`` of this rank (or of ``coords``), the
        axes flattened first-slowest as ``lax.axis_index`` does."""
        coords = self.coords if coords is None else coords
        idx = 0
        for i in self._dims(axes):
            idx = idx * self.shape[i] + coords[i]
        return idx

    def _ring_rank(self, axes, index: int) -> int:
        """The rank at position ``index`` along ``axes`` that shares this
        rank's coordinates on every other axis."""
        coords = list(self.coords)
        for i in reversed(self._dims(axes)):
            coords[i] = index % self.shape[i]
            index //= self.shape[i]
        return self.rank_of(coords)

    # -- collectives --------------------------------------------------------

    def _ring_ranks(self, axes) -> list:
        """Every ring of ``axes``: its ranks in ``axis_index`` order, the
        rings in the order of their first rank."""
        rings = {}
        for r in range(self.size):
            c = self.coords_of(r)
            rest = tuple(v for i, v in enumerate(c)
                         if i not in self._dims(axes))
            rings.setdefault(rest, []).append((self.axis_index(axes, c), r))
        return [[r for _, r in sorted(ring)] for ring in rings.values()]

    def _ring(self, axes) -> tuple:
        """(the process group of this rank's ring of ``axes``, its ranks in
        ``axis_index`` order). The first call for ``axes`` creates every
        ring's group, on every rank in the same order (``dist.new_group``
        wants all ranks at each call)."""
        axes = as_axes(axes)
        if axes not in self._rings:
            for ranks in self._ring_ranks(axes):
                group = dist.new_group(sorted(ranks))
                if self.rank in ranks:
                    self._rings[axes] = (group, ranks)
        return self._rings[axes]

    def _comm(self, kind: str, ranks, operand: torch.Tensor,
              call, received=()) -> None:
        """Issue one collective of ``operand`` over the ring of ``ranks``
        (``call`` runs it, filling ``received``), recording it when the
        grid records. The result is the operand's size but for an
        all-gather's (one operand a rank, the others' one) and a
        reduce-scatter's (one rank's block of the operand)."""
        if self.records is not None:
            nbytes = operand.numel() * operand.element_size()
            result = {"all-gather": nbytes * len(ranks),
                      "reduce-scatter": nbytes // len(ranks)}.get(kind,
                                                                  nbytes)
            self.records.append(Collective(kind, result, nbytes,
                                           tuple(ranks)))
        call()

    def _reduce(self, x: torch.Tensor, axes, op) -> torch.Tensor:
        if not self.distributed or (axes is not None
                                    and self.axis_size(axes) == 1):
            return x
        group, ranks = ((None, range(self.size)) if axes is None
                        else self._ring(axes))
        buf = x.detach().reshape(-1).clone()
        self._comm("all-reduce", ranks, buf,
                   lambda: dist.all_reduce(buf, op=op, group=group))
        counters["all_reduce"] += 1
        return buf.reshape(x.shape)

    def psum(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """Sum of ``x`` over every rank (``lax.psum`` over the grid), or
        over the ring of ``axes`` through this rank."""
        return self._reduce(x, axes, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """Elementwise maximum of ``x`` over the grid or the ring of
        ``axes`` (``lax.pmax``)."""
        return self._reduce(x, axes, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0
                   ) -> torch.Tensor:
        """The blocks of the ring of ``axes`` through this rank,
        concatenated along ``dim`` in ``axis_index`` order."""
        if not self.distributed or self.axis_size(axes) == 1:
            return x
        counters["gather"] += 1
        return self._ring_gather(x, axes, dim)

    def _ring_gather(self, x, axes, dim):
        group, ranks = self._ring(axes)
        x = x.detach().contiguous()
        blocks = [torch.empty_like(x) for _ in ranks]
        self._comm("all-gather", ranks, x,
                   lambda: dist.all_gather(blocks, x, group=group), blocks)
        by_rank = dict(zip(sorted(ranks), blocks))   # group (sorted) order
        return torch.cat([by_rank[r] for r in ranks], dim)

    def reduce_scatter(self, x: torch.Tensor, axes, dim: int = 0
                       ) -> torch.Tensor:
        """This rank's ``axis_index(axes)`` block along ``dim`` of the sum
        of ``x`` over the ring of ``axes`` (the transpose of
        :meth:`all_gather`); ``x`` itself, its one block, with no group or
        a one-rank ring."""
        n = self.axis_size(axes)
        if not self.distributed or n == 1:
            return x
        counters["reduce_scatter"] += 1
        group, ranks = self._ring(axes)
        dim %= x.dim()
        block = list(x.shape)
        block[dim] //= n
        x = x.detach()
        if dim == 0 and ranks == sorted(ranks):
            x = x.contiguous()
        else:
            # the group scatters the flat operand's n chunks to its ranks
            # in sorted order: lay the blocks out so
            parts = x.split(block[dim], dim)
            x = torch.stack([parts[ranks.index(r)] for r in sorted(ranks)])
        out = x.new_empty(block)

        def scatter():
            with warnings.catch_warnings():
                # newer torch names it reduce_scatter_single, which older
                # ones lack
                warnings.simplefilter("ignore", FutureWarning)
                dist.reduce_scatter_tensor(out.view(-1), x.view(-1),
                                           group=group)

        self._comm("reduce-scatter", ranks, x, scatter, (out,))
        return out

    def send(self, plane: torch.Tensor, axes, delta: int) -> torch.Tensor:
        """Shift ``plane`` ``delta`` hops along the ring of ``axes``: this
        rank receives the plane of the rank ``delta`` hops behind it."""
        n = self.axis_size(axes)
        if n == 1:
            return plane
        k = self.axis_index(axes)
        dst = self._ring_rank(axes, (k + delta) % n)
        src = self._ring_rank(axes, (k - delta) % n)
        out_plane = plane.contiguous()
        in_plane = torch.empty_like(out_plane)

        def exchange():
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, out_plane, dst),
                dist.P2POp(dist.irecv, in_plane, src)])
            for req in reqs:
                req.wait()

        ring = [self._ring_rank(axes, i) for i in range(n)]
        self._comm("collective-permute", ring, out_plane, exchange,
                   (in_plane,))
        counters["send"] += 1
        return in_plane

    # -- global tensors and rank blocks -------------------------------------

    def _block_view(self, full: torch.Tensor, placement, coords):
        out = full
        for dim, axes in enumerate(placement):
            n = self.axis_size(axes)
            if n > 1:
                size = full.shape[dim] // n
                out = out.narrow(dim, self.axis_index(axes, coords) * size,
                                 size)
        return out

    def local_block(self, full: torch.Tensor, placement) -> torch.Tensor:
        """This rank's block of the global ``full`` under ``placement``."""
        return self._block_view(full, placement, self.coords).contiguous()

    def global_shape(self, local_shape, placement) -> tuple:
        shape = list(local_shape)
        for dim, axes in enumerate(placement):
            shape[dim] *= self.axis_size(axes)
        return tuple(shape)

    def gather(self, local: torch.Tensor, placement, dst=None):
        """The global tensor from every rank's block: on every rank
        (``dst=None``: each dim gathered over the ring of its own axes, one
        all-gather a split dim), or on rank ``dst`` only (None elsewhere;
        one gather over the whole grid)."""
        if not self.distributed:
            return local
        local = local.contiguous()
        counters["gather"] += 1
        if dst is None:
            out = local
            for dim, axes in enumerate(placement):
                if self.axis_size(axes) > 1:
                    out = self._ring_gather(out, axes, dim)
            return local.clone() if out is local else out
        # priced as the all-gather it completes on rank dst
        blocks = ([torch.empty_like(local) for _ in range(self.size)]
                  if self.rank == dst else None)
        self._comm("all-gather", range(self.size), local,
                   lambda: dist.gather(local, blocks, dst=dst),
                   blocks or ())
        if self.rank != dst:
            return None
        full = local.new_empty(self.global_shape(local.shape, placement))
        for r, blk in enumerate(blocks):
            self._block_view(full, placement, self.coords_of(r)).copy_(blk)
        return full


class _RanklessGrid(DeviceGrid):
    """One rank of a layout with no process group: every collective takes
    the branches a real rank takes and is recorded, but sends nothing
    (its results keep the shapes a real one gives)."""

    def _ring(self, axes) -> tuple:
        axes = as_axes(axes)
        if axes not in self._rings:
            self._rings[axes] = (None, next(
                r for r in self._ring_ranks(axes) if self.rank in r))
        return self._rings[axes]

    def _comm(self, kind, ranks, operand, call, received=()) -> None:
        super()._comm(kind, ranks, operand, lambda: None)
        if received and not operand.is_meta:
            # as if every rank held this one's operand (finite values on
            # a real device; a reduce-scatter gives this rank's block of
            # it); outside any counting mode, so that a real device's
            # count is the ``meta`` one
            with _python_dispatch._disable_current_modes():
                src = operand
                if kind == "reduce-scatter":
                    src = operand.reshape(len(ranks), -1)[
                        sorted(ranks).index(self.rank)]
                for buf in received:
                    buf.copy_(src.reshape(buf.shape))


def rankless_grid(layout, rank: int = 0, device="meta") -> DeviceGrid:
    """Rank ``rank`` of ``layout`` (a :class:`Layout` or grid) as a grid
    that needs no process group: its tensors live on ``device`` (by
    default ``meta``: shapes only) and its collectives are recorded in
    ``grid.records`` without being sent (on a real device a received
    block is a copy of this rank's own, a reduction this rank's operand
    or its block: the values are finite, not a real rank's)."""
    shape, axes = tuple(layout.shape), tuple(layout.axes)
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} is not on a {shape} grid")
    return _RanklessGrid(shape, axes, rank, torch.device(device),
                         distributed=True, records=[])


def make_grid(shape: tuple, axes: tuple, device=None) -> DeviceGrid:
    """This rank's :class:`DeviceGrid`. With a process group initialised,
    its world size must equal the shard count; without one the grid has
    one shard. A grid never shrinks to fit."""
    shape = tuple(int(n) for n in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"grid shape {shape} and axes {axes} differ in "
                         "length")
    n = math.prod(shape)
    if dist.is_initialized():
        world = dist.get_world_size()
        if world != n:
            raise ValueError(f"a {shape} grid has {n} shards but the "
                             f"process group has {world} ranks")
        device = resolve_device(device)
        if dist.get_backend() == "nccl" and device.type != "cuda":
            raise ValueError(f"the process group's backend is nccl, which "
                             f"carries no {device.type} tensors")
        grid = DeviceGrid(shape, axes, dist.get_rank(), device,
                          distributed=True)
    elif n != 1:
        raise ValueError(f"a {shape} grid has {n} shards and needs a "
                         "process group of as many ranks; none is "
                         "initialised")
    else:
        grid = DeviceGrid(shape, axes, 0, resolve_device(device))
    return grid


def _rank_entry(rank: int, world: int, tmp: str, fn, args) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                            rank=rank, world_size=world)
    try:
        out = fn(*args)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "result.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args):
    """Run ``fn(*args)`` on ``world`` gloo ranks, each a spawned process
    with the default process group initialised, and return rank 0's
    result. ``fn`` must be importable (a module-level function)."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="ranks_")
    try:
        mp.start_processes(_rank_entry, args=(world, tmp, fn, args),
                           nprocs=world, start_method="spawn")
        return torch.load(os.path.join(tmp, "result.pt"),
                          weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
