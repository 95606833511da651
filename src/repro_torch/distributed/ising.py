"""Multi-rank Ising sampler: spatial domain decomposition over a grid.

The port of ``repro.distributed.ising``. The global lattice (compact
blocked layout ``[4, MR, MC, bs, bs]``) is split with grid rows over
``row_axes`` (``("pod", "data")`` on a three-axis grid: the pod axis
extends the lattice, as adding TPU units does in the paper's Table 2) and
grid cols over ``col_axes``. Each rank updates its block
``[4, mr, mc, bs, bs]`` with the compact Algorithm-2 math of one device,
its halo lines shifted in from the neighbouring ranks
(:func:`repro_torch.distributed.halo.blocked_quad_edges`).

Three forms of the colour update, as in the reference:

* the paper pipeline: f32 (or bf16) uniforms, float acceptance;
* the opt pipeline: uint32 (or uint16) bits and the integer-threshold
  compare (``update_rules.flip_bits_int``), decisions bitwise those of the
  f32 LUT on the same bits;
* ``backend="pallas_lines"``: one launch per colour of the CUDA lines
  kernel's keyed form
  (:func:`repro_torch.kernels.checkerboard.update_color_lines_keyed`,
  which draws the colour's bits in the kernel), its four halo lines from
  the edge provider over the group.

RNG: each rank folds the chain key with its linear grid index, then with
(step, colour), so no random bits cross ranks. ``rng="rbg"`` stands for
the reference's ``lax.rng_bit_generator`` (platform-defined bits, so not
bitwise the reference's): the opt pipeline's bits come from the device's
own generator (Philox on CUDA, mt19937 on the CPU) seeded with the folded
key's two words, so one key gives the same bits on the same device and a
resumed chain repeats its draws.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as jr
from repro_torch.core import checkerboard as cb
from repro_torch.core import lattice as L
from repro_torch.core import measure
from repro_torch.core import update_rules
from repro_torch.distributed import decomp
from repro_torch.distributed import halo
from repro_torch.kernels import checkerboard as kern
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class DistIsingConfig:
    beta: float
    block_size: int = L.MXU_BLOCK
    row_axes: tuple = ("data",)
    col_axes: tuple = ("model",)
    accept: str = "lut"
    backend: str = "xla"        # "xla" | "pallas_lines"
    prob_dtype: str = "float32"
    # "paper": uniforms + float acceptance; "opt": raw bits + the exact
    # integer-threshold acceptance (same flip decisions as the f32 LUT).
    pipeline: str = "paper"
    bits_dtype: str = "uint32"  # "uint16": the draw's low 16 bits (opt)
    rng: str = "threefry"       # "threefry" | "rbg" (the device generator)
    rule: str = "metropolis"    # update_rules name: "metropolis"|"heat_bath"

    def __post_init__(self):
        if self.rng not in ("threefry", "rbg"):
            raise ValueError(f"rng must be 'threefry' or 'rbg', "
                             f"got {self.rng!r}")
        if self.bits_dtype not in ("uint32", "uint16"):
            raise ValueError(f"bits_dtype must be 'uint32' or 'uint16', "
                             f"got {self.bits_dtype!r}")
        if self.backend not in ("xla", "pallas_lines"):
            raise ValueError(f"backend must be 'xla' or 'pallas_lines', "
                             f"got {self.backend!r}")

    def probs_rule(self) -> str:
        """Registry name for the float-probs (paper-pipeline) path."""
        return ("heat_bath" if self.rule == "heat_bath" else self.accept)

    def bits_rule(self) -> str:
        """Registry name for the bits paths (opt pipeline / kernel)."""
        return ("heat_bath" if self.rule == "heat_bath"
                else "metropolis_lut")


def lattice_spec(cfg: DistIsingConfig) -> tuple:
    """Placement of the [4, MR, MC, bs, bs] global blocked quads."""
    return (None, cfg.row_axes, cfg.col_axes, None, None)


def _device_key(key, cfg: DistIsingConfig, grid):
    row = grid.axis_index(cfg.row_axes)
    col = grid.axis_index(cfg.col_axes)
    return jr.fold_in(key, row * grid.axis_size(cfg.col_axes) + col)


def rbg_bits(k, shape, device) -> torch.Tensor:
    """``rng="rbg"``'s uint32 bits (an int32 pattern) for key ``k``: the
    device generator seeded with the key's two words. The same key gives
    the same bits on the same device; CPU and CUDA generators differ.
    ``meta`` tensors hold no values and have no generator."""
    gen = None
    if torch.device(device).type != "meta":
        gen = torch.Generator(device)
        gen.manual_seed((k[0] << 32) | k[1])
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                         generator=gen, device=device)


def _draw_bits(k, shape, cfg: DistIsingConfig, device) -> torch.Tensor:
    """Bits for one colour update: uint32 as an int32 pattern, or the low
    16 bits of the same 32-bit draw as an int16 pattern (as
    ``jax.random.bits``'s uint16 under threefry)."""
    if cfg.rng == "rbg":
        bits = rbg_bits(k, shape, device)
    else:
        bits = jr.bits(k, shape, device)
    if cfg.bits_dtype == "uint16":
        bits = ((bits & 0xFFFF) ^ 0x8000) - 0x8000   # sign-extend 16 bits
        bits = bits.to(torch.int16)
    return bits


def _local_color_update(qb, key, step, color, cfg, edges,
                        return_stats: bool = False):
    """One colour update of the rank-local stack ``qb`` [4, mr, mc, bs, bs],
    in place; returns ``qb``.

    ``return_stats`` also returns ``(new0, new1, nn0, nn1)`` so the
    measured sweep forms the bond energy from the sums the update already
    computed (XLA form only: the kernel keeps its sums to itself, and the
    caller recomputes them with ``measure.blocked_stats``).
    """
    k = jr.fold_in(jr.fold_in(key, step), color)
    blk = tuple(qb.shape[1:])
    if cfg.backend == "pallas_lines":
        # the keyed lines kernel draws bits(k, (2,) + blk) itself
        qb = kern.update_color_lines_keyed(qb, k, cfg.beta, color,
                                           cfg.bits_rule(), edges)
        return (qb, None) if return_stats else qb
    a, b, c, d = qb.unbind(0)
    kh = L.kernel_compact(a.shape[-1], a.dtype, a.device)
    if color == 0:
        nn0, nn1 = cb.nn_black(a, b, c, d, kh, edges)
        i0, i1 = 0, 3
    else:
        nn0, nn1 = cb.nn_white(a, b, c, d, kh, edges)
        i0, i1 = 1, 2
    s0, s1 = qb[i0], qb[i1]
    if cfg.pipeline == "opt":
        rule = update_rules.get_rule(cfg.bits_rule())
        bits = _draw_bits(k, (2,) + blk, cfg, qb.device)
        new0 = rule.flip_bits_int(s0, nn0.to(s0.dtype), bits[0], cfg.beta)
        new1 = rule.flip_bits_int(s1, nn1.to(s1.dtype), bits[1], cfg.beta)
        qb[i0] = new0
        qb[i1] = new1
    else:  # paper-faithful float pipeline
        probs = jr.uniform(k, (2,) + blk, L.torch_dtype(cfg.prob_dtype),
                           qb.device)
        # written into the stack in place
        new0 = cb._flip(s0, nn0.to(s0.dtype), probs[0], cfg.beta,
                        cfg.probs_rule(), out=s0)
        new1 = cb._flip(s1, nn1.to(s1.dtype), probs[1], cfg.beta,
                        cfg.probs_rule(), out=s1)
    if return_stats:
        return qb, (new0, new1, nn0, nn1)
    return qb


def halo_spec(grid, cfg: DistIsingConfig) -> halo.HaloSpec:
    """The 2-axis :class:`repro_torch.distributed.halo.HaloSpec` of this
    config on ``grid``."""
    return halo.spec2d(cfg.row_axes, cfg.col_axes,
                       grid.axis_size(cfg.row_axes),
                       grid.axis_size(cfg.col_axes), grid)


def make_sweep_fn(grid, cfg: DistIsingConfig):
    """``sweep(qb_local, key, step) -> qb_local`` (a new tensor)."""
    edges = halo.blocked_quad_edges(halo_spec(grid, cfg))

    def sweep(qb, key, step):
        dkey = _device_key(key, cfg, grid)
        qb = qb.clone()
        for color in (0, 1):
            qb = _local_color_update(qb, dkey, step, color, cfg, edges)
        return qb

    return sweep


def make_sweep_tuple_fn(grid, cfg: DistIsingConfig):
    """Sweep over a 4-tuple of rank-local [mr, mc, bs, bs] quads:
    ``sweep(a, b, c, d, key, step) -> (a, b, c, d)``."""
    sweep = make_sweep_fn(grid, cfg)

    def sweep_tuple(a, b, c, d, key, step):
        return tuple(sweep(torch.stack([a, b, c, d]), key, step).unbind(0))

    return sweep_tuple


def mesh_model(grid, cfg: DistIsingConfig) -> decomp.MeshModel:
    """The 2-D Ising quad binding of the generic decomposition loop:
    the per-colour Algorithm-2 update as the site rule, blocked-quad halo
    edges from the :class:`HaloSpec`, and the fused measured sweep that
    reuses the white half-update's own nn sums (XLA form)."""
    spec = halo_spec(grid, cfg)
    edges = halo.blocked_quad_edges(spec)
    n_dev = spec.n_devices()

    def sweep(qb, key, step):
        dkey = _device_key(key, cfg, grid)
        for color in (0, 1):
            qb = _local_color_update(qb, dkey, step, color, cfg, edges)
        return qb

    def stats(qb):
        n_spins = 4 * qb[0].numel() * n_dev
        return measure.blocked_totals(qb.unbind(0), n_spins, edges=edges,
                                      psum=grid.psum)

    def sweep_measured(qb, key, step):
        dkey = _device_key(key, cfg, grid)
        qb = _local_color_update(qb, dkey, step, 0, cfg, edges)
        qb, st = _local_color_update(qb, dkey, step, 1, cfg, edges,
                                     return_stats=True)
        if st is None:  # kernel: one stencil recompute for the sums
            return qb, stats(qb)
        new0, new1, nn0, nn1 = st
        return qb, measure.Totals(
            measure.spin_total(qb.unbind(0), grid.psum),
            measure.bond_total(new0, new1, nn0, nn1, grid.psum),
            4 * qb[0].numel() * n_dev)

    return decomp.MeshModel(
        state_spec=lattice_spec(cfg), sweep=sweep, stats=stats,
        sweep_measured=sweep_measured,
        unpack=torch.clone)   # the run updates its own copy in place


def make_run_sweeps_fn(grid, cfg: DistIsingConfig, n_sweeps: int):
    """``run(qb_local, key) -> qb_local`` (n_sweeps sweeps,
    measurement-free: the paper's throughput loop)."""
    return decomp.make_run_sweeps_fn(grid, mesh_model(grid, cfg), n_sweeps)


def make_sweep_with_bits_fn(grid, cfg: DistIsingConfig):
    """Test entry point: a sweep of the lines-kernel form consuming
    explicit rank-local bits [2, 2, mr, mc, bs, bs] (colour-major), so a
    multi-rank sweep can be held bitwise against one device."""
    edges = halo.blocked_quad_edges(halo_spec(grid, cfg))

    def sweep(qb, bits):
        qb = qb.clone()
        for color in (0, 1):
            qb = kops.update_color(qb, bits[color].contiguous(), cfg.beta,
                                   color, backend="pallas_lines",
                                   edges=edges)
        return qb

    return sweep


def make_run_chain_fn(grid, cfg: DistIsingConfig, n_sweeps: int,
                      measure_every: int = 1):
    """Measured chain: ``run(qb_local, key) -> (qb_local, Moments)``, the
    per-sweep (m, E) from the white half-update's own nn sums (XLA form)
    or one blocked-stencil recompute (kernel), summed over the grid and
    accumulated with ``measure_every`` thinning."""
    return decomp.make_run_chain_fn(grid, mesh_model(grid, cfg), n_sweeps,
                                    measure_every)


def global_stats(grid, cfg: DistIsingConfig):
    """Exact (m, E/spin) of the decomposed blocked lattice."""
    return decomp.global_stats(grid, mesh_model(grid, cfg))
