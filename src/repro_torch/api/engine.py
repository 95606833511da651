"""`IsingEngine`: the config-driven front door, ported to PyTorch.

The port of ``repro.api.engine``. :class:`EngineConfig` keeps every field
and the whole of ``validate()``, so an invalid configuration raises the
same :class:`EngineConfigError`. Every scenario of the reference runs:

* ``"chain"``  (``backend="xla"``): paper Algorithm 2 in plain PyTorch
  (:mod:`repro_torch.core.sampler`), per-sweep ``(m, E)`` from the white
  half-update's own neighbour sums;
* ``"kernel"`` (``backend="pallas"``, ``"pallas_lines"`` or ``"ref"``): the
  lattice stays blocked ``[4, MR, MC, bs, bs]`` through the run, each colour
  is one launch of a CUDA kernel on the card
  (:mod:`repro_torch.kernels.checkerboard`; ``"ref"`` runs the plain
  oracle), and measured runs stream ``(m, E)`` via
  ``measure.blocked_stats`` (on the card one launch of the measurement
  kernel a sweep, :mod:`repro_torch.kernels.measure`);
* ``"ensemble"``: R chains at the betas of ``cfg.betas``, replicas on the
  leading axis of the state ``[R, 4, r, c]``;
* ``"tempering"``: replica exchange (:mod:`repro_torch.core.tempering`);
* ``"3d"``: the [D, H, W] cube (:mod:`repro_torch.core.ising3d`);
* ``"cluster"``: Swendsen-Wang / Wolff (:mod:`repro_torch.cluster`), one
  beta or a betas ensemble;
* ``"potts_cb"`` / ``"potts_cluster"``: the q-state Potts model
  (:mod:`repro_torch.potts`), checkerboard heat-bath / Metropolis or
  Swendsen-Wang / Wolff, one beta or an ensemble;
* ``"mesh"`` (``topology="mesh"``) and ``"opt"`` (``pipeline="opt"`` on
  one device): the decomposed 2-D lattice
  (:mod:`repro_torch.distributed.ising`) on a process grid of
  ``mesh_shape`` (one rank for ``"opt"``), the state this rank's block
  ``[4, mr, mc, bs, bs]``; ``backend="pallas_lines"`` launches the CUDA
  lines kernel per colour with its halo lines from the grid;
* ``"mesh3d"``: the decomposed cube (:mod:`repro_torch.distributed.
  ising3d`), the state this rank's ``[ld, lh, lw]`` block;
* ``"cluster_mesh"`` / ``"potts_cluster_mesh"``: Swendsen-Wang / Wolff on
  the decomposed blocked lattice with the cross-rank label merge
  (:mod:`repro_torch.cluster.mesh`, :mod:`repro_torch.potts.mesh`);
  ``"potts_cb_mesh"``: the Potts checkerboard on this rank's block of the
  ``[H, W]`` colour view;
* an ``"ensemble"`` with ``topology="mesh"``: the replicas split evenly
  over ``replica_axes``, this rank stepping its contiguous share (replica
  i still keyed ``fold_in(key, i)``); series and moments come back
  gathered in the ``[n_replicas]`` layout, the state is this rank's share.

The grid scenarios need a ``torch.distributed`` group whose world size is
the shard count (none for one shard), and stream moments only, as the
reference does. RNG contract as in the reference: ``simulate(seed)``
splits ``PRNGKey(seed)`` into init and chain keys; replica i of an
ensemble is bitwise a single chain keyed ``fold_in(key, i)``; and the run
is bitwise equal to the JAX engine's from the same seed, on as many ranks
as the JAX run has devices (``tests/test_torch_*.py``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; keys are host-side ``(k0, k1)`` pairs
(:mod:`repro_torch.random`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import random as jr
from repro_torch.cluster import bonds as cbonds
from repro_torch.cluster import mesh as cmesh
from repro_torch.cluster import sweep as csweep
from repro_torch.core import checkerboard as cb
from repro_torch.core import ising3d as I3
from repro_torch.core import lattice as L
from repro_torch.core import measure
from repro_torch.core import observables as obs
from repro_torch.core import sampler
from repro_torch.core import tempering as pt
from repro_torch.distributed import ising as dising
from repro_torch.distributed import ising3d as d3
from repro_torch.kernels import ops as kops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.potts import bonds as potts_bonds
from repro_torch.potts import mesh as potts_mesh
from repro_torch.potts import rules as potts_rules
from repro_torch.potts import state as potts_state
from repro_torch.potts import sweep as potts_sweep
from repro_torch.spans import span

_BACKENDS = ("xla", "pallas", "pallas_lines", "ref")
_TOPOLOGIES = ("single", "mesh")
_PIPELINES = ("paper", "opt")
_ENSEMBLES = ("independent", "tempering")
_RULES = ("metropolis", "heat_bath")
_ALGORITHMS = ("metropolis", "swendsen_wang", "wolff")
_MODELS = ("ising", "potts")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Everything the engine needs to pick and run a scenario.

    Exactly one of ``beta`` (single chain) / ``betas`` (replica ensemble)
    must be set. ``size`` is the lattice side: an even [size, size] torus in
    2-D, a [size, size, size] cube in 3-D.
    """
    size: int
    width: int = 0                     # 2-D lattice width; 0 -> size (square)
    beta: Optional[float] = None       # None = unset (beta=0.0 is legal)
    betas: tuple = ()
    n_sweeps: int = 100

    model: str = "ising"               # ising | potts
    q: int = 0                         # Potts states (model="potts", >= 2)
    dims: int = 2                      # 2 | 3
    backend: str = "xla"               # xla | pallas | pallas_lines | ref
    topology: str = "single"           # single | mesh
    pipeline: str = "paper"            # paper | opt
    ensemble: str = "independent"      # independent | tempering

    mesh_shape: tuple = ()             # e.g. (2, 2); mesh topology only
    mesh_axes: tuple = ("data", "model")
    replica_axes: tuple = ("data",)    # ensemble sharding axes on a mesh

    exchange_every: int = 5            # tempering swap cadence (sweeps)
    accept: str = "lut"                # lut | exp (Metropolis table form)
    rule: str = "metropolis"           # metropolis | heat_bath (Glauber)
    algorithm: str = "metropolis"      # metropolis | swendsen_wang | wolff
    dtype: str = "bfloat16"
    prob_dtype: str = "float32"
    block_size: int = 0                # 0 -> min(128, size // 2)
    interpret: Optional[bool] = None   # accepted; no effect in the port
    measure: bool = True               # stream per-sweep (m, E) + moments
    measure_every: int = 1             # moment-accumulation thinning cadence
    field: float = 0.0                 # external field h (2-D xla only)
    hot: Optional[bool] = None         # None -> hot above Tc, cold below

    def resolved_width(self) -> int:
        return self.width or self.size

    def resolved_block_size(self) -> int:
        return self.block_size or min(L.MXU_BLOCK,
                                      min(self.size, self.resolved_width())
                                      // 2)

    def n_replicas(self) -> int:
        return len(self.betas)

    def resolved_q(self) -> int:
        """Number of Potts states (2 when unset — the Ising-equivalent)."""
        return self.q or 2

    def probs_rule(self) -> str:
        """update_rules name for float-uniform (paper pipeline) paths."""
        return "heat_bath" if self.rule == "heat_bath" else self.accept

    def kernel_rule(self) -> str:
        """update_rules name compiled into the Pallas/ref kernels."""
        return ("heat_bath" if self.rule == "heat_bath"
                else "metropolis_lut")

    def validate(self) -> None:
        err = _config_error
        if (self.beta is None) == (not self.betas):
            err("set exactly one of beta (single chain) or betas "
                f"(replica ensemble); got beta={self.beta!r} "
                f"betas={self.betas!r}")
        if self.dims not in (2, 3):
            err(f"dims must be 2 or 3, got {self.dims}")
        if self.model not in _MODELS:
            err(f"model must be one of {_MODELS}, got {self.model!r}")
        if self.model == "potts":
            if self.q < 2:
                err(f"model='potts' needs q >= 2, got q={self.q}")
            if self.q > 256:
                err(f"q={self.q} overflows the 32-bit fixed-point colour "
                    "draws ((u24 * q) >> 24 needs q <= 256); use a wider "
                    "hash before raising the cap")
            if self.dims != 2:
                err("model='potts' is 2-D only")
            if self.backend != "xla":
                err("model='potts' runs on backend='xla' (the kernel "
                    f"stack is Ising-only); got {self.backend!r}")
            if self.pipeline != "paper":
                err("model='potts' has no separate opt pipeline "
                    "(acceptance is already integer-exact); "
                    "pipeline must be 'paper'")
            if self.ensemble != "independent":
                err("parallel tempering is Ising-only; model='potts' "
                    "needs ensemble='independent'")
            if self.field:
                err("model='potts' samples the h=0 Hamiltonian; "
                    "field must be 0")
            if self.topology == "mesh" and self.betas:
                err("potts ensembles are single-device (vmapped); "
                    "use topology='single' for multi-beta potts runs")
        elif self.q:
            err(f"q={self.q} applies to model='potts' only")
        if self.backend not in _BACKENDS:
            err(f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        if self.topology not in _TOPOLOGIES:
            err(f"topology must be one of {_TOPOLOGIES}, "
                f"got {self.topology!r}")
        if self.pipeline not in _PIPELINES:
            err(f"pipeline must be one of {_PIPELINES}, "
                f"got {self.pipeline!r}")
        if self.ensemble not in _ENSEMBLES:
            err(f"ensemble must be one of {_ENSEMBLES}, "
                f"got {self.ensemble!r}")
        if self.rule not in _RULES:
            err(f"rule must be one of {_RULES}, got {self.rule!r}")
        if self.algorithm not in _ALGORITHMS:
            err(f"algorithm must be one of {_ALGORITHMS}, "
                f"got {self.algorithm!r}")
        if self.measure_every < 1:
            err(f"measure_every must be >= 1, got {self.measure_every}")
        if self.algorithm != "metropolis":
            if self.dims == 3:
                err("cluster algorithms are 2-D only (3-D label "
                    "propagation is not implemented)")
            if self.backend != "xla":
                err("cluster algorithms run on backend='xla' (label "
                    "propagation is a fused-array-op plane, not a Pallas "
                    f"kernel); got {self.backend!r}")
            if self.pipeline != "paper":
                err("cluster algorithms have no separate opt pipeline "
                    "(bond thresholds are already integer-exact); "
                    "pipeline must be 'paper'")
            if self.ensemble != "independent":
                err("tempering swap acceptance assumes Metropolis "
                    "dynamics; algorithm must be 'metropolis'")
            if self.rule != "metropolis":
                err("rule= selects single-site dynamics; cluster "
                    "algorithms replace them entirely — leave "
                    "rule='metropolis'")
            if self.field:
                err("cluster algorithms sample the h=0 Hamiltonian "
                    "(FK bond probabilities assume it); field must be 0")
            if self.betas and self.topology == "mesh":
                err("cluster ensembles are single-device (vmapped); "
                    "use topology='single' for multi-beta cluster runs")
        if self.rule == "heat_bath":
            if self.dims == 3:
                err("rule='heat_bath' is 2-D only (the 3-D sampler has no "
                    "registry hook yet)")
            if self.ensemble == "tempering":
                err("tempering runs Metropolis dynamics (swap acceptance "
                    "assumes it); rule must be 'metropolis'")
        if self.dims == 3:
            if self.backend != "xla":
                err("3-D supports only backend='xla' (the kernel stack is "
                    "2-D); got " + repr(self.backend))
            if self.pipeline != "paper" or self.ensemble != "independent":
                err("3-D supports pipeline='paper', ensemble='independent'")
            if self.field:
                err("3-D external field is not implemented")
            if self.width:
                err("3-D lattices are cubic; width applies to 2-D only")
            if self.betas:
                err("3-D ensembles are not implemented (the vmapped "
                    "replica runner sweeps 2-D compact quads); use a "
                    "scalar beta")
        else:
            w = self.resolved_width()
            if self.size % 2 or w % 2:
                err(f"2-D lattice dims must be even, got "
                    f"{self.size}x{w}")
            bs = self.resolved_block_size()
            if (self.size // 2) % bs or (w // 2) % bs:
                err(f"half-lattice {self.size // 2}x{w // 2} must be "
                    f"divisible by block_size {bs}")
        if self.ensemble == "tempering":
            if not self.betas:
                err("ensemble='tempering' needs a betas ladder")
            if (self.topology, self.backend, self.pipeline) != \
                    ("single", "xla", "paper"):
                err("tempering runs on topology='single', backend='xla', "
                    "pipeline='paper'")
            if not self.measure:
                err("tempering always measures (swap decisions need "
                    "energies); set measure=True")
            if self.field:
                err("tempering samples the h=0 Hamiltonian "
                    "(core.tempering has no field term); field must be 0")
        if self.pipeline == "opt":
            if self.accept != "lut":
                err("pipeline='opt' uses the exact integer-threshold LUT; "
                    "accept must be 'lut'")
            if self.field:
                err("pipeline='opt' requires field=0 (the field term "
                    "forces float acceptance)")
            if self.betas:
                err("pipeline='opt' ensembles are not implemented; use "
                    "pipeline='paper' for multi-beta runs")
            if self.backend not in ("xla", "pallas_lines"):
                err("pipeline='opt' runs on backend='xla' or "
                    f"'pallas_lines'; got {self.backend!r}")
        if self.backend in ("pallas", "pallas_lines", "ref"):
            if self.field:
                err(f"backend={self.backend!r} requires field=0 (the "
                    "kernel bakes the 5-entry LUT)")
            if self.accept != "lut":
                err(f"backend={self.backend!r} uses the in-kernel LUT; "
                    "accept must be 'lut'")
            if self.betas:
                err(f"backend={self.backend!r} ensembles are not "
                    "implemented; use backend='xla' for multi-beta runs")
        if self.topology == "mesh":
            if not self.mesh_shape:
                err("topology='mesh' needs mesh_shape, e.g. (2, 2)")
            if len(self.mesh_axes) < 2:
                err("mesh_axes needs at least (row_axis, col_axis); "
                    f"got {self.mesh_axes}")
            if len(self.mesh_shape) != len(self.mesh_axes):
                err(f"mesh_shape {self.mesh_shape} and mesh_axes "
                    f"{self.mesh_axes} must have equal length")
            if self.backend in ("pallas", "ref"):
                err("mesh topology supports backend='xla' (GSPMD/shard_map)"
                    " or 'pallas_lines' (edge-line halo); "
                    f"got {self.backend!r}")
            if self.field:
                err("mesh topology requires field=0")


class EngineConfigError(ValueError):
    """Raised for invalid EngineConfig combinations (clear, actionable)."""


def _config_error(msg: str):
    raise EngineConfigError(f"invalid EngineConfig: {msg}")



def beta_ladder(t_over_tc_min: float, t_over_tc_max: float, n: int,
                dims: int = 2) -> tuple:
    """n inverse temperatures spanning [t_min, t_max] x Tc, coldest-first
    temperature order (descending beta ladder ends hottest)."""
    tc = (obs.critical_temperature() if dims == 2 else 1.0 / I3.BETA_C_3D)
    if n == 1:
        return (1.0 / (t_over_tc_min * tc),)
    step = (t_over_tc_max - t_over_tc_min) / (n - 1)
    return tuple(1.0 / ((t_over_tc_min + i * step) * tc) for i in range(n))




def replica_sweep_fns(cfg: EngineConfig):
    """The per-chain sweep family behind every multi-chain harness.

    Returns ``(one_sweep, one_sweep_measured, rep_args)``:

    * ``one_sweep(state, key, arg, step) -> state`` and
      ``one_sweep_measured(state, key, arg, step) -> (state, (m, e))``
      advance one chain by one sweep, or, given a key batch (one key per
      replica) and per-replica args, every replica of a stack in one pass
      with per-replica (m, e); every draw is addressed by ``(key, step)``,
      so a chain run in chunks with absolute steps equals one straight run;
    * ``rep_args(betas, device)`` maps the betas to the per-replica sweep
      argument: an f32 beta tensor for single-site dynamics, int64 u24
      bond thresholds for cluster dynamics (equal to the host thresholds
      of a scalar beta).

    A scalar-beta chain passes ``arg`` as a Python number instead
    (:meth:`IsingEngine._static_arg`), as the reference bakes it into its
    compiled loop. State layouts: compact quads ``[4, R, C]`` (2-D Ising
    checkerboard), the full ``[L, L]`` view (Ising cluster sweeps), the
    ``[H, W]`` int32 colour view (Potts) and the ``[D, H, W]`` cube (3-D),
    each with a leading replica axis for a stack.
    """
    c = cfg

    def beta_args(betas, device):
        return torch.tensor(betas, dtype=torch.float32, device=device)

    if c.model == "potts":
        q = c.resolved_q()
        if c.algorithm != "metropolis":
            algo = c.algorithm

            def one_sweep(f, k, t, step):
                return potts_sweep.cluster_sweep(f, jr.fold_in(k, step), t,
                                                 q, algo)

            def one_sweep_measured(f, k, t, step):
                return potts_sweep.cluster_sweep_measured(
                    f, jr.fold_in(k, step), t, q, algo)

            def rep_args(betas, device):
                return potts_bonds.bond_threshold_traced(
                    beta_args(betas, device))

            return one_sweep, one_sweep_measured, rep_args

        rule = c.rule

        def one_sweep(f, k, beta, step):
            return potts_rules.checkerboard_sweep(f, jr.fold_in(k, step),
                                                  beta, q, rule)

        def one_sweep_measured(f, k, beta, step):
            return potts_rules.checkerboard_sweep_measured(
                f, jr.fold_in(k, step), beta, q, rule)

        return one_sweep, one_sweep_measured, beta_args

    if c.dims == 3:
        def one_sweep(f, k, beta, step):
            return I3.sweep3d(f, k, step, beta)

        def one_sweep_measured(f, k, beta, step):
            f = I3.sweep3d(f, k, step, beta)
            return f, (measure.site_mean(f, 3), obs.energy_per_spin3d(f))

        return one_sweep, one_sweep_measured, beta_args

    if c.algorithm != "metropolis":
        algo = c.algorithm

        def one_sweep(f, k, t, step):
            return csweep.cluster_sweep(f, jr.fold_in(k, step), t, algo)

        def one_sweep_measured(f, k, t, step):
            return csweep.cluster_sweep_measured(f, jr.fold_in(k, step), t,
                                                 algo)

        def rep_args(betas, device):
            return cbonds.bond_threshold_traced(beta_args(betas, device))

        return one_sweep, one_sweep_measured, rep_args

    bs = c.resolved_block_size()
    rule = c.probs_rule()
    field = c.field

    def one_sweep(q, k, beta, step):
        probs = sampler.sweep_probs(k, step, q.shape[-2:], c.prob_dtype,
                                    q.device)
        return cb.sweep_compact(q, probs, beta, bs, rule, field=field)

    def one_sweep_measured(q, k, beta, step):
        probs = sampler.sweep_probs(k, step, q.shape[-2:], c.prob_dtype,
                                    q.device)
        return measure.sweep_compact_measured(q, probs, beta, bs, rule,
                                              field=field)

    return one_sweep, one_sweep_measured, beta_args


@dataclasses.dataclass
class EngineResult:
    """What a run hands back.

    state:          final state on the engine's device: compact quads
                    [4, R, C], replicas [Rr, 4, R, C], the [D, H, W] cube,
                    int32 colour views [H, W] / [Rr, H, W] (Potts), or
                    this rank's block of a grid scenario: blocked quads
                    [4, mr, mc, bs, bs] (mesh, opt) or [ld, lh, lw] (mesh3d)
    magnetization:  per-sweep m, host f32 tensor [T] or [n_replicas, T]
                    (None when measure=False, and for the grid scenarios,
                    which stream moments only); the Potts order parameter
                    for model="potts"; per-round |m| [n_replicas, rounds]
                    for tempering
    energy:         per-sweep E/spin, same shape (None when unmeasured and
                    for tempering)
    moments:        running averages over the measured sweeps — dict with
                    m_abs, E, E2, E_var, m2, m4, U4, n_samples (numpy arrays
                    of shape [n_replicas] for ensembles; None for tempering)
    extra:          scenario extras (betas of an ensemble; tempering's
                    swap_fraction and betas)
    """
    state: torch.Tensor
    magnetization: Optional[torch.Tensor] = None
    energy: Optional[torch.Tensor] = None
    moments: Optional[dict] = None
    extra: dict = dataclasses.field(default_factory=dict)


# decomposed-lattice scenarios: the state is this rank's block of the
# lattice and runs stream moments only
_GRID_SCENARIOS = ("opt", "mesh", "mesh3d", "cluster_mesh",
                   "potts_cluster_mesh", "potts_cb_mesh")


def check_ported(cfg: EngineConfig) -> str:
    """Validate ``cfg`` (the reference's rules and messages) and return its
    scenario; every scenario of the reference is ported."""
    cfg.validate()
    return _scenario(cfg)


class IsingEngine:
    """Config-driven dispatcher over the ported scenarios.

    Usage::

        engine = IsingEngine(EngineConfig(size=256, beta=0.44, n_sweeps=100))
        result = engine.simulate(seed=0)

    ``device`` defaults to ``"cuda"``; the tests pass ``device="cpu"``.
    """

    def __init__(self, cfg: EngineConfig, device=None, grid=None):
        scen = check_ported(cfg)
        self.cfg = cfg
        self.grid = None
        if cfg.topology == "mesh" or scen == "opt":
            self.grid = grid if grid is not None else self._make_grid(device)
            self._check_grid(scen)
            self.device = self.grid.device
        else:
            self.device = mesh_lib.resolve_device(device)
        self._dtype = L.torch_dtype(cfg.dtype)
        self._chunk_engines: dict = {}
        self._runners: dict = {}

    def _make_grid(self, device):
        """This rank's grid: ``mesh_shape`` over ``mesh_axes`` (one shard
        per axis for ``"opt"`` on one device), over the initialised process
        group, whose world size must be the shard count."""
        c = self.cfg
        shape = tuple(c.mesh_shape) or (1,) * len(c.mesh_axes)
        try:
            return mesh_lib.make_grid(shape, c.mesh_axes, device)
        except ValueError as exc:
            _config_error(f"{exc}; start as many ranks (torch.distributed) "
                          "as the grid has shards")

    def _check_grid(self, scen: str) -> None:
        """The reference's tiling checks against the grid."""
        c, grid = self.cfg, self.grid
        if c.betas:
            n_shards = grid.axis_size(c.replica_axes)
            if c.n_replicas() % n_shards:
                _config_error(
                    f"{c.n_replicas()} replicas cannot shard evenly over "
                    f"replica_axes {c.replica_axes} (size {n_shards}); pad "
                    "the betas ladder or change replica_axes")
            return
        if scen == "mesh3d":
            d3cfg = self._dist3d_cfg()
            for name, axes in (("depth", d3cfg.depth_axes),
                               ("row", d3cfg.row_axes),
                               ("col", d3cfg.col_axes)):
                n = grid.axis_size(axes)
                if c.size % n:
                    _config_error(
                        f"3-D cube side {c.size} does not divide the "
                        f"{name} shard count {n} (mesh_axes "
                        f"{c.mesh_axes}); adjust size or mesh_shape")
            return
        dcfg = self._dist_cfg()
        nrows = grid.axis_size(dcfg.row_axes)
        ncols = grid.axis_size(dcfg.col_axes)
        if scen == "potts_cb_mesh":
            if c.size % nrows or c.resolved_width() % ncols:
                _config_error(
                    f"colour lattice {c.size}x{c.resolved_width()} does not "
                    f"tile the {nrows}x{ncols} device grid; adjust "
                    "size/width or mesh_shape")
            return
        bs = c.resolved_block_size()
        mr, mc = c.size // 2 // bs, c.resolved_width() // 2 // bs
        if mr % nrows or mc % ncols:
            _config_error(
                f"blocked lattice grid {mr}x{mc} (block_size {bs}) does not "
                f"tile the {nrows}x{ncols} device grid; adjust size/width "
                "or block_size")

    def _scenario(self) -> str:
        return _scenario(self.cfg)

    # ------------------------------------------------------------------
    # Grid geometry
    # ------------------------------------------------------------------

    def _dist_cfg(self) -> dising.DistIsingConfig:
        c = self.cfg
        return dising.DistIsingConfig(
            beta=c.beta, block_size=c.resolved_block_size(),
            row_axes=c.mesh_axes[:-1] or c.mesh_axes,
            col_axes=(c.mesh_axes[-1],), accept=c.accept,
            backend=("pallas_lines" if c.backend == "pallas_lines"
                     else "xla"),
            prob_dtype=c.prob_dtype, pipeline=c.pipeline, rule=c.rule)

    def _dist3d_cfg(self) -> d3.Dist3DConfig:
        """The grid axes map onto the cube's (D, H, W) right-aligned: a
        2-axis grid shards (H, W) and leaves depth whole."""
        m = self.cfg.mesh_axes
        return d3.Dist3DConfig(beta=self.cfg.beta, depth_axes=tuple(m[:-2]),
                               row_axes=(m[-2],), col_axes=(m[-1],))

    def state_sharding(self):
        """``(grid, placement)`` of a grid scenario's state, the local-block
        counterpart of the reference's NamedSharding (what checkpoint
        restore slices a rank's block with); None elsewhere."""
        scen = self._scenario()
        if self.grid is None:
            return None
        if self.cfg.betas:
            return self.grid, (self.cfg.replica_axes, None, None, None)
        if scen == "mesh3d":
            return self.grid, d3.lattice_spec(self.grid, self._dist3d_cfg())
        if scen == "potts_cb_mesh":
            dcfg = self._dist_cfg()
            return self.grid, (dcfg.row_axes, dcfg.col_axes)
        return self.grid, dising.lattice_spec(self._dist_cfg())

    def _grid_runner(self, n_sweeps: int, measured: bool):
        """The cached chain runner of a grid scenario (the reference's
        ``make_run_chain_fn`` / ``make_run_sweeps_fn`` of its module)."""
        key_ = (n_sweeps, measured)
        if key_ not in self._runners:
            c, scen = self.cfg, self._scenario()
            if scen == "mesh3d":
                make = (d3.make_run_chain_fn if measured
                        else d3.make_run_sweeps_fn)
                args = (self._dist3d_cfg(),)
            elif scen in ("mesh", "opt"):
                make = (dising.make_run_chain_fn if measured
                        else dising.make_run_sweeps_fn)
                args = (self._dist_cfg(),)
            elif scen == "cluster_mesh":
                make = (cmesh.make_cluster_run_fn if measured
                        else cmesh.make_cluster_sweeps_fn)
                args = (self._dist_cfg(), c.algorithm)
            elif scen == "potts_cluster_mesh":
                make = (potts_mesh.make_potts_run_fn if measured
                        else potts_mesh.make_potts_sweeps_fn)
                args = (self._dist_cfg(), c.resolved_q(), c.algorithm)
            else:   # potts_cb_mesh
                make = (potts_mesh.make_potts_cb_run_fn if measured
                        else potts_mesh.make_potts_cb_sweeps_fn)
                args = (self._dist_cfg(), c.resolved_q(), c.rule)
            extra = (c.measure_every,) if measured else ()
            self._runners[key_] = make(self.grid, *args, n_sweeps, *extra)
        return self._runners[key_]

    def _chain_cfg(self) -> sampler.ChainConfig:
        c = self.cfg
        return sampler.ChainConfig(
            beta=c.beta, n_sweeps=c.n_sweeps,
            block_size=c.resolved_block_size(), accept=c.probs_rule(),
            dtype=c.dtype, prob_dtype=c.prob_dtype, measure=c.measure,
            field=c.field)

    def _auto_hot(self, beta: float) -> bool:
        if self.cfg.hot is not None:
            return self.cfg.hot
        if self.cfg.model == "potts":
            beta_c = potts_state.beta_c(self.cfg.resolved_q())
        else:
            beta_c = (I3.BETA_C_3D if self.cfg.dims == 3
                      else 1.0 / obs.critical_temperature())
        return beta < beta_c  # hot start in the disordered phase

    # ------------------------------------------------------------------
    # State initialization
    # ------------------------------------------------------------------

    def init(self, key) -> torch.Tensor:
        """Initial state on the engine's device (layouts as in
        :class:`EngineResult`). Replica i starts from ``fold_in(key, i)``,
        hot or cold per its own beta when ``hot=None``."""
        c = self.cfg
        dev = self.device
        scen = self._scenario()
        if scen.startswith("potts"):
            return self._init_potts(key)
        if scen in ("3d", "mesh3d"):
            n = c.size
            if self._auto_hot(c.beta):
                full = I3.random_lattice3d(key, n, n, n, self._dtype, dev)
            else:
                full = I3.cold_lattice3d(n, n, n, self._dtype, dev)
            if scen == "mesh3d":
                full = self.grid.local_block(full, self.state_sharding()[1])
            return full
        if scen in ("mesh", "opt", "cluster_mesh"):
            # the whole lattice from the key on every rank, as the
            # reference draws it, then this rank's block
            w = c.resolved_width()
            full = (L.random_lattice(key, c.size, w, self._dtype, dev)
                    if self._auto_hot(c.beta)
                    else L.cold_lattice(c.size, w, self._dtype, dev))
            return self._local_blocked(full)
        if c.betas:
            return torch.stack([
                sampler.init_state(jr.fold_in(key, i), c.size,
                                   c.resolved_width(), self._dtype,
                                   hot=self._auto_hot(c.betas[i]),
                                   device=dev)
                for i in self._replica_share()])
        return sampler.init_state(key, c.size, c.resolved_width(),
                                  self._dtype, hot=self._auto_hot(c.beta),
                                  device=dev)

    def _init_potts(self, key) -> torch.Tensor:
        """Potts colour states: [H, W] int32, or [R, H, W] for ensembles."""
        c = self.cfg
        q = c.resolved_q()
        h, w = c.size, c.resolved_width()

        def one(k, beta):
            if self._auto_hot(beta):
                return potts_state.random_state(k, h, w, q, self.device)
            return potts_state.cold_state(h, w, self.device)

        if c.betas:
            return torch.stack([one(jr.fold_in(key, i), b)
                                for i, b in enumerate(c.betas)])
        full = one(key, c.beta)
        if c.topology != "mesh":
            return full
        if c.algorithm == "metropolis":   # checkerboard: the full view
            return self.grid.local_block(full, self.state_sharding()[1])
        return self._local_blocked(full)

    def _local_blocked(self, full) -> torch.Tensor:
        """This rank's block of the blocked quads of a global full view."""
        qb = kops._block_quads(L.to_quads(full),
                               self.cfg.resolved_block_size())
        return self.grid.local_block(qb, self.state_sharding()[1])

    def _replica_share(self) -> range:
        """The global indices of the replicas this rank steps: all of them
        on one device, its contiguous share over ``replica_axes`` on a
        mesh."""
        n = self.cfg.n_replicas()
        if self.grid is None:
            return range(n)
        shards = self.grid.axis_size(self.cfg.replica_axes)
        per = n // shards
        start = self.grid.axis_index(self.cfg.replica_axes) * per
        return range(start, start + per)

    # ------------------------------------------------------------------
    # Runners
    # ------------------------------------------------------------------

    def _static_arg(self):
        """The sweep argument of a scalar-beta chain: beta itself, or the
        host u24 bond threshold for cluster dynamics."""
        c = self.cfg
        if c.algorithm == "metropolis":
            return c.beta
        if c.model == "potts":
            return potts_bonds.bond_threshold_u24(c.beta)
        return cbonds.bond_threshold_u24(c.beta)

    def _chain_loop(self, state, key, one_sweep, one_sweep_measured, arg):
        """``cfg.n_sweeps`` sweeps of one chain, or of every replica of a
        stack under a key batch; measured runs keep the (m, E) series on
        the device and move it to the host once ([T] or [R, T])."""
        c = self.cfg
        if not c.measure:
            for step in range(c.n_sweeps):
                state = one_sweep(state, key, arg, step)
            return state, None, None
        ms, es = [], []
        for step in range(c.n_sweeps):
            state, (m, e) = one_sweep_measured(state, key, arg, step)
            ms.append(m)
            es.append(e)
        ms, es = torch.stack(ms, -1), torch.stack(es, -1)
        with span("repro_torch.engine.series.sync"):
            return state, ms.cpu(), es.cpu()

    def _run_kernel(self, state, key):
        """Kernel-backend chain: the lattice stays blocked through the run,
        each colour is one kernel launch with bits from
        ``fold_in(fold_in(key, step), color)``; measured runs stream
        ``(m, E)`` through ``measure.blocked_stats`` on the device and move
        the series to the host once."""
        c = self.cfg
        bs = c.resolved_block_size()
        rule = c.kernel_rule()
        if not c.measure:
            final = kops.run_sweeps(state, key, n_sweeps=c.n_sweeps,
                                    beta=c.beta, bs=bs, backend=c.backend,
                                    rule=rule)
            return final, None, None
        qb = kops._block_quads(state, bs)
        ms = torch.empty(c.n_sweeps, dtype=torch.float32, device=qb.device)
        es = torch.empty_like(ms)
        for step in range(c.n_sweeps):
            qb = kops.sweep_blocked(qb, key, step, c.beta, c.backend, rule)
            ms[step], es[step] = measure.blocked_stats(qb)
        final = kops._unblock_quads(qb)
        with span("repro_torch.engine.series.sync"):
            return final, ms.cpu(), es.cpu()

    def _run_tempering(self, state, key) -> EngineResult:
        c = self.cfg
        if c.n_sweeps % c.exchange_every:
            _config_error(f"n_sweeps={c.n_sweeps} must be a multiple of "
                          f"exchange_every={c.exchange_every} for tempering")
        tcfg = pt.TemperingConfig(
            betas=c.betas, n_rounds=c.n_sweeps // c.exchange_every,
            exchange_every=c.exchange_every,
            block_size=c.resolved_block_size(), accept=c.accept,
            dtype=c.dtype)
        final, ms, frac = pt.run_tempering(key, c.size, tcfg,
                                           init_replicas=state)
        return EngineResult(final, ms.T, None,
                            extra={"swap_fraction": frac, "betas": c.betas})

    # ------------------------------------------------------------------
    # Public entry points
    # ------------------------------------------------------------------

    def run(self, state: torch.Tensor, key) -> EngineResult:
        """Advance ``state`` by ``cfg.n_sweeps`` sweeps under chain ``key``.
        ``state`` itself is left as it was."""
        c = self.cfg
        state = state.to(self.device)
        scen = self._scenario()
        if scen == "tempering":
            return self._run_tempering(state, key)
        if scen == "chain":
            if c.measure:
                final, ms, es = sampler.run_chain(state, key,
                                                  self._chain_cfg())
                return EngineResult(final, ms, es,
                                    self._series_moments(ms, es))
            return EngineResult(sampler.run_sweeps(state, key,
                                                   self._chain_cfg()))
        if scen == "kernel":
            final, ms, es = self._run_kernel(state, key)
            return EngineResult(final, ms, es, self._series_moments(ms, es))
        if scen in _GRID_SCENARIOS:
            if c.measure:
                final, mom = self._grid_runner(c.n_sweeps, True)(state, key)
                return EngineResult(final, moments=measure.finalize(mom))
            return EngineResult(self._grid_runner(c.n_sweeps, False)(
                state, key))
        one_sweep, one_sweep_measured, rep_args = replica_sweep_fns(c)
        pre, post = ((L.from_quads, L.to_quads) if scen == "cluster"
                     else (None, None))
        if c.betas:
            # the replica axis leads: replica i is the chain keyed
            # fold_in(key, i) at betas[i], all stepped together (on a mesh
            # this rank's share of them)
            share = self._replica_share()
            key = [jr.fold_in(key, i) for i in share]
            arg = rep_args([c.betas[i] for i in share], self.device)
            extra = {"betas": c.betas}
        else:
            arg = self._static_arg()
            extra = {}
        final, ms, es = self._chain_loop(pre(state) if pre else state, key,
                                         one_sweep, one_sweep_measured, arg)
        final = post(final) if post else final
        if self.grid is not None and ms is not None:
            ms, es = (self._gather_replicas(x) for x in (ms, es))
        return EngineResult(final, ms, es, self._series_moments(ms, es),
                            extra)

    def _gather_replicas(self, series: torch.Tensor) -> torch.Tensor:
        """Every rank's [share, T] series into the [n_replicas, T] layout
        (on the host, as the single-device series)."""
        place = (self.cfg.replica_axes, None)
        return self.grid.gather(series.to(self.device), place).cpu()

    def _series_moments(self, ms, es) -> Optional[dict]:
        """Moments from the per-sweep series; None when unmeasured."""
        if ms is None or es is None:
            return None
        return measure.finalize(measure.moments_from_series(
            ms, es, measure_every=self.cfg.measure_every))

    def run_sweeps(self, state: torch.Tensor, key,
                   n_sweeps: int) -> torch.Tensor:
        """Measurement-free chunk of ``n_sweeps`` sweeps; returns the new
        state. The sweep counter restarts at 0, as in the reference."""
        if self._scenario() in _GRID_SCENARIOS:
            return self._grid_runner(n_sweeps, False)(state.to(self.device),
                                                      key)
        if self._scenario() == "tempering":
            _config_error("tempering chunks are not supported; use run() "
                          "(swap decisions need the measured energies)")
        if n_sweeps not in self._chunk_engines:
            self._chunk_engines[n_sweeps] = IsingEngine(
                dataclasses.replace(self.cfg, n_sweeps=n_sweeps,
                                    measure=False), device=self.device,
                grid=self.grid)
        return self._chunk_engines[n_sweeps].run(state, key).state

    def simulate(self, seed: int = 0) -> EngineResult:
        """One-call convenience: split seed into init/chain keys and run."""
        k_init, k_chain = jr.split(jr.PRNGKey(seed))
        return self.run(self.init(k_init), k_chain)

    def magnetization(self, state: torch.Tensor) -> float:
        """Global mean spin of any state layout (host scalar); for a grid
        scenario, of the whole lattice from this rank's block."""
        total, n = torch.sum(state.float()), state.numel()
        if self.grid is not None:
            total, n = self.grid.psum(total), n * self.grid.size
        return float(measure.per_spin(total, n))

    def stats(self, state: torch.Tensor) -> tuple:
        """Exact global (m, E/spin) of a grid scenario's state without
        gathering it: the local sums, all-reduced over the grid."""
        scen = self._scenario()
        if scen not in _GRID_SCENARIOS:
            _config_error("stats(state) reads the decomposed layouts; use "
                          "run() results elsewhere")
        if "global_stats" not in self._runners:
            if scen == "mesh3d":
                fn = d3.global_stats(self.grid, self._dist3d_cfg())
            elif scen == "potts_cluster_mesh":
                fn = potts_mesh.global_stats(self.grid, self._dist_cfg(),
                                             self.cfg.resolved_q())
            elif scen == "potts_cb_mesh":
                fn = potts_mesh.cb_global_stats(self.grid, self._dist_cfg(),
                                                self.cfg.resolved_q())
            else:
                fn = dising.global_stats(self.grid, self._dist_cfg())
            self._runners["global_stats"] = fn
        m, e = self._runners["global_stats"](state.to(self.device))
        return float(m), float(e)

    def state_template(self) -> torch.Tensor:
        """A ``meta`` tensor with this scenario's state shape and dtype —
        no allocation. For a grid scenario it is the global shape, which
        checkpoints hold; :meth:`state_sharding` places a rank's block."""
        c = self.cfg
        scen = self._scenario()
        dt = torch.int32 if scen.startswith("potts") else self._dtype
        if scen in ("3d", "mesh3d"):
            shape = (c.size,) * 3
        elif scen in ("mesh", "opt", "cluster_mesh", "potts_cluster_mesh"):
            bs = c.resolved_block_size()
            shape = (4, c.size // 2 // bs, c.resolved_width() // 2 // bs,
                     bs, bs)
        elif scen.startswith("potts"):
            shape = (c.size, c.resolved_width())
            if c.betas:
                shape = (c.n_replicas(),) + shape
        elif c.betas:   # ensemble / tempering / multi-beta cluster: quads
            shape = (c.n_replicas(), 4, c.size // 2,
                     c.resolved_width() // 2)
        else:           # chain / kernel / cluster: compact quads
            shape = (4, c.size // 2, c.resolved_width() // 2)
        return torch.empty(shape, dtype=dt, device="meta")

    def phase_curve(self, key, burnin: int = 0,
                    full_stats: bool = False) -> list:
        """Phase-diagram scan: run the beta ensemble once and reduce each
        replica's (m, E) series to the paper's Fig.-4 statistics
        (``full_stats`` adds chi, C and the autocorrelation time)."""
        c = self.cfg
        if not c.betas or c.ensemble != "independent":
            _config_error("phase_curve needs an independent-replica betas "
                          "ensemble")
        k_init, k_chain = jr.split(key)
        res = self.run(self.init(k_init), k_chain)
        rows = []
        n_spins = (c.size ** 3 if c.dims == 3
                   else c.size * c.resolved_width())
        for i, beta in enumerate(c.betas):
            stats = obs.chain_statistics(
                res.magnetization[i].numpy(), res.energy[i].numpy(), burnin,
                beta=(beta if full_stats else 0.0),
                n_spins=(n_spins if full_stats else 0))
            stats["T"] = 1.0 / beta
            stats["beta"] = beta
            stats["size"] = c.size
            rows.append(stats)
        return rows


def _scenario(c: EngineConfig) -> str:
    """The reference's scenario resolution (``IsingEngine._scenario``)."""
    if c.model == "potts":
        if c.algorithm != "metropolis":
            return ("potts_cluster_mesh" if c.topology == "mesh"
                    else "potts_cluster")
        return "potts_cb_mesh" if c.topology == "mesh" else "potts_cb"
    if c.dims == 3:
        return "mesh3d" if c.topology == "mesh" else "3d"
    if c.algorithm != "metropolis":
        return "cluster_mesh" if c.topology == "mesh" else "cluster"
    if c.ensemble == "tempering":
        return "tempering"
    if c.topology == "mesh" and not c.betas:
        return "mesh"
    if c.pipeline == "opt":
        return "opt"
    if c.betas:
        return "ensemble"
    if c.backend != "xla":
        return "kernel"
    return "chain"
