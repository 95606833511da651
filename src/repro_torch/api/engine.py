"""`IsingEngine`: the config-driven front door, ported to PyTorch.

The port of ``repro.api.engine``. :class:`EngineConfig` keeps every field
and the whole of ``validate()``, so an invalid configuration raises the
same :class:`EngineConfigError`. This slice runs the two single-chain
2-D scenarios:

* ``"chain"``  (``backend="xla"``): paper Algorithm 2 in plain PyTorch
  (:mod:`repro_torch.core.sampler`), per-sweep ``(m, E)`` from the white
  half-update's own neighbour sums;
* ``"kernel"`` (``backend="pallas"``, ``"pallas_lines"`` or ``"ref"``): the
  lattice stays blocked ``[4, MR, MC, bs, bs]`` through the run, each colour
  is one launch of a CUDA kernel on the card
  (:mod:`repro_torch.kernels.checkerboard`; ``"ref"`` runs the plain
  oracle), and measured runs stream ``(m, E)`` via
  ``measure.blocked_stats``.

Every other scenario (ensembles, tempering, 3-D, cluster, Potts, the opt
pipeline, the mesh) raises ``EngineConfigError`` naming it as not yet
ported. RNG contract as in the reference: ``simulate(seed)`` splits
``PRNGKey(seed)`` into init and chain keys, and the run is bitwise equal to
the JAX engine's from the same seed (see ``tests/test_torch_engine.py``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; keys are host-side ``(k0, k1)`` pairs
(:mod:`repro_torch.random`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import random as jr
from repro_torch.core import lattice as L
from repro_torch.core import measure
from repro_torch.core import observables as obs
from repro_torch.core import sampler
from repro_torch.kernels import ops as kops

# Inverse critical temperature of the 3-D model (as in the reference's
# core.ising3d), used by beta_ladder(dims=3).
BETA_C_3D = 0.2216546

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
    tc = (obs.critical_temperature() if dims == 2 else 1.0 / BETA_C_3D)
    if n == 1:
        return (1.0 / (t_over_tc_min * tc),)
    step = (t_over_tc_max - t_over_tc_min) / (n - 1)
    return tuple(1.0 / ((t_over_tc_min + i * step) * tc) for i in range(n))


@dataclasses.dataclass
class EngineResult:
    """What a run hands back.

    state:          final compact quads [4, R, C] on the engine's device
    magnetization:  per-sweep m, host f32 tensor [T] (None when measure=False)
    energy:         per-sweep E/spin, same shape (None when unmeasured)
    moments:        running averages over the measured sweeps — dict with
                    m_abs, E, E2, E_var, m2, m4, U4, n_samples
    extra:          scenario extras (empty for the ported scenarios)
    """
    state: torch.Tensor
    magnetization: Optional[torch.Tensor] = None
    energy: Optional[torch.Tensor] = None
    moments: Optional[dict] = None
    extra: dict = dataclasses.field(default_factory=dict)


_PORTED = ("chain", "kernel")


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "IsingEngine runs on the CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


class IsingEngine:
    """Config-driven dispatcher over the ported scenarios.

    Usage::

        engine = IsingEngine(EngineConfig(size=256, beta=0.44, n_sweeps=100))
        result = engine.simulate(seed=0)

    ``device`` defaults to ``"cuda"``; the tests pass ``device="cpu"``.
    """

    def __init__(self, cfg: EngineConfig, device=None):
        cfg.validate()
        scen = _scenario(cfg)
        if scen not in _PORTED:
            _config_error(f"scenario {scen!r} is not yet ported to PyTorch "
                          f"(ported: {', '.join(_PORTED)}); use the JAX "
                          "package's repro.api for it")
        self.cfg = cfg
        self.device = _resolve_device(device)
        self._dtype = L.torch_dtype(cfg.dtype)

    def _scenario(self) -> str:
        return _scenario(self.cfg)

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
        return beta < 1.0 / obs.critical_temperature()

    def init(self, key) -> torch.Tensor:
        """Initial compact quads [4, R, C] on the engine's device."""
        c = self.cfg
        return sampler.init_state(key, c.size, c.resolved_width(),
                                  self._dtype, hot=self._auto_hot(c.beta),
                                  device=self.device)

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
        return kops._unblock_quads(qb), ms.cpu(), es.cpu()

    def run(self, state: torch.Tensor, key) -> EngineResult:
        """Advance ``state`` by ``cfg.n_sweeps`` sweeps under chain ``key``.
        ``state`` itself is left as it was."""
        c = self.cfg
        state = state.to(self.device)
        if self._scenario() == "chain":
            if c.measure:
                final, ms, es = sampler.run_chain(state, key,
                                                  self._chain_cfg())
                return EngineResult(final, ms, es,
                                    self._series_moments(ms, es))
            return EngineResult(sampler.run_sweeps(state, key,
                                                   self._chain_cfg()))
        final, ms, es = self._run_kernel(state, key)
        return EngineResult(final, ms, es, self._series_moments(ms, es))

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
        sub = IsingEngine(dataclasses.replace(self.cfg, n_sweeps=n_sweeps,
                                              measure=False),
                          device=self.device)
        return sub.run(state, key).state

    def simulate(self, seed: int = 0) -> EngineResult:
        """One-call convenience: split seed into init/chain keys and run."""
        k_init, k_chain = jr.split(jr.PRNGKey(seed))
        return self.run(self.init(k_init), k_chain)

    def magnetization(self, state: torch.Tensor) -> float:
        """Global mean spin of the state (host scalar)."""
        return float(torch.mean(state.float()))

    def state_template(self) -> torch.Tensor:
        """A ``meta`` tensor with this scenario's state shape and dtype
        (compact quads [4, R, C]) — no allocation."""
        c = self.cfg
        return torch.empty((4, c.size // 2, c.resolved_width() // 2),
                           dtype=self._dtype, device="meta")


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
