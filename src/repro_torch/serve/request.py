"""Monte Carlo job types for the serving plane.

The port of ``repro.serve.request``. A :class:`SimRequest` is one user
job: "run me a ``(model, q, dims, L, beta, algorithm, rule)`` chain for
``n_sweeps`` sweeps from ``seed`` and stream ``n_samples`` running-moment
snapshots back". It is a pure-value object — everything the scheduler
needs to bucket it, everything the engine needs to reproduce it
standalone.

The serving contract (pinned in ``tests/test_torch_serve.py``): a
request's streamed moments are **bitwise equal** to a standalone

    IsingEngine(request.engine_config()).simulate(seed=request.seed)

run, no matter which bucket, replica slot, or batch timing the request
landed in. The request's own seed derives its init/chain keys (the same
``split(PRNGKey(seed))`` the engine's ``simulate`` uses), and every sweep
draw is counter-addressed by ``(chain_key, absolute_step)`` — slot
assignment and chunk boundaries cannot reach the stream. The served
results are those of the JAX package's serving plane, bitwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

from repro_torch.api import EngineConfig

#: Request lifecycle states (host-side bookkeeping, not device state).
PENDING = "pending"        # submitted, waiting for a replica slot
RUNNING = "running"        # occupying a slot in an active bucket run
DONE = "done"              # all n_sweeps swept, final snapshot emitted
CANCELLED = "cancelled"    # cancelled before completion


@dataclasses.dataclass(frozen=True)
class SimRequest:
    """One MC simulation job.

    ``n_samples`` is the number of incremental running-moment snapshots
    streamed back (evenly spaced in sweeps; the last one always lands on
    ``n_sweeps``, so the final snapshot covers the whole chain).
    """
    L: int                          # lattice side (2-D square, 3-D cube)
    beta: float                     # model-native coupling
    n_sweeps: int
    n_samples: int = 1
    seed: int = 0
    model: str = "ising"            # ising | potts
    q: int = 0                      # Potts states (model="potts" only)
    dims: int = 2                   # 2 | 3 (3-D: ising metropolis only)
    algorithm: str = "metropolis"   # metropolis | swendsen_wang | wolff
    rule: str = "metropolis"        # metropolis | heat_bath
    dtype: str = "bfloat16"

    def engine_config(self) -> EngineConfig:
        """The standalone EngineConfig this request must reproduce
        bitwise (measure_every=1: every sweep is a kept sample)."""
        return EngineConfig(size=self.L, beta=self.beta,
                            n_sweeps=self.n_sweeps, model=self.model,
                            q=self.q, dims=self.dims,
                            algorithm=self.algorithm, rule=self.rule,
                            dtype=self.dtype, measure=True)

    def validate(self) -> EngineConfig:
        """Reject malformed requests with the engine's own config rules
        (plus the serving-only sampling-cadence constraints); returns the
        validated standalone config."""
        if self.n_sweeps < 1:
            raise ValueError(f"n_sweeps must be >= 1, got {self.n_sweeps}")
        if not 1 <= self.n_samples <= self.n_sweeps:
            raise ValueError(
                f"n_samples must be in [1, n_sweeps={self.n_sweeps}], "
                f"got {self.n_samples}")
        cfg = self.engine_config()
        cfg.validate()
        return cfg

    def bucket_key(self) -> tuple:
        """The shape key the scheduler buckets by. Everything that fixes a
        bucket's sweep family — lattice shape, dynamics family, dtype — is
        in the key; beta/seed/n_sweeps are per-slot values and
        deliberately are NOT."""
        return (self.model, self.q, self.dims, self.L, self.algorithm,
                self.rule, self.dtype)

    def sample_points(self) -> tuple:
        """Sweep counts at which snapshots are due: ``n_samples`` points
        evenly spaced by ``ceil``, ending exactly at ``n_sweeps``."""
        return tuple(math.ceil(i * self.n_sweeps / self.n_samples)
                     for i in range(1, self.n_samples + 1))

    def n_spins(self) -> int:
        return self.L ** self.dims


class RequestUpdate(NamedTuple):
    """One streamed snapshot: running moments over the first
    ``sweeps_done`` sweeps (``measure.finalize`` dict — m_abs, E, U4,
    ...). The snapshot at ``sweeps_done = t`` equals a standalone
    ``n_sweeps = t`` run's moments bitwise."""
    request_id: int
    sweeps_done: int
    done: bool
    moments: dict


@dataclasses.dataclass
class RequestResult:
    """Terminal record of one request (returned by
    ``MCServeEngine.result`` / ``run_until_idle``)."""
    request_id: int
    request: SimRequest
    status: str                                  # DONE | CANCELLED
    moments: Optional[dict] = None               # final snapshot (DONE only)
    magnetization: Optional[object] = None       # np.ndarray f32 [n_sweeps]
    energy: Optional[object] = None              # np.ndarray f32 [n_sweeps]
    updates: list = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0

    @property
    def latency(self) -> float:
        """Submit-to-final wall seconds (0.0 until terminal)."""
        if not self.finished_at:
            return 0.0
        return self.finished_at - self.submitted_at
