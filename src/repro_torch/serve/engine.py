"""Continuous-batched Monte Carlo serving engine.

The port of ``repro.serve.engine``: many concurrent
:class:`repro_torch.serve.request.SimRequest` jobs, bucketed by shape,
padded to a fixed replica width, and stepped as ONE replica stack of one
sweep family per bucket — the trick LM servers use for token streams,
applied to MCMC chains:

* **bucket** — requests sharing ``(model, q, dims, L, algorithm, rule,
  dtype)`` ride one sweep family; the scheduler
  (:class:`repro_torch.serve.scheduler.BucketScheduler`) queues per bucket,
  FIFO within and round-robin across (starvation-free).
* **slot** — each bucket run owns ``replica_width`` replica slots; a
  request occupies one slot and carries its OWN chain key and sweep
  counter. Unoccupied slots hold a zero lattice under the key
  ``PRNGKey(0)`` at beta 0.5, swept and discarded before any statistics
  are read.
* **chunk** — each ``step()`` advances one bucket by ``chunk_sweeps``
  sweeps: every sweep steps the whole stack in one pass, each slot's draws
  folded with its own absolute step (``fold_in(chain_key_i,
  sweeps_done_i + j)``, a per-replica step list). At chunk boundaries
  finished/cancelled requests free their slots and queued requests are
  admitted — continuous batching: a long chain never blocks short ones.
* **stream** — the per-sweep ``(m, E)`` of every slot stays on the device
  through the chunk and comes to the host in one copy at its end; each
  request accumulates its own series and emits running-moment snapshots
  (``measure.finalize`` dicts) at its ``sample_points()``.

Bitwise batching-independence: every draw of every sweep family
(:func:`repro_torch.api.engine.replica_sweep_fns`, shared with the
engine's ensembles) is addressed by ``(chain_key, absolute_step)``, and
row i of a stack equals that replica swept alone, so a request's streamed
moments equal a standalone ``IsingEngine(request.engine_config())
.simulate(seed)`` run regardless of bucket packing, slot, chunk boundaries
or neighbours — and equal the JAX package's serving plane
(``tests/test_torch_serve.py``). As there, a slot's beta enters as an f32
tensor (the compiled form of the tables), a standalone chain's as a
Python number.

Requests live on ``device`` (the CUDA device unless the caller passes
``"cpu"``). A failed chunk raises; nothing is retried elsewhere.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.api import IsingEngine
from repro_torch.api import engine as api_engine
from repro_torch.core import lattice as L
from repro_torch.core import measure
from repro_torch.launch import mesh as mesh_lib
from repro_torch.serve import request as rq
from repro_torch.serve.scheduler import BucketScheduler


def slot_template(cfg, device="cpu") -> torch.Tensor:
    """Padding lattice for an unoccupied replica slot: zeros in the
    bucket's slot layout (a legal input to every sweep family — pad slots
    are swept and discarded, never read)."""
    size = cfg.size
    if cfg.model == "potts":
        return torch.zeros((size, size), dtype=torch.int32, device=device)
    dt = L.torch_dtype(cfg.dtype)
    if cfg.dims == 3:
        return torch.zeros((size, size, size), dtype=dt, device=device)
    if cfg.algorithm != "metropolis":
        return torch.zeros((size, size), dtype=dt, device=device)  # full view
    return torch.zeros((4, size // 2, size // 2), dtype=dt, device=device)


def _slot_state(cfg, eng: IsingEngine, k_init) -> torch.Tensor:
    """Initial slot state — the engine's own init, converted to the slot
    layout (Ising cluster sweeps run on the full view; the engine stores
    quads)."""
    state = eng.init(k_init)
    if (cfg.model == "ising" and cfg.dims == 2
            and cfg.algorithm != "metropolis"):
        return L.from_quads(state)
    return state


@dataclasses.dataclass
class _Tracked:
    """Host-side record of one live request."""
    result: rq.RequestResult
    chain_key: tuple
    state: Optional[torch.Tensor]
    sweeps_done: int = 0
    next_sample: int = 0
    slot: Optional[tuple] = None          # (bucket_key, slot index) | None
    callback: Optional[Callable] = None
    m_buf: Optional[np.ndarray] = None    # f32 [n_sweeps], filled to done
    e_buf: Optional[np.ndarray] = None

    @property
    def request(self) -> rq.SimRequest:
        return self.result.request

    @property
    def status(self) -> str:
        return self.result.status


class _BucketRun:
    """One active bucket: ``width`` replica slots + its sweep family."""

    def __init__(self, bucket_key: tuple, cfg, width: int, device):
        self.bucket_key = bucket_key
        self.cfg = cfg                    # representative EngineConfig
        self.width = width
        self.slots: list = [None] * width  # request ids (or None = pad)
        self.template = slot_template(cfg, device)
        self.pad_key = jr.PRNGKey(0)

    def free_slots(self) -> list:
        return [i for i, rid in enumerate(self.slots) if rid is None]

    def empty(self) -> bool:
        return all(rid is None for rid in self.slots)


@dataclasses.dataclass
class ChunkTime:
    """One chunk of one bucket: ``live`` slots held requests; ``chunk_s``
    is the host clock of the whole chunk (admission bookkeeping, stacking,
    sweeps, the copy to the host, harvest), ``sweep_s`` the sweeps alone
    (CUDA events on the card, the host clock on the CPU)."""
    bucket_key: tuple
    live: int
    chunk_s: float
    sweep_s: float


class MCServeEngine:
    """Simulation-as-a-service: submit/cancel/step/poll over SimRequests.

    Deterministic given the call sequence — wall clocks are recorded for
    latency reporting (and :attr:`chunk_times`) but never steer
    scheduling — so randomized submit/cancel schedules are exactly
    replayable in tests.
    """

    def __init__(self, replica_width: int = 8, chunk_sweeps: int = 16,
                 device=None):
        if replica_width < 1:
            raise ValueError(f"replica_width must be >= 1, got "
                             f"{replica_width}")
        if chunk_sweeps < 1:
            raise ValueError(f"chunk_sweeps must be >= 1, got "
                             f"{chunk_sweeps}")
        self.replica_width = replica_width
        self.chunk_sweeps = chunk_sweeps
        self.device = mesh_lib.resolve_device(device)
        self.scheduler = BucketScheduler()
        self._requests: dict = {}
        self._active: "OrderedDict[tuple, _BucketRun]" = OrderedDict()
        self._service: deque = deque()    # round-robin over active buckets
        self._runners: dict = {}          # bucket_key -> chunk fn
        self._next_id = 0
        self.chunk_times: list = []       # ChunkTime per chunk swept

    # ------------------------------------------------------------------
    # Submission / cancellation / inspection
    # ------------------------------------------------------------------

    def submit(self, req: rq.SimRequest,
               callback: Optional[Callable] = None) -> int:
        """Validate and enqueue a request; returns its id. ``callback``
        (if given) fires on every streamed :class:`RequestUpdate`."""
        req.validate()
        rid = self._next_id
        self._next_id += 1
        k_init, k_chain = jr.split(jr.PRNGKey(req.seed))
        # Init now so admission at a chunk boundary is a pure slot write.
        # Same split(PRNGKey(seed)) as engine.simulate.
        cfg = req.engine_config()
        state = _slot_state(cfg, IsingEngine(cfg, device=self.device),
                            k_init)
        self._requests[rid] = _Tracked(
            result=rq.RequestResult(request_id=rid, request=req,
                                    status=rq.PENDING,
                                    submitted_at=time.perf_counter()),
            chain_key=k_chain, state=state, callback=callback,
            m_buf=np.empty(req.n_sweeps, np.float32),
            e_buf=np.empty(req.n_sweeps, np.float32))
        self.scheduler.submit(rid, req.bucket_key())
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a pending or running request. Running requests leave
        their slot at the next chunk boundary; already-terminal requests
        return False."""
        t = self._requests.get(rid)
        if t is None or t.status in (rq.DONE, rq.CANCELLED):
            return False
        if t.status == rq.PENDING:
            self.scheduler.cancel(rid)
        t.result.status = rq.CANCELLED
        t.result.finished_at = time.perf_counter()
        t.state = None
        return True

    def status(self, rid: int) -> str:
        return self._requests[rid].status

    def result(self, rid: int) -> rq.RequestResult:
        return self._requests[rid].result

    def updates(self, rid: int) -> list:
        """All snapshots streamed so far for one request."""
        return list(self._requests[rid].result.updates)

    @property
    def idle(self) -> bool:
        return not self._active and not self.scheduler.pending()

    # ------------------------------------------------------------------
    # The serving loop
    # ------------------------------------------------------------------

    def step(self) -> list:
        """One scheduling turn: activate buckets with pending work, pick
        the next active bucket round-robin, admit queued requests into its
        free slots, sweep one chunk, harvest per-slot streams. Returns the
        RequestUpdates emitted this turn."""
        self._activate()
        if not self._service:
            return []
        bucket_key = self._service[0]
        self._service.rotate(-1)
        run = self._active[bucket_key]
        self._admit(run)
        if run.empty():
            self._deactivate(bucket_key)
            return []
        updates = self._advance(run)
        if run.empty() and not self.scheduler.pending(bucket_key):
            self._deactivate(bucket_key)
        return updates

    def run_until_idle(self, max_steps: int = 1_000_000) -> dict:
        """Drain every queue; returns {request_id: RequestResult} for all
        requests that reached a terminal state."""
        steps = 0
        while not self.idle:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"serving loop did not drain in {max_steps} steps "
                    f"(pending={self.scheduler.pending()}, "
                    f"active={list(self._active)})")
        return {rid: t.result for rid, t in self._requests.items()
                if t.status in (rq.DONE, rq.CANCELLED)}

    def serve(self, requests, callback: Optional[Callable] = None) -> list:
        """Convenience batch API: submit everything, drain, return results
        in submission order."""
        rids = [self.submit(r, callback) for r in requests]
        self.run_until_idle()
        return [self._requests[rid].result for rid in rids]

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------

    def _activate(self) -> None:
        while True:
            key = self.scheduler.next_bucket(exclude=tuple(self._active))
            if key is None:
                return
            rid = self.scheduler.peek(key)
            cfg = self._requests[rid].request.engine_config()
            self._active[key] = _BucketRun(key, cfg, self.replica_width,
                                           self.device)
            self._service.append(key)

    def _deactivate(self, bucket_key: tuple) -> None:
        self._active.pop(bucket_key, None)
        try:
            self._service.remove(bucket_key)
        except ValueError:
            pass

    def _admit(self, run: _BucketRun) -> None:
        free = run.free_slots()
        for slot, rid in zip(free, self.scheduler.take(run.bucket_key,
                                                       len(free))):
            t = self._requests[rid]
            if t.status == rq.CANCELLED:   # cancelled while queued
                continue
            run.slots[slot] = rid
            t.slot = (run.bucket_key, slot)
            t.result.status = rq.RUNNING
            t.result.started_at = time.perf_counter()

    def _runner(self, run: _BucketRun):
        """The bucket's chunk: ``chunk_sweeps`` measured sweeps of the
        slot stack, each slot at its own absolute step; returns the final
        stack and the ``[2, width, chunk]`` (m, E) series on the host."""
        key = run.bucket_key
        if key not in self._runners:
            _, one_sweep_measured, rep_args = \
                api_engine.replica_sweep_fns(run.cfg)
            chunk = self.chunk_sweeps
            device = self.device

            def run_chunk(states, keys, betas, offsets):
                args = rep_args(betas, device)
                ms, es = [], []
                for j in range(chunk):
                    states, (m, e) = one_sweep_measured(
                        states, keys, args, [o + j for o in offsets])
                    ms.append(m)
                    es.append(e)
                series = torch.stack([torch.stack(ms, -1),
                                      torch.stack(es, -1)])
                return states, series

            self._runners[key] = run_chunk
        return self._runners[key]

    def _advance(self, run: _BucketRun) -> list:
        """Sweep one chunk of one bucket and harvest per-slot streams."""
        t0 = time.perf_counter()
        states, keys, betas, offsets = [], [], [], []
        live = 0
        for rid in run.slots:
            t = self._requests[rid] if rid is not None else None
            if t is None or t.status != rq.RUNNING:
                states.append(run.template)
                keys.append(run.pad_key)
                betas.append(0.5)
                offsets.append(0)
            else:
                live += 1
                states.append(t.state)
                keys.append(t.chain_key)
                betas.append(t.request.beta)
                offsets.append(t.sweeps_done)
        stack = torch.stack(states)
        on_card = self.device.type == "cuda"
        if on_card:
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            ev0.record()
        ts = time.perf_counter()
        final, series = self._runner(run)(stack, keys, betas, offsets)
        if on_card:
            ev1.record()
        series = series.cpu().numpy()     # one copy: [2, width, chunk]
        sweep_s = (ev0.elapsed_time(ev1) / 1e3 if on_card
                   else time.perf_counter() - ts)
        ms, es = series

        updates: list = []
        for slot, rid in enumerate(run.slots):
            if rid is None:
                continue                       # pad slot: output discarded
            t = self._requests[rid]
            if t.status != rq.RUNNING:         # cancelled mid-chunk
                run.slots[slot] = None
                t.slot = None
                continue
            take = min(self.chunk_sweeps,
                       t.request.n_sweeps - t.sweeps_done)
            t.m_buf[t.sweeps_done:t.sweeps_done + take] = ms[slot, :take]
            t.e_buf[t.sweeps_done:t.sweeps_done + take] = es[slot, :take]
            t.sweeps_done += take
            if t.sweeps_done >= t.request.n_sweeps:
                run.slots[slot] = None         # free the slot
                t.slot = None
                t.state = None
            else:
                t.state = final[slot]
            updates.extend(self._emit_snapshots(t))
        self.chunk_times.append(ChunkTime(run.bucket_key, live,
                                          time.perf_counter() - t0, sweep_s))
        return updates

    def _emit_snapshots(self, t: _Tracked) -> list:
        """Emit every snapshot whose sample point the request has crossed;
        the final one marks the request DONE."""
        points = t.request.sample_points()
        out = []
        while (t.next_sample < len(points)
               and points[t.next_sample] <= t.sweeps_done):
            p = points[t.next_sample]
            t.next_sample += 1
            mom = measure.finalize(measure.moments_from_series(
                t.m_buf[:p], t.e_buf[:p]))
            done = p >= t.request.n_sweeps
            upd = rq.RequestUpdate(t.result.request_id, p, done, mom)
            t.result.updates.append(upd)
            if done:
                t.result.status = rq.DONE
                t.result.moments = mom
                t.result.magnetization = t.m_buf
                t.result.energy = t.e_buf
                t.result.finished_at = time.perf_counter()
            if t.callback is not None:
                t.callback(upd)
            out.append(upd)
        return out
