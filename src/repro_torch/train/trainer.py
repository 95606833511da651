"""Training loop with the fault-tolerance envelope (the port of
``repro.train.trainer``):

* checkpoint/restart (atomic, keep-k, optional async writer) through
  :mod:`repro_torch.checkpoint.ckpt`, whose files the reference reads too;
* straggler watchdog (per-step wall time against a running median; it
  logs and counts);
* preemption-safe: SIGTERM sets a flag, the loop checkpoints and exits
  cleanly;
* elastic restart: on a process grid the state's leaves are rank blocks
  and ``state_shardings`` (``(grid, placement)`` per leaf) tells the
  checkpoint how to gather and re-block them, so a run saved on one grid
  resumes on another.
"""
from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from typing import Callable, Optional

from repro_torch import tree
from repro_torch.checkpoint import ckpt


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    ckpt_async: bool = False
    log_every: int = 10
    straggler_factor: float = 3.0   # step > factor * median -> straggler event


class Trainer:
    def __init__(self, train_step: Callable, state, data_iter,
                 cfg: TrainLoopConfig, state_shardings=None,
                 log_fn: Callable = print):
        self.train_step = train_step
        self.state = state
        self.data_iter = data_iter
        self.cfg = cfg
        self.state_shardings = state_shardings
        self.log = log_fn
        self.step_times: list[float] = []
        self.straggler_events = 0
        self._stop = False
        self._ckpt_thread = None

    def request_stop(self, *_args):
        self._stop = True

    def install_signal_handler(self):
        signal.signal(signal.SIGTERM, self.request_stop)

    # -- fault tolerance -----------------------------------------------------

    def maybe_restore(self) -> int:
        cfg = self.cfg
        step = ckpt.latest_step(cfg.ckpt_dir) if cfg.ckpt_dir else None
        if step is None:
            return 0
        device = tree.leaves(self.state)[0].device
        self.state = ckpt.restore(cfg.ckpt_dir, self.state, step,
                                  self.state_shardings, device=device)
        self.log(f"[trainer] restored checkpoint at step {step}")
        return step

    def _checkpoint(self, step: int):
        if not self.cfg.ckpt_dir:
            return
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
        self._ckpt_thread = ckpt.save(self.cfg.ckpt_dir, self.state, step,
                                      keep=self.cfg.ckpt_keep,
                                      async_=self.cfg.ckpt_async,
                                      shardings=self.state_shardings)

    # -- main loop -------------------------------------------------------------

    def run(self) -> dict:
        cfg = self.cfg
        start = self.maybe_restore()
        losses, grad_norms = [], []
        for step in range(start, cfg.total_steps):
            if self._stop:
                self.log(f"[trainer] preemption signal at step {step}; "
                         "checkpointing and exiting")
                self._checkpoint(step)
                break
            batch = next(self.data_iter)
            t0 = time.perf_counter()
            self.state, metrics = self.train_step(self.state, batch)
            loss = float(metrics["loss"])     # waits for the step
            dt = time.perf_counter() - t0
            # straggler watchdog
            if len(self.step_times) >= 5:
                med = statistics.median(self.step_times[-50:])
                if dt > cfg.straggler_factor * med:
                    self.straggler_events += 1
                    self.log(f"[trainer] straggler: step {step} took "
                             f"{dt:.3f}s vs median {med:.3f}s")
            self.step_times.append(dt)
            losses.append(loss)
            grad_norms.append(float(metrics["grad_norm"]))
            if step % cfg.log_every == 0:
                self.log(f"[trainer] step {step} loss {loss:.4f} "
                         f"({dt*1e3:.0f} ms)")
            if cfg.ckpt_dir and (step + 1) % cfg.ckpt_every == 0:
                self._checkpoint(step + 1)
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
        return {"losses": losses, "grad_norms": grad_norms,
                "straggler_events": self.straggler_events,
                "steps_run": len(losses), "start_step": start}
