"""Shared fixtures and helpers.

Device-count policy: the main pytest process sees ONE CPU device (jax locks
the device count at first backend init, and the dry-run's 512-device trick
must never leak into smoke tests). Tests that genuinely need a mesh spawn a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=N`` via
:func:`run_in_subprocess`.

Subprocess snippets that need ``shard_map`` must import it from
``repro.compat`` (NOT ``jax.shard_map``): the shim papers over the
jax.experimental -> jax move and the ``check_rep`` -> ``check_vma`` rename,
so snippets run on every jax version the container may pin.

Property-based testing note: ``hypothesis`` is not installed in this
container, so property-style tests are hand-rolled — randomized inputs drawn
from seeded generators, swept over parametrized shapes/dtypes/seeds. The
invariants they check (round-trips, oracle equivalence, detailed balance
statistics) are the same ones a hypothesis strategy would drive.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")


def run_in_subprocess(code: str, devices: int = 8, timeout: int = 900,
                      env_extra: dict | None = None):
    """Run ``code`` in a fresh python with N virtual devices; return stdout.

    Raises on a non-zero exit (stderr included in the failure message).
    """
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    if devices:
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={devices}")
    if env_extra:
        env.update(env_extra)
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=str(REPO))
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed (rc={proc.returncode})\n"
            f"--- stdout ---\n{proc.stdout}\n--- stderr ---\n{proc.stderr}")
    return proc.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "statistical: equilibrium/autocorrelation comparisons on finite MC "
        "series. Seeds are pinned (deterministic on a fixed jax version) "
        "but the assertions are tolerance-bounded, not bitwise, and the "
        "runs are long; CI executes them in a separate non-blocking job "
        "(-m statistical) so the blocking suite stays fast and exact.")
    config.addinivalue_line(
        "markers",
        "cuda: runs a CUDA kernel, which has no CPU form; skips without a "
        "card (the test decides, never at import). On the card: "
        "PYTHONPATH=src python -m pytest -m cuda tests/")


@pytest.fixture(scope="session")
def subproc():
    return run_in_subprocess


def small_config(name: str, **overrides):
    """Family-preserving reduced config for CPU smoke tests."""
    from repro.configs import get_config

    cfg = get_config(name)
    small = {
        "dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab_size=256, head_dim=16),
        "moe": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                    d_ff=96, moe_d_ff=96, vocab_size=256, head_dim=16,
                    n_experts=4, experts_per_token=min(
                        2, cfg.experts_per_token or 1)),
        "vlm": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                    d_ff=128, vocab_size=256, head_dim=16),
        "audio": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=128, vocab_size=64, head_dim=16,
                      vocab_pad_multiple=64),
        "hybrid": dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
                       d_ff=128, vocab_size=256, head_dim=16, window=8),
        "ssm": dict(n_layers=2, d_model=64, vocab_size=256, ssm_state=16,
                    ssm_head_dim=16, ssm_chunk=8),
    }[cfg.family]
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
