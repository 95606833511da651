"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source in ``csrc/`` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). Libraries go to
``build/repro_torch/`` at the repository root, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one
loads. Nothing is built when this module is imported: :func:`load` builds
on first use, and :func:`build` builds several sources at once, one
``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
SOURCES = {
    "checkerboard_tiles": "checkerboard_tiles.cu",
    "checkerboard_lines": "checkerboard_lines.cu",
    "blocked_totals": "blocked_totals.cu",
    "threefry_fold": "threefry_fold.cu",
}

_LOADED: dict = {}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc") or DEFAULT_NVCC
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where the library of source ``name`` lives for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` each, all started together. Returns ``{name: log}`` with the
    compiler's output (register and spill counts from ``-Xptxas -v``) for
    the ones built. Raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    logs, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        logs[name] = f"{name}: {time.perf_counter() - t0:.1f} s\n{log}"
        if proc.returncode:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if missing."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]
