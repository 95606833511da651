"""Build the CUDA kernels with ``nvcc``, load them with ``ctypes``, and
launch them.

Each source in ``csrc/`` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). Libraries go to
``build/repro_torch/`` at the repository root, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one
loads. Nothing is built when this module is imported: :func:`load` builds
on first use, and :func:`build` builds several sources at once, one
``nvcc`` process each.

Every wrapper of ``kernels/`` launches through this module. It follows the
device rule of :func:`on_cuda` (a CUDA tensor launches, a CPU tensor runs
the wrapper's plain version, any other device raises), describes its C
entry point as an :class:`Entry`, and calls :func:`launch`, which counts
the launch in :data:`launches` under the wrapper's name. A new kernel is
one ``.cu`` file, one :data:`SOURCES` entry, one :data:`launches` key and
a wrapper.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

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
    "label_components": "label_components.cu",
    "threefry_draw": "threefry_draw.cu",
    "metropolis_flip": "metropolis_flip.cu",
}

# the spins' dtype as the kernels' ``dtype`` argument
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches since the last reset_launches(), by wrapper name
launches = dict.fromkeys((
    "update_color_tiles", "update_color_lines", "update_color_tiles_keyed",
    "update_color_lines_keyed", "blocked_totals", "fold_in_bits",
    "threefry_bits", "label_components", "threefry_draw", "flip_lut"), 0)

_LOADED: dict = {}
_FUNCTIONS: dict = {}


class Entry(NamedTuple):
    """A kernel's C entry point: the wrapper that launches it (its key in
    :data:`launches`), its library (a :data:`SOURCES` key), its symbol, and
    the ctypes of its arguments before the stream, which every entry takes
    last. Every entry returns 0 or a ``cudaError_t``."""
    wrapper: str
    library: str
    symbol: str
    args: tuple


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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


def on_cuda(entry: Entry, device, *operands) -> bool:
    """The device rule of every wrapper: True on a CUDA device, where the
    wrapper launches ``entry`` once its ``operands`` are found contiguous;
    False on the CPU, where it runs its plain version. Any other device
    raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{entry.wrapper} runs on CUDA or CPU tensors (the "
                         f"CPU runs its plain version), got {device}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError(f"{entry.wrapper}: kernel operands must be "
                         f"contiguous")
    return True


def _function(entry: Entry):
    """The loaded C function of ``entry``, its signature set once."""
    fn = _FUNCTIONS.get(entry)
    if fn is None:
        fn = getattr(load(entry.library), entry.symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = [*entry.args, ctypes.c_void_p]
        _FUNCTIONS[entry] = fn
    return fn


def launch(entry: Entry, device, *args) -> None:
    """Call ``entry`` with ``args`` (a tensor passes its data pointer) on
    ``device``'s current stream, and count the launch under its wrapper's
    name. A nonzero return raises and counts nothing."""
    fn = _function(entry)
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry.symbol} launch failed: cudaError {err}")
    launches[entry.wrapper] += 1
