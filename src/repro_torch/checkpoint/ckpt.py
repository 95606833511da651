"""Fault-tolerant checkpointing: atomic, keep-k, async, grid-agnostic.

The port of ``repro.checkpoint.ckpt``. Checkpoints are
``step_NNNNNNNN.npz`` files of flat ``path -> array`` maps (dict keys and
sequence indices joined by "/", as the reference names them), written to
a temp file and moved into place with ``os.replace`` (atomic on POSIX), so
a preempted writer never leaves a corrupt latest checkpoint. bfloat16 is
widened to float32 on save (exact) and narrowed back on restore, so the
port's checkpoints and the reference's read each other.

On a process grid a leaf may be a rank's block: pass ``shardings``, a
matching tree of ``(grid, placement)`` (``IsingEngine.state_sharding()``)
or None per leaf. ``save`` gathers each block to rank 0, which alone
writes; ``restore`` reads the global array on every rank and keeps the
rank's own block, so a checkpoint saved on one grid restores on any other.
"""
from __future__ import annotations

import os
import re
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree

_STEP_RE = re.compile(r"step_(\d+)\.npz$")


# [(path, leaf)] in the reference's order: dict keys sorted, sequence
# items in order, parts joined by "/"
_flatten = tree.paths


def _leaf_shardings(shardings, n: int) -> list:
    """One ``(grid, placement)`` or None per leaf: ``shardings`` mirrors
    the state's dicts and lists, a pair being a leaf."""
    if shardings is None:
        return [None] * n

    def walk(node):
        if isinstance(node, dict):
            return [s for k in sorted(node) for s in walk(node[k])]
        if isinstance(node, list):
            return [s for v in node for s in walk(v)]
        return [node]

    return walk(shardings)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:      # npz has no bfloat16;
            t = t.float()                  # f32 widening is exact
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def save(ckpt_dir: str, state, step: int, keep: int = 3,
         async_: bool = False,
         shardings=None) -> Optional[threading.Thread]:
    """Write ``state`` at ``step`` and prune to the newest ``keep``
    checkpoints. Leaves with a sharding are gathered to rank 0 first; in a
    process group every rank calls and rank 0 alone writes. Returns the
    writer thread when ``async_``."""
    writer = not dist.is_initialized() or dist.get_rank() == 0
    leaves = _flatten(state)
    flat = {}
    for (key, leaf), sh in zip(leaves,
                               _leaf_shardings(shardings, len(leaves))):
        if sh is not None:
            grid, placement = sh
            leaf = grid.gather(leaf, placement, dst=0)
        if writer:
            flat[key] = _to_numpy(leaf)
    if not writer:
        return None

    def _write():
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}.npz")
        final = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, final)
        _prune(ckpt_dir, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep else []:
        try:
            os.remove(os.path.join(ckpt_dir, f"step_{s:08d}.npz"))
        except OSError:
            pass


def all_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for f in os.listdir(ckpt_dir):
        m = _STEP_RE.match(f)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _dtype_of(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.as_tensor(np.asarray(leaf)).dtype


def restore(ckpt_dir: str, like, step: Optional[int] = None,
            shardings=None, device="cpu"):
    """Restore into the structure of ``like`` (tensors or ``meta``
    templates such as ``IsingEngine.state_template()``: only the dtype is
    read). A leaf with a sharding comes back as this rank's block of the
    saved global array, on the grid's device; the others on ``device``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    leaves = _flatten(like)
    out = []
    with np.load(path) as data:
        for (key, leaf), sh in zip(leaves,
                                   _leaf_shardings(shardings, len(leaves))):
            t = torch.from_numpy(np.array(data[key]))
            want = _dtype_of(leaf)
            if t.dtype != want:              # e.g. bf16 widened on save
                t = t.to(want)
            if sh is not None:
                grid, placement = sh
                t = grid.local_block(t, placement).to(grid.device)
            else:
                t = t.to(device)
            out.append(t)
    return tree.unflatten(like, out)
