"""Carry state between the JAX package and the port, as numpy arrays.

The JAX package's arrays reach this module as numpy arrays
(``np.asarray(jax_array)``); nothing here imports JAX. Conversions:

* lattices of any layout — quads ``[4, R, C]``, blocked quads
  ``[4, mr, mc, bs, bs]``, full ``[H, W]``, replica stacks
  ``[R, 4, r, c]``, the 3-D cube ``[D, H, W]`` — in float32 or bfloat16
  (bfloat16 crosses through a ``uint16`` view, because
  ``torch.from_numpy`` rejects ``ml_dtypes.bfloat16``), and int32 Potts
  colours ``[H, W]`` / ``[R, H, W]`` and cluster labels as they are;
* uint32 random bits become the port's int32 tensors holding the same bit
  pattern (:func:`bits_to_torch`): PyTorch has no ``+``, ``<<``, ``>>`` or
  ``<`` for ``torch.uint32`` on the CPU, and the kernels read 4-byte words
  (arithmetic on the values happens in int64 lanes inside
  :mod:`repro_torch.random`);
* uint32 thresholds (u24 bond and acceptance tables) become int64 tensors
  holding the same values (:func:`thresholds_to_torch`);
* uint32 key data becomes the port's host key, a pair of Python ints;
* the decoder LM's parameter and optimizer-state trees (nested dicts and
  lists of numpy arrays, ``jax.tree.map(np.asarray, tree)``) become the
  same trees of tensors (:func:`lm_params_from_jax`,
  :func:`opt_state_from_jax`), or, given ``blocks=(grid, placements)``,
  as this rank's blocks of them.
"""
from __future__ import annotations

import numpy as np
import torch


def _is_bfloat16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def to_torch(a, device="cpu") -> torch.Tensor:
    """A numpy lattice (float32, bfloat16, int or bool) as a torch tensor
    of the same shape (0-d included)."""
    a = np.ascontiguousarray(a).reshape(np.shape(a))
    if _is_bfloat16(a):
        t = torch.from_numpy(a.view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    if a.dtype == np.uint32:
        raise TypeError("uint32 arrays are bits or keys: use bits_to_torch "
                        "or key_from_numpy")
    return torch.from_numpy(a.copy()).to(device)


def to_numpy(t: torch.Tensor, bfloat16_dtype=None) -> np.ndarray:
    """A torch tensor as numpy. bfloat16 comes back as ``bfloat16_dtype``
    (pass ``ml_dtypes.bfloat16`` or ``jnp.bfloat16``), else as a float32
    array with the same values."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        if bfloat16_dtype is None:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(np.uint16).view(bfloat16_dtype)
    return t.numpy()


def bits_to_torch(bits, device="cpu") -> torch.Tensor:
    """uint32 bits -> int32 tensor with the same bit pattern."""
    a = np.ascontiguousarray(bits, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def bits_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The port's int32 bit pattern -> uint32 numpy bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def thresholds_to_torch(t, device="cpu") -> torch.Tensor:
    """uint32 thresholds (any shape) -> int64 tensor with the same values."""
    a = np.asarray(t, dtype=np.uint32).astype(np.int64)
    return torch.from_numpy(a).to(device)


def thresholds_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The port's int64 thresholds -> uint32 numpy values."""
    return t.detach().cpu().numpy().astype(np.uint32)


def key_from_numpy(key_data) -> tuple:
    """uint32 key data [2] (``np.asarray(jax_key)``) -> the port's key."""
    k = np.asarray(key_data, dtype=np.uint32).reshape(2)
    return (int(k[0]), int(k[1]))


def key_to_numpy(key) -> np.ndarray:
    """The port's key -> uint32 key data [2] (``jnp.asarray`` gives a JAX
    raw key)."""
    return np.asarray(key, dtype=np.uint32)


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, device) for v in tree]
    return to_torch(np.asarray(tree), device)


def _blocks(full, blocks):
    if blocks is None:
        return full
    from repro_torch.distributed import sharding
    return sharding.local_blocks(blocks[0], full, blocks[1])


def lm_params_from_jax(params, cfg, device="cpu", blocks=None) -> dict:
    """The reference's LM parameter tree (numpy leaves) as the port's,
    checked leaf by leaf against the port's own tree for ``cfg`` (paths,
    shapes and dtypes); with ``blocks=(grid, placements)`` this rank's
    blocks of it."""
    from repro_torch import tree
    from repro_torch.models import transformer
    out = _tree_to_torch(params, device)
    want = tree.paths(transformer.init_model(cfg, device="meta"))
    got = tree.paths(out)
    if [(p, tuple(a.shape), a.dtype) for p, a in got] != \
            [(p, tuple(a.shape), a.dtype) for p, a in want]:
        raise ValueError(f"the parameter tree does not match {cfg.name}'s: "
                         f"{[(p, tuple(a.shape)) for p, a in got]}")
    return _blocks(out, blocks)


def opt_state_from_jax(state, device="cpu", blocks=None) -> dict:
    """The reference's optimizer state (numpy leaves; int32 ``count``) as
    the port's (this rank's blocks with ``blocks=(grid, placements)``)."""
    return _blocks(_tree_to_torch(state, device), blocks)

