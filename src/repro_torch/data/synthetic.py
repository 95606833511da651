"""Deterministic synthetic token pipeline (the port of
``repro.data.synthetic``).

Sequences follow a learnable affine recurrence over a reduced vocabulary
(token_{i+1} = (a * token_i + c) mod k), so small models measurably reduce
loss within a few hundred steps. Generation is counter-based in
(step, row): any row of any batch is produced on its own. ``host_batch``
and ``_row`` are the reference's numpy code (uint64 arithmetic), so the
batches are bitwise the reference's. On a process grid each rank builds
only the rows it computes on (``rows``: ``distributed.sharding.
batch_rows``), never the global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.lattice import torch_dtype

_A, _C = 31, 17


@dataclasses.dataclass(frozen=True)
class DataConfig:
    k_vocab: int = 211          # reduced vocab (prime)
    seed: int = 1234


def _row(step: int, row: int, seq_len: int, k: int, seed: int) -> np.ndarray:
    """One deterministic sequence of length seq_len+1."""
    t0 = (np.uint64(step) * np.uint64(2654435761)
          + np.uint64(row) * np.uint64(97) + np.uint64(seed)) % np.uint64(k)
    out = np.empty(seq_len + 1, np.int64)
    t = int(t0)
    for i in range(seq_len + 1):
        out[i] = t
        t = (_A * t + _C) % k
    return out


def host_batch(step: int, shape: ShapeConfig, cfg: ModelConfig,
               data_cfg: DataConfig = DataConfig(), rows=None) -> dict:
    """The batch's ``rows`` (all of them by default) on the host, as numpy
    arrays in that order. The VLM stub's ``vision_embeds`` are float32
    zeros here (numpy has no bfloat16); :func:`iterate` casts them to the
    model's dtype."""
    k = min(cfg.vocab_size, data_cfg.k_vocab)
    if rows is None:
        rows = range(shape.global_batch)
    seqs = np.stack([_row(step, b, shape.seq_len, k, data_cfg.seed)
                     for b in rows])
    n = len(seqs)
    tokens = seqs[:, :-1].astype(np.int32)
    labels = seqs[:, 1:].astype(np.int32)
    if cfg.n_codebooks:
        tokens = np.repeat(tokens[..., None], cfg.n_codebooks, -1)
        labels = np.repeat(labels[..., None], cfg.n_codebooks, -1)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "vlm":
        batch["vision_embeds"] = np.zeros((n, shape.seq_len, cfg.d_model),
                                          np.float32)
        batch["vision_mask"] = np.zeros((n, shape.seq_len), bool)
        pos = np.arange(shape.seq_len, dtype=np.int32)
        batch["positions"] = np.broadcast_to(
            pos[None, :, None], (n, shape.seq_len, 3)).copy()
    return batch


def device_batch(step: int, shape: ShapeConfig, cfg: ModelConfig, device,
                 data_cfg: DataConfig = DataConfig(), rows=None) -> dict:
    """:func:`host_batch` as tensors on ``device``."""
    out = {name: torch.from_numpy(arr).to(device)
           for name, arr in host_batch(step, shape, cfg, data_cfg,
                                       rows).items()}
    if "vision_embeds" in out:
        out["vision_embeds"] = out["vision_embeds"].to(torch_dtype(cfg.dtype))
    return out


def iterate(shape: ShapeConfig, cfg: ModelConfig, device, start_step: int = 0,
            data_cfg: DataConfig = DataConfig(), rows=None) -> Iterator[dict]:
    """Batches ``start_step, start_step + 1, ...`` (their ``rows``) on
    ``device``."""
    step = start_step
    while True:
        yield device_batch(step, shape, cfg, device, data_cfg, rows)
        step += 1
