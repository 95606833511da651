"""Plain Swendsen-Wang sweeps of the full [H, W] torus.

The stated rule of the ``swendsen_wang`` configurations, for a sweep key
k (``fold_in(chunk_key, step)``):

* bonds: the bond from site g = i W + j to its right (direction 0) or
  lower (direction 1) neighbour is open when the two spins are equal and
  the top 24 bits of ``fold_in_word(fold_in(k, 0), 2 g + direction)`` are
  below ceil(p 2**24), p = f32(1 - f32(exp(-2 beta)));
* clusters: the connected components of the open bonds, each labelled by
  its smallest site index g;
* coins: a cluster flips when the top bit of
  ``fold_in_word(fold_in(k, 1), label)`` is set.

Components are found by hooking and pointer jumping (each crossing edge
hooks the larger of its two roots under the smaller, then every site jumps
to its root), a different algorithm from label propagation, with the same
fixed point: the smallest index of each component.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import threefry

U24 = 1 << 24


def threshold(beta: float, precision: str = "float32") -> int:
    """ceil(p 2**24) for p = f32(1 - f32(exp(-2 beta))); ``bfloat16``
    rounds p on to bfloat16."""
    p = np.float32(np.float32(1.0) - np.float32(math.exp(-2.0 * float(beta))))
    if precision == "bfloat16":
        p = float(torch.tensor(float(p)).to(torch.bfloat16))
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return min(math.ceil(float(p) * U24), U24)


def bonds(full: torch.Tensor, key, thresh: int) -> tuple:
    """(right, down) open-bond masks [H, W]."""
    h, w = full.shape
    g = torch.arange(h * w, dtype=torch.int64, device=full.device).view(h, w)
    kb = threefry.fold_in(key, 0)

    def opened(direction):
        word = threefry.fold_in_word(kb, 2 * g + direction)
        return ((word >> 8) & (U24 - 1)) < thresh

    right = (full == torch.roll(full, -1, 1)) & opened(0)
    down = (full == torch.roll(full, -1, 0)) & opened(1)
    return right, down


def components(right: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """The smallest site index of each site's cluster, int64 [H, W]."""
    h, w = right.shape
    n = h * w
    dev = right.device
    g = torch.arange(n, dtype=torch.int64, device=dev)
    u_r = g[right.reshape(-1)]
    v_r = (u_r // w) * w + (u_r % w + 1) % w
    u_d = g[down.reshape(-1)]
    v_d = (u_d + w) % n
    u, v = torch.cat([u_r, u_d]), torch.cat([v_r, v_d])
    parent = g.clone()
    while u.numel():
        pu, pv = parent[u], parent[v]
        cross = pu != pv
        if not bool(cross.any()):
            break
        u, v, pu, pv = u[cross], v[cross], pu[cross], pv[cross]
        parent.scatter_reduce_(0, torch.maximum(pu, pv),
                               torch.minimum(pu, pv), reduce="amin")
        while True:
            jumped = parent[parent]
            if torch.equal(jumped, parent):
                break
            parent = jumped
    return parent.view(h, w)


def sweep(full: torch.Tensor, key, thresh: int) -> torch.Tensor:
    right, down = bonds(full, key, thresh)
    label = components(right, down)
    coin = (threefry.fold_in_word(threefry.fold_in(key, 1), label) >> 31) & 1
    return torch.where(coin == 1, -full, full)

