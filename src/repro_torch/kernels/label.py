"""The device form of ``cluster.label.label_components``: canonical
connected-component labels of a periodic bond graph by union-find. CUDA
wrapper.

:func:`label_components` takes the bool bond masks ``[..., H, W]`` on a
CUDA device and returns int32 labels of the same shape: every site the
smallest row-major index of its cluster, each ``[H, W]`` graph of a stack
in its own index space. Source: ``csrc/label_components.cu``. It replaces
no TPU kernel: the reference leaves labels to XLA's ``while_loop``.

``cluster.label.label_components`` launches it for masks on a CUDA device.
On CPU masks the wrapper runs the plain version,
``cluster.label.propagate``, the oracle the tests hold the kernel to. Each
call is counted in ``build.launches["label_components"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.cluster import label as LBL
from repro_torch.kernels import build

# the right and down masks' pointers, the labels' pointer, graphs, H, W
_P = ctypes.c_void_p
_LABEL = build.Entry("label_components", "label_components",
                     "ising_label_components",
                     (_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int))


def label_components(bond_right: torch.Tensor,
                     bond_down: torch.Tensor) -> torch.Tensor:
    """Canonical min-index labels of the bond graph, ``[..., H, W]`` int32
    (``bond_right[y, x]`` joins ``(y, x)`` to ``(y, x + 1 mod W)``,
    ``bond_down[y, x]`` to ``(y + 1 mod H, x)``)."""
    if bond_right.dtype != torch.bool or bond_down.dtype != torch.bool:
        raise TypeError(f"bond masks must be bool, got {bond_right.dtype} "
                        f"and {bond_down.dtype}")
    if bond_right.shape != bond_down.shape or bond_right.dim() < 2:
        raise ValueError(f"bond masks must share one [..., H, W] shape, got "
                         f"{tuple(bond_right.shape)} and "
                         f"{tuple(bond_down.shape)}")
    if bond_right.device != bond_down.device:
        raise ValueError("bond masks must lie on one device")
    if not build.on_cuda(_LABEL, bond_right.device):
        return LBL.propagate(bond_right, bond_down)[0]
    h, w = bond_right.shape[-2:]
    if h * w >= 2 ** 31:
        raise ValueError(f"a graph of {h} x {w} sites: labels are int32, so "
                         f"H W must stay below 2**31")
    out = torch.empty(bond_right.shape, dtype=torch.int32,
                      device=bond_right.device)
    if out.numel() == 0:
        return out
    right, down = bond_right.contiguous(), bond_down.contiguous()
    build.launch(_LABEL, out.device, right, down, out, out.numel() // (h * w),
                 h, w)
    return out
