"""Connected-component labeling: canonical min-index labels of a bond
graph.

The port of ``repro.cluster.label``. Every site is labeled with the
minimum linear index of its cluster, so labels are canonical: any exact
algorithm gives the same bits.

* **On a CUDA device** :func:`label_components` launches one hand-written
  union-find (:mod:`repro_torch.kernels.label`, counted in
  ``kernels.build.launches["label_components"]``): no rounds, no host
  sync. ``with_iters`` then gives 0 iterations and ``rounds_per_iter`` is
  not read.
* **On the CPU** it runs :func:`propagate`, the reference's iterated
  min-label propagation and the plain version the kernel is held to. Every
  site starts labeled with its own linear index; each round takes the
  minimum label over its active-bond neighbours (rolls + ``minimum``) and
  then pointer-jumps (``lab = lab[lab]``). The reference's ``while_loop``
  on a changed flag becomes a host loop: one iteration runs
  ``rounds_per_iter`` rounds and then reads the changed flag with one
  ``.item()``, so every iteration is one host sync. The fixed point does
  not depend on that cadence, and iterations are counted as the reference
  counts them. :data:`counters` accumulates these iterations, so it counts
  the plain path alone.

A stack of bond graphs ``[N, H, W]`` is labeled in one call, each replica
in its own index space. The propagation runs until no replica changes, and
a replica at its fixed point stays there, so its labels are those of a run
of its own.
"""
from __future__ import annotations

import torch

from repro_torch.spans import span

_INT_MAX = torch.iinfo(torch.int32).max

# label iterations (one changed-flag host sync each), summed over calls
counters = {"iterations": 0}


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


def init_labels(h: int, w: int, device="cpu") -> torch.Tensor:
    return torch.arange(h * w, dtype=torch.int32, device=device).view(h, w)


def neighbor_min(lab, bond_right, bond_down) -> torch.Tensor:
    """min(label, labels of bond-connected neighbours)."""
    inf = torch.full_like(lab, _INT_MAX)
    east = torch.where(bond_right, torch.roll(lab, -1, -1), inf)
    west = torch.where(torch.roll(bond_right, 1, -1),
                       torch.roll(lab, 1, -1), inf)
    south = torch.where(bond_down, torch.roll(lab, -1, -2), inf)
    north = torch.where(torch.roll(bond_down, 1, -2),
                        torch.roll(lab, 1, -2), inf)
    return torch.minimum(lab, torch.minimum(torch.minimum(east, west),
                                            torch.minimum(south, north)))


def pointer_jump(lab, jumps: int = 2) -> torch.Tensor:
    """lab <- label-of-label, ``jumps`` times (the doubling step), within
    each replica of a stack."""
    flat = lab.reshape(lab.shape[:-2] + (-1,))
    for _ in range(jumps):
        flat = torch.gather(flat, -1, flat.long())
    return flat.view(lab.shape)


def propagate(bond_right, bond_down, rounds_per_iter: int = 2) -> tuple:
    """The plain version on any device: ``(labels, iterations)`` of the
    min-label propagation to its fixed point, one changed-flag host sync an
    iteration (counted in :data:`counters`)."""
    h, w = bond_right.shape[-2:]
    lab = init_labels(h, w, bond_right.device).expand(bond_right.shape)
    iters = 0
    changed = True
    while changed:
        new = lab
        for _ in range(rounds_per_iter):
            new = pointer_jump(neighbor_min(new, bond_right, bond_down),
                               jumps=1)
        flag = torch.any(new != lab)
        with span("repro_torch.cluster.label.sync"):
            changed = bool(flag.item())
        lab = new
        iters += 1
    counters["iterations"] += iters
    return lab, iters


def label_components(bond_right, bond_down, with_iters: bool = False,
                     rounds_per_iter: int = 2):
    """Canonical min-index labels of the bond graph, [..., h, w] int32;
    with ``with_iters`` also the iteration count (an int: the propagation's
    on the CPU, 0 on the card). A CUDA tensor launches the union-find
    kernel, a CPU tensor runs :func:`propagate`, any other device raises."""
    with span("repro_torch.cluster.label"):
        if bond_right.device.type == "cpu":
            lab, iters = propagate(bond_right, bond_down, rounds_per_iter)
        else:
            from repro_torch.kernels import label as K
            lab, iters = K.label_components(bond_right, bond_down), 0
    if with_iters:
        return lab, iters
    return lab
