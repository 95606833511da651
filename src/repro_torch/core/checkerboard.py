"""Checkerboard Metropolis updates for the 2-D Ising model (paper §3).

The port of ``repro.core.checkerboard``. Three implementations, bitwise
comparable when fed the same uniforms:

* :func:`update_color_full`    — brute-force oracle on the full [H, W]
                                 lattice (``torch.roll`` neighbour sums).
* :func:`update_naive`         — paper Algorithm 1: blocked matmuls against
                                 the tridiagonal kernel K + colour mask M.
* :func:`update_color_compact` — paper Algorithm 2: compact parity quads,
                                 matmuls against the bidiagonal kernel
                                 K-hat. The products stay ``torch.matmul``:
                                 their results are small integers, exact in
                                 bf16 and f32.

Site updates dispatch on :mod:`repro_torch.core.update_rules`; on the card
the LUT rule at a Python-number beta and no field runs as one flip kernel
(:func:`repro_torch.kernels.flip.flip_lut`). The Algorithm-2 neighbour
sums (:func:`nn_black`, :func:`nn_white`: the K-hat matmuls and the halo
lines) run inside the ``repro_torch.checkerboard.nn`` span, the site
update (:func:`_flip`) inside ``repro_torch.checkerboard.flip``.
"""
from __future__ import annotations

import torch

from repro_torch.core import lattice as L
from repro_torch.core import update_rules as rules
from repro_torch.kernels import flip as kflip
from repro_torch.spans import span

NN = "repro_torch.checkerboard.nn"
FLIP = "repro_torch.checkerboard.flip"
# the rule names whose float-uniform form the flip kernel computes
KERNEL_RULES = ("lut", "metropolis", "metropolis_lut")


def _kernel_takes(sigma, nn, probs, beta, accept, field, out) -> bool:
    """Whether the flip kernel computes this update on the card: the LUT
    rule, a Python-number beta (one table for every site), no field, and
    operands the kernel takes."""
    return (accept in KERNEL_RULES and isinstance(beta, (int, float))
            and not field
            and kflip.operands_problem(sigma, nn, probs, out) is None)


def _flip(sigma, nn, probs, beta, accept: str, field: float = 0.0,
          out=None):
    """One colour's site update through the update-rule registry, written
    to ``out`` when given (``sigma`` itself may be) and returned. On the
    card the LUT rule at a number beta and no field is one flip kernel
    launch; every other form runs the rule's eager chain."""
    with span(FLIP):
        if sigma.is_cuda and _kernel_takes(sigma, nn, probs, beta, accept,
                                           field, out):
            return kflip.flip_lut(sigma, nn, probs,
                                  kflip.lut_table(beta, sigma.dtype), out)
        new = rules.get_rule(accept).flip_probs(sigma, nn, probs, beta, field)
        return new if out is None else out.copy_(new)


# ---------------------------------------------------------------------------
# Oracle: full-lattice rolls
# ---------------------------------------------------------------------------


def nn_full(full: torch.Tensor) -> torch.Tensor:
    """Sum of the 4 nearest neighbours on the torus, shape [H, W]."""
    return (torch.roll(full, 1, 0) + torch.roll(full, -1, 0)
            + torch.roll(full, 1, 1) + torch.roll(full, -1, 1))


def update_color_full(full, probs, beta, color: int, accept: str = "lut",
                      field: float = 0.0) -> torch.Tensor:
    """Oracle checkerboard half-sweep; probs is a full [H, W] uniform array."""
    h, w = full.shape
    i = (torch.arange(h, device=full.device)[:, None]
         + torch.arange(w, device=full.device)[None, :])
    mask = i % 2 == color
    flipped = _flip(full, nn_full(full).to(full.dtype), probs, beta, accept,
                    field)
    return torch.where(mask, flipped, full)


def sweep_full(full, probs_black, probs_white, beta, accept: str = "lut",
               field: float = 0.0) -> torch.Tensor:
    full = update_color_full(full, probs_black, beta, 0, accept, field)
    return update_color_full(full, probs_white, beta, 1, accept, field)


# ---------------------------------------------------------------------------
# Paper Algorithm 1 — naive blocked matmul update
# ---------------------------------------------------------------------------


def nn_naive(blocked: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Neighbour sums for a [mr, mc, b, b] blocked lattice (Algorithm 1
    l.2-6): sigma @ K sums left + right, K @ sigma up + down, then each
    block adds the edge line of its four torus neighbours."""
    nn = torch.matmul(blocked, k) + torch.matmul(k, blocked)
    nn[:, :, 0, :] += torch.roll(blocked, 1, 0)[:, :, -1, :]    # north
    nn[:, :, -1, :] += torch.roll(blocked, -1, 0)[:, :, 0, :]   # south
    nn[:, :, :, 0] += torch.roll(blocked, 1, 1)[:, :, :, -1]    # west
    nn[:, :, :, -1] += torch.roll(blocked, -1, 1)[:, :, :, 0]   # east
    return nn


def update_naive(full, probs, beta, color: int,
                 block_size: int = L.MXU_BLOCK,
                 accept: str = "lut") -> torch.Tensor:
    """Paper Algorithm 1 on a full [H, W] lattice (blocked internally).

    Every site gets a neighbour sum, an acceptance and a uniform; the
    global colour mask keeps the other colour's flips out (a block's
    in-block parity is the global parity because ``block_size`` is even).
    """
    sig = L.block(full, block_size)
    k = L.kernel_naive(block_size, full.dtype, full.device)
    nn = nn_naive(sig, k).to(full.dtype)
    p = L.block(probs, block_size)
    acc = rules.metropolis_acceptance(nn, sig, beta, accept)
    mask = L.color_mask(block_size, color, torch.bool, full.device)
    flips = (p.to(acc.dtype) < acc) & mask
    return L.unblock(torch.where(flips, -sig, sig))


# ---------------------------------------------------------------------------
# Paper Algorithm 2 — compact parity-quad update
# ---------------------------------------------------------------------------
#
# With A=s00, B=s01, C=s10, D=s11 and K-hat upper-bidiagonal,
#   nn(A) = B@Kh + KhT@C   (+west-wrap of B, +north-wrap of C)
#   nn(D) = Kh@B + C@KhT   (+south-wrap of B, +east-wrap of C)
#   nn(B) = A@KhT + KhT@D  (+east-wrap of A, +north-wrap of D)
#   nn(C) = Kh@A + D@Kh    (+south-wrap of A, +west-wrap of D)
# "wrap" terms live on the neighbouring tile.


def _bmm(x, k):          # per-block x @ k
    return torch.matmul(x, k)


def _bmm_t(k, x):        # per-block k @ x
    return torch.matmul(k, x)


def default_edges(xb: torch.Tensor, side: str) -> torch.Tensor:
    """Edge line each block borrows from its ``side`` neighbour (torus).

    xb: [..., mr, mc, bs, bs] blocked quad. Returns [..., mr, mc, bs]: e.g.
    for side="north", entry (r, c) is row bs-1 of block (r-1, c).
    """
    if side == "north":
        return torch.roll(xb[..., -1, :], 1, -3)
    if side == "south":
        return torch.roll(xb[..., 0, :], -1, -3)
    if side == "west":
        return torch.roll(xb[..., :, -1], 1, -2)
    if side == "east":
        return torch.roll(xb[..., :, 0], -1, -2)
    raise ValueError(side)


def edge_lines(a, b, c, d, color: int, edges=default_edges):
    """The 4 halo lines one colour update needs: (row0, col0, row1, col1).

    row0 is added to row 0 of nn0, col0 to a column of nn0 (col 0 for black,
    col -1 for white), row1 to row -1 of nn1, col1 to a column of nn1
    (col -1 black, col 0 white).
    """
    if color == 0:   # nn(A), nn(D)
        return (edges(c, "north"), edges(b, "west"),
                edges(b, "south"), edges(c, "east"))
    return (edges(d, "north"), edges(a, "east"),
            edges(a, "south"), edges(d, "west"))


def nn_black(a, b, c, d, kh, edges=default_edges):
    """nn sums for the black quads (A, D); inputs are [..., mr, mc, bs, bs]."""
    with span(NN):
        kht = kh.T
        row0, col0, row1, col1 = edge_lines(a, b, c, d, 0, edges)
        nn_a = _bmm(b, kh) + _bmm_t(kht, c)
        nn_a[..., :, 0] += col0    # west col of B
        nn_a[..., 0, :] += row0    # north row of C
        nn_d = _bmm_t(kh, b) + _bmm(c, kht)
        nn_d[..., -1, :] += row1   # south row of B
        nn_d[..., :, -1] += col1   # east col of C
    return nn_a, nn_d


def nn_white(a, b, c, d, kh, edges=default_edges):
    """nn sums for the white quads (B, C)."""
    with span(NN):
        kht = kh.T
        row0, col0, row1, col1 = edge_lines(a, b, c, d, 1, edges)
        nn_b = _bmm(a, kht) + _bmm_t(kht, d)
        nn_b[..., :, -1] += col0   # east col of A
        nn_b[..., 0, :] += row0    # north row of D
        nn_c = _bmm_t(kh, a) + _bmm(d, kh)
        nn_c[..., -1, :] += row1   # south row of A
        nn_c[..., :, 0] += col1    # west col of D
    return nn_b, nn_c


def update_color_compact(quads, probs0, probs1, beta, color: int,
                         block_size: int = L.MXU_BLOCK, accept: str = "lut",
                         edges=default_edges, field: float = 0.0,
                         return_stats: bool = False):
    """Paper Algorithm 2: update one colour of the compact representation.

    quads:  [4, R, C] parity sub-lattices, or [N, 4, R, C] for N replicas
            (then ``beta`` is a number or an [N] tensor).
    probs0: [..., R, C] uniforms for the colour's first quad (A if black,
            else B).
    probs1: [..., R, C] uniforms for the second quad (D if black, C else).
    return_stats: also return ``(new0, new1, nn0, nn1)`` (blocked), which
        the measurement plane turns into the bond energy.
    Returns a new stack of ``quads``' shape.
    """
    kh = L.kernel_compact(block_size, quads.dtype, quads.device)
    q = quads.unbind(-3)
    a, b, c, d = (L.block(x, block_size) for x in q)
    if color == 0:  # black: flip A and D
        nn0, nn1 = nn_black(a, b, c, d, kh, edges)
        s0, s1 = a, d
    else:           # white: flip B and C
        nn0, nn1 = nn_white(a, b, c, d, kh, edges)
        s0, s1 = b, c
    p0 = L.block(probs0, block_size)
    p1 = L.block(probs1, block_size)
    new0 = _flip(s0, nn0.to(s0.dtype), p0, beta, accept, field)
    new1 = _flip(s1, nn1.to(s1.dtype), p1, beta, accept, field)
    if color == 0:
        out = torch.stack([L.unblock(new0), q[1], q[2], L.unblock(new1)], -3)
    else:
        out = torch.stack([q[0], L.unblock(new0), L.unblock(new1), q[3]], -3)
    if return_stats:
        return out, (new0, new1, nn0, nn1)
    return out


def sweep_compact(quads, probs, beta, block_size: int = L.MXU_BLOCK,
                  accept: str = "lut", edges=default_edges,
                  field: float = 0.0) -> torch.Tensor:
    """One full sweep (black then white). probs: [..., 4, R, C] uniforms,
    laid out as [black0, black1, white0, white1]."""
    p = probs.unbind(-3)
    quads = update_color_compact(quads, p[0], p[1], beta, 0, block_size,
                                 accept, edges, field)
    return update_color_compact(quads, p[2], p[3], beta, 1, block_size,
                                accept, edges, field)


def quad_probs_from_full(probs_black, probs_white) -> torch.Tensor:
    """Slice full-lattice uniform arrays into the compact layout, so the
    compact update is bitwise-identical to the oracle fed the same arrays."""
    pb = L.to_quads(probs_black)
    pw = L.to_quads(probs_white)
    return torch.stack([pb[L.Q00], pb[L.Q11], pw[L.Q01], pw[L.Q10]])
