#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py            # from the repository root, one card

Phases (any failure exits non-zero; nothing is caught and passed over):

1. the card's name and power limit, from ``nvidia-smi``;
2. build the CUDA kernel libraries from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` each, started together; each half-sweep library holds an
   operand form and a keyed form of its kernel, the third the measurement
   kernel) and time the build, with registers and spills;
3. hold every form bitwise against its plain PyTorch version on the card:
   both colours, both rules, bf16 and f32, bs 12, 16, 24, 32, 64 and 128
   (12 and 24 take the generic instantiation), square and non-square tile
   grids including mr = 1, and operands that are not 16-byte aligned;
   each keyed form also against ``color_bits`` fed to the operand kernel;
   the kernels' device hash (``ising_threefry_bits``) against
   ``random._bits_lanes`` at counter 0 and across 2**32; and the card's
   plain version against the CPU's at one small shape; the measurement
   kernel (``kernels.measure.blocked_totals``) equal to its plain version
   on the same shapes and dtypes, unaligned quads included;
3b. the fold-in kernel (``kernels.rng.fold_in_bits``, which
    ``random.fold_in_bits`` launches for counters on the card) bitwise
    against its eager int64 form (``random._fold_in_bits_eager``) at the
    Swendsen-Wang cells' shapes: 5120^2 bond counters ``2 gi + d`` under
    one key, the int32 labels of a 5120^2 lattice, and 16 x 4096^2 rows
    that a key batch shares (stride 0); then one 5120^2 Swendsen-Wang
    sweep through ``IsingEngine`` with the counts set to 0 just before
    and read just after: 3 fold-in launches, 0 eager passes;
3c. the label kernel (``kernels.label.label_components``, which
    ``cluster.label.label_components`` launches for bond masks on the
    card) bitwise against the plain propagation (``cluster.label.
    propagate``) run to its fixed point on the same masks: 5120^2 FK bonds
    at the Swendsen-Wang cells' two betas, a stack of 4 x 1000^2 and
    ragged 37 x 53; then one 5120^2 Swendsen-Wang sweep through
    ``IsingEngine``: 1 label launch, 0 label iterations;
3d. the draw kernel (``kernels.rng.draw``, which ``random.bits``,
    ``uniform``, ``bernoulli`` and ``randint`` launch on the card) bitwise
    against its eager int64 form (``random._draw_eager``) at the launcher's
    colour draw [2, 80, 80, 128, 128]: bf16 uniforms under one key, f32
    uniforms under a 16-key batch and randint in [-3, 4), one launch each;
    then one 20480^2 sweep of the launcher's default engine (a 1 x 1 grid,
    the paper pipeline): 2 draw launches;
3e. the flip kernel (``kernels.flip.flip_lut``, which
    ``core.checkerboard._flip`` launches on the card for the LUT rule at a
    number beta and no field) bitwise against the eager LUT chain
    (``update_rules``' ``flip_probs``) at a quad of the launcher's colour
    update [80, 80, 128, 128] at T_c: bf16 spins and uniforms into a new
    tensor and in place, bf16 spins with f32 uniforms, f32 spins with bf16
    uniforms, one launch each; then one 20480^2 sweep of the launcher's
    default engine: 4 flip launches. Phases 3b and 4 read 0 flip launches
    on the Swendsen-Wang and keyed paths;
4. the main path at full size: ``IsingEngine(EngineConfig(size=20480,
   beta=0.4406868, backend=b, hot=True)).simulate(0)`` for b in pallas and
   pallas_lines, measured, with every launch count reset just before and
   read just after (2 per sweep for the backend's keyed kernel, 0 for every
   other form; 1 measurement kernel launch per sweep); the two backends'
   final states bitwise equal; the explicit-
   bits path (``ops.update_color`` fed ``ops.color_bits``, the operand
   forms, 2 launches per sweep) equal to the keyed sweeps at 20480^2; the
   kernel path at 256^2 on the card equal to the CPU plain path (state and
   series); the "chain" scenario at 4096^2;
4b. paper Algorithm 1 (``core.checkerboard.update_naive``): card == CPU
    bitwise at 256^2, and one sweep at 4096^2 (bs 128) against Algorithm
    2's on the same uniforms; ``rng="rbg"`` of the decomposed lattice: the
    device generator's bits (the same for one key), the reference's
    physics bounds at 128^2, and the xla opt sweep at 20480^2 against
    threefry;
4c. the decoder LM (no kernel): qwen3-0.6b at ``--scale 0.05`` in f32 with
    the same weights on the card and the CPU (logits, loss, grads, 3
    AdamW steps, prefill and 4 decode steps), ``launch.train`` resumed from
    a checkpoint == a straight run; the cost of f32 attention scores from
    bf16 operands; ``launch.train`` at the published width (seq 4096,
    batch 8 in 4 microbatches): ms a step, tokens/s, peak memory, the
    losses, the share of the bf16 peak, one step's device time by kernel
    (``torch.profiler``), then prefill 1 x 4096 and 32 decode steps;
4d. the recurrent, SSM and MoE layers (no kernel): mamba2, recurrentgemma
    ('rrl') and kimi (MoE, top-8) at ``--scale 0.05`` in f32, card == CPU
    as in 4c with each config's optimizer; ``launch.train`` resumed ==
    straight, bitwise, for kimi and mamba2; the main path of these layers,
    ``launch.train`` at the published mamba2-780m (seq 4096, batch 8 in 4
    microbatches, 4 steps: ms a step, tokens/s, peak memory, losses, bf16
    peak share, one microbatch by kernel, the chunked SSD's share), then
    prefill 1 x 4096 and 32 decode steps; recurrentgemma-2b as published,
    prefill and decode, and 4 training steps with the depth cut to 12
    layers (the RG-LRU scan's share); kimi-k2 at its published width with
    1 layer: prefill 1 x 4096 (dropped slots), 32 decode steps, and the
    MoE layer against its bound at both shapes;
4e. the LM sharding engine (no kernel), each part on a one-rank NCCL
    group: ``launch.train --mesh 1,1`` at 4c's published qwen3-0.6b
    (the sharded step) with losses and grad norms bitwise 4c's, ms a step
    and peak memory beside 4c's; ``psum_compressed`` of one microbatch's
    gradient tree bitwise the quantize / dequantize round trip, timed;
    kimi's MoE layer of 4d at prefill 1 x 4096 through ``moe_forward_ep``
    bitwise ``moe_forward``, and one rank's share of the production
    16-way model axis (24 of 384 experts) against its byte bound;
4f. the dry-run, the op counter and the sharded serving path (no
    kernel): 4c's published qwen3-0.6b through the sharded prefill
    (1 x 4096) and 32 decode steps on a one-rank NCCL grid, bitwise the
    unsharded prefill and decode, ms a token beside them (median and
    range of 10 runs each, in alternating order); the op counter
    around one real 4c train step on the card against the ``meta`` count
    of the same step on a 1 x 1 layout (FLOPs, bytes, every op's count;
    any difference is named); 4c's and 4d's measured step times beside
    their roofline step times and dominant terms; ``python -m
    repro_torch.launch.dryrun`` over every default cell on both
    production layouts (16 x 16, 2 x 16 x 16), in parallel CLI processes
    on the host's cores, with the per-rank table (trace time, peak GB,
    fits, dominant term, MFU); ``python -m repro_torch.launch.diagnose``
    for kimi-k2 ``train_4k``, top 10 ops; one rank's share of the
    tensor-parallel step on the card: rank 0 of 16 x 16 ``train_4k`` for
    qwen3-4b and for qwen2-vl-7b, whose batch over (data, model) has
    every weight block gathered over the model ring and its gradient
    reduce-scattered (its state blocks and batch rows as real tensors,
    its collectives recorded and not sent, so its values are only
    checked finite), its op count against the ``meta`` count of the same
    rank op for op and its collectives by kind against the ``meta``
    rank's, one step's ms against that rank's roofline (and the device's
    busy share of a profiled step), its tracked peak against
    ``torch.cuda.max_memory_allocated``;
5. every other ported scenario at a small size, card == CPU bitwise
   (state, series, moments, extras): ensemble (bf16, f32), tempering
   (with accepted swaps), 3-D
   at 16^3, Swendsen-Wang and Wolff at one and two betas, Potts q=3
   checkerboard (heat-bath, Metropolis) and clusters, and f32 chains at a
   beta where torch's own exp differs from the port's XLA f32 tables;
6. each of those scenarios at a size its users run, host clock per sweep
   around a synchronised ``IsingEngine.run`` after a warm-up run, with
   label kernel launches per cluster sweep;
   a 64-replica ensemble at 256^2 stepped in one pass against the same
   replicas one at a time (bitwise equal, both timed); the share of a
   sweep that is threefry bits, and the share of a Swendsen-Wang sweep
   spent in threefry bits and the label kernel, beside the plain
   propagation's rounds and changed-flag checks on the same bonds;
7. the decomposed lattice at a small size, card == CPU bitwise (state and
   moments): ``"mesh"`` (one-rank grid) and ``"opt"`` on the xla paper
   pipeline, the xla opt pipeline and ``pallas_lines``, measured
   (Metropolis, bf16) and not (heat-bath, f32), at 256^2 (bs 16),
   ``"mesh3d"`` at 16^3, and at 256^2 ``"cluster_mesh"`` (SW, Wolff),
   ``"potts_cluster_mesh"`` (SW, q=3), ``"potts_cb_mesh"`` (heat-bath,
   q=3) and a replica ensemble on the grid; both lines forms bitwise
   against their plain versions with halo lines that differ from the local
   torus roll (an edge provider of negated lines), at a small shape and
   the main path's;
8. the serving plane (no kernel): the seven-shape mix at width 4, chunk
   5, served on the card == served on the CPU == the standalone engine on
   the card, bitwise; then ``repro_torch.launch.serve`` with 64 requests
   of 512^2 and 1024^2 (Ising Metropolis / SW / Wolff, Potts q=2, 3),
   width 8, chunk 16: req/s, Msites/s, P50/P99 latency, ms per chunk of
   each bucket and the share of a chunk outside the sweeps;
9. a one-rank NCCL process group, then the same ``mesh`` / ``opt`` paths at
   20480^2 (80 x 80 blocks of bs 128, bf16, beta 0.4406868, hot, 3
   sweeps), measured and not: 2 keyed lines-kernel launches per sweep on
   ``pallas_lines`` and none elsewhere, the measured runs' stats
   all-reduced over the group, flips/ns and peak memory; ``mesh3d`` timed
   at 512^3; the cluster and Potts meshes and a 16 x 4096^2 replica
   ensemble at their single-device twins' sizes (ms per sweep beside the
   twin's, label kernel launches, cross-rank merge iterations, which one rank
   never enters, and all-reduces per sweep); the launcher
   (``repro_torch.launch.simulate``) at 4096^2 on one rank: 6 sweeps with
   a checkpoint every 3, a resume to 9, equal bitwise to a straight
   9-sweep run;
10. CUDA-event timings at the main path's shapes: each of the four forms
    (the lines forms with their halo lines made outside the timed
    launches) against its bound and its plain version (the keyed forms'
    bound is bytes or integer issue, whichever is larger, from the
    instructions per site in the built library's SASS and the card's SM
    clock), color_bits, the measurement kernel against its byte bound (2
    bytes a site) and its plain version, the fold-in kernel at 5120^2
    against its bound (bytes or integer issue, whichever is larger) and
    its eager form, the label kernel at 5120^2 (both cells' betas) against
    its byte bound and the plain propagation, the draw kernel at the
    launcher's colour draw against its bound (integer issue or bytes,
    whichever is larger) and its eager form, the flip kernel at a quad of
    the launcher's colour update in place against its byte bound (8 B a
    site) and the eager chain with its copy into the stack, blocked_stats, and the kernel
    path's sweeps per second measured and not (flips/ns), peak memory.

Every path of phases 4-9 runs with the kernel launch counts
(``kernels.build.launches``) set to 0 just before and read just after: 2
per sweep for the form the path runs, 0 for the other forms and for the
scenarios that run no kernel (the serving plane, the cluster/Potts meshes,
Algorithm 1, rbg, every LM family, the LM sharding engine and phase 4f
among them); the measurement kernel's count reads 1 a measured sweep on
the kernel paths and 0 on every other (the grids' measurement takes the
matmul chain).

The fold-in and label kernels' counts are read in phases 3b, 3c, 6 and
9: the cluster scenarios launch the fold-in kernel 3 times and the label
kernel once a 2-D Swendsen-Wang sweep, and "no kernel" above speaks of
the half-sweep and measurement forms.

It prints one JSON line of kernel records, then the card line, then the
contract line ``{"ok": true, "device": {...}}`` last. Without a CUDA device,
or without the repository beside it, it prints no result and exits 1.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

BETA = 0.4406868
SIZE = 20480                 # 104.9 M sites per quad, 80 x 80 tiles of 128
BS = 128
MAIN_SWEEPS = 3
CHAIN_SIZE = 4096
# the card's data-sheet rates (HBM bytes/s, f32 and dense bf16 FLOP/s):
# one copy, repro_torch.analysis.roofline's, read in main() once the
# package is importable
HBM_BYTES_PER_S = F32_FLOPS = BF16_FLOPS = None
FLOPS_PER_SITE = 10          # 3 adds, 1 multiply, <= 4 compares, 1 convert

TILES_CU = "src/repro_torch/kernels/csrc/checkerboard_tiles.cu"
LINES_CU = "src/repro_torch/kernels/csrc/checkerboard_lines.cu"
TOTALS_CU = "src/repro_torch/kernels/csrc/blocked_totals.cu"
FOLD_CU = "src/repro_torch/kernels/csrc/threefry_fold.cu"
LABEL_CU = "src/repro_torch/kernels/csrc/label_components.cu"
DRAW_CU = "src/repro_torch/kernels/csrc/threefry_draw.cu"
# the launcher's colour draw at 20480^2: [2, 80, 80, 128, 128]
DRAW_SHAPE = (2, SIZE // 2 // BS, SIZE // 2 // BS, BS, BS)
FLIP_CU = "src/repro_torch/kernels/csrc/metropolis_flip.cu"
# a quad of the launcher's colour update at 20480^2: [80, 80, 128, 128]
FLIP_SHAPE = DRAW_SHAPE[1:]
SW_SIZE = 5120               # the Swendsen-Wang cells' lattice
# the Swendsen-Wang cells' betas (1.1 T_c and 2 T_c)
SW_BETAS = {"sw-near-critical": 0.4006244, "sw-hot": 0.2203434}
# name -> source, the TPU kernel it replaces, keyed form or not
KERNELS = {
    "update_color_tiles": dict(
        source=TILES_CU, replaces="src/repro/kernels/checkerboard.py:208",
        keyed=False),
    "update_color_lines": dict(
        source=LINES_CU, replaces="src/repro/kernels/checkerboard.py:169",
        keyed=False),
    "update_color_tiles_keyed": dict(
        source=TILES_CU, replaces="src/repro/kernels/checkerboard.py:208",
        keyed=True),
    "update_color_lines_keyed": dict(
        source=LINES_CU, replaces="src/repro/kernels/checkerboard.py:169",
        keyed=True),
}
# kernel backend -> (the keyed form its sweeps launch, its operand form)
BACKENDS = {"pallas": ("update_color_tiles_keyed", "update_color_tiles"),
            "pallas_lines": ("update_color_lines_keyed",
                             "update_color_lines")}
# the launch counts phases 4-9 read: the half-sweep forms' and the
# measurement kernel's
SWEEP_LAUNCHES = (*KERNELS, "blocked_totals")
# A keyed form's work a site and the card's instruction rates are the
# benchmark's (perfbench/work.py), imported where the timing phase runs.
# What one counter of the fold-in kernel needs: x1 alone of threefry2x32,
# so the 20 rounds' rotations and xors with no output xor (ALU only), and
# the 20 rounds' adds with the 5 injections of both key words (either
# pipe).
FOLD_ALU_ONLY, FOLD_ADDS = 20 + 20, 20 + 10
# What one word of the draw kernel needs, as perfbench's draw_roofline_pct
# counts it: x0 ^ x1 of threefry2x32, so the 20 rotations and 21 xors (ALU
# only) and the 20 rounds' adds with the 5 injections and the last one's
# two (either pipe).
DRAW_ALU_ONLY, DRAW_ADDS = 20 + 21, 20 + 5 + 2


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """CUDA-event time of one call of ``fn``: two events around ``reps``
    calls back to back, so the card does not wait on a call's host work
    (the wrapper's checks and launch) when that is shorter than the call's
    device work."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_fns():
    """name -> (wrapper, plain version, keyed)."""
    from repro_torch.kernels import checkerboard as kern
    return {name: (getattr(kern, name), getattr(kern, name + "_plain"),
                   spec["keyed"]) for name, spec in KERNELS.items()}


def blocked_state(seed, mr, mc, bs, dtype, device):
    from repro_torch import random as jr
    from repro_torch.core import sampler
    from repro_torch.kernels import ops
    key = jr.PRNGKey(seed)
    quads = sampler.init_state(key, 2 * mr * bs, 2 * mc * bs, dtype,
                               device=device)
    bits = jr.bits(jr.fold_in(key, 1), (2, mr, mc, bs, bs), device)
    return ops._block_quads(quads, bs), bits


def exact_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build() -> float:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build()
    seconds = time.perf_counter() - t0
    for name, text in logs.items():
        # registers of the main path's instantiations (bs 128, bf16) and
        # the largest spill of any kernel in the library
        fn, regs, spills = None, {}, 0
        for line in text.splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                regs[fn] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spills = max(spills, int(m.group(1)))
        main = {f: r for f, r in regs.items()
                if "Li128E" in f and "13__nv_bfloat16" in f}
        log(f"  nvcc {text.splitlines()[0]}; {len(regs)} kernels, largest "
            f"spill {spills} bytes; bs 128 bf16 registers {main}")
    log(f"build: {len(logs)} libraries in {seconds:.2f} s")
    return seconds


def phase_kernels_vs_plain(errs: dict) -> None:
    """Every form against its plain version on the card, bitwise; the keyed
    forms also against color_bits fed to the operand kernels; the device
    hash against the port's threefry."""
    import torch
    from repro_torch import random as jr
    from repro_torch.kernels import checkerboard as kern
    grids = [(1, 1), (2, 3), (1, 4), (3, 1)]
    fns = kernel_fns()
    operand = {"update_color_tiles_keyed": kern.update_color_tiles,
               "update_color_lines_keyed": kern.update_color_lines}
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for bs in (12, 16, 24, 32, 64, 128):
            for grid in grids:
                qb, bits = blocked_state(n, *grid, bs, dtype, "cuda")
                key = jr.fold_in(jr.PRNGKey(n), 2)
                kbits = jr.bits(key, (2,) + tuple(qb.shape[1:]), "cuda")
                for color in (0, 1):
                    for rule in ("metropolis_lut", "heat_bath"):
                        for beta in (0.1, BETA, 1.5):
                            for name, (fn, plain, keyed) in fns.items():
                                arg = key if keyed else bits
                                got = fn(qb.clone(), arg, beta, color, rule)
                                want = plain(qb.clone(), arg, beta, color,
                                             rule)
                                torch.cuda.synchronize()
                                err = exact_diff(got, want)
                                if keyed:
                                    err = max(err, exact_diff(got, operand[
                                        name](qb.clone(), kbits, beta,
                                              color, rule)))
                                errs[name] = max(errs[name], err)
                                if err:
                                    raise AssertionError(
                                        f"{name} != plain: {dtype} bs={bs} "
                                        f"grid={grid} color={color} "
                                        f"{rule} beta={beta} err={err}")
                n += 1
    log(f"kernels vs plain on the card: {n} shapes x 2 colours x 2 rules x "
        "3 betas x 4 forms, bitwise equal; keyed == operand on color_bits")
    # operands that are not 16-byte aligned take the generic instantiation
    qb, bits = blocked_state(98, 2, 3, 16, torch.bfloat16, "cuda")
    key = jr.PRNGKey(98)
    for name, (fn, plain, keyed) in fns.items():
        buf = torch.empty(qb.numel() + 1, dtype=qb.dtype, device="cuda")
        odd = buf[1:].view(qb.shape)
        odd.copy_(qb)
        arg = key if keyed else bits
        if exact_diff(fn(odd, arg, BETA, 1), plain(qb.clone(), arg, BETA, 1)):
            raise AssertionError(f"{name}: unaligned operands != plain")
    log("unaligned operands (generic instantiation) == plain, every form")
    # the kernels' device hash against the port's threefry
    key = jr.fold_in(jr.PRNGKey(4), 11)
    for start in (0, 2 ** 32 - 5):
        got = kern.threefry_bits(key, start, 1 << 20, "cuda")
        want = jr._as_int32(jr._bits_lanes(key, start, start + (1 << 20),
                                           "cuda"))
        if not torch.equal(got, want):
            raise AssertionError(f"ising_threefry_bits != _bits_lanes at "
                                 f"start {start}")
    log("ising_threefry_bits == random._bits_lanes, 2**20 counters from 0 "
        "and from 2**32 - 5")
    # the card's plain version against the CPU's, one small shape
    qb, bits = blocked_state(99, 2, 3, 16, torch.bfloat16, "cuda")
    for name, (_, plain, keyed) in fns.items():
        arg = key if keyed else bits
        for color in (0, 1):
            dev = plain(qb.clone(), arg, BETA, color)
            cpu = plain(qb.cpu().clone(), key if keyed else bits.cpu(), BETA,
                        color)
            if exact_diff(dev.cpu(), cpu):
                raise AssertionError(f"{name} plain: card != CPU")
    log("plain versions: card == CPU at [4, 2, 3, 16, 16]")
    # the measurement kernel: exact int64 sums, equal to its plain version
    from repro_torch.kernels import measure as kmeasure
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for bs in (12, 16, 24, 32, 64, 128):
            for grid in grids:
                qb, _ = blocked_state(200 + n, *grid, bs, dtype, "cuda")
                got = kmeasure.blocked_totals(qb)
                want = kmeasure.blocked_totals_plain(qb.cpu())
                err = float((got.cpu() - want).abs().max())
                errs["blocked_totals"] = max(errs["blocked_totals"], err)
                if err:
                    raise AssertionError(f"blocked_totals != plain: {dtype} "
                                         f"bs={bs} grid={grid}: {got} "
                                         f"{want}")
                n += 1
    buf = torch.empty(qb.numel() + 1, dtype=qb.dtype, device="cuda")
    odd = buf[1:].view(qb.shape)
    odd.copy_(qb)
    if not torch.equal(kmeasure.blocked_totals(odd).cpu(), want):
        raise AssertionError("blocked_totals: unaligned quads != plain")
    log(f"measurement kernel vs plain on the card: {n} shapes and unaligned "
        "quads, equal")


def reset_launches() -> None:
    """Zero every kernel's launch count and the count of
    ``fold_in_bits``' eager passes."""
    from repro_torch import random as jr
    from repro_torch.kernels import build
    build.reset_launches()
    jr.reset_counters()


def _fold_in_equals_eager(label: str, key, c, errs: dict) -> None:
    """``random.fold_in_bits`` of ``c`` on the card: one kernel launch, no
    eager pass, bitwise the eager int64 form."""
    import torch
    from repro_torch import random as jr
    from repro_torch.kernels import build
    reset_launches()
    got = jr.fold_in_bits(key, c)
    counts = (build.launches["fold_in_bits"],
              jr.counters["fold_in_bits_eager"])
    want = jr._fold_in_bits_eager(key, c)
    bad = int((got != want).sum())
    errs["fold_in_bits"] = max(errs["fold_in_bits"], bad)
    if counts != (1, 0) or bad or got.shape != c.shape:
        raise AssertionError(f"fold-in {label}: (launches, eager passes) "
                             f"{counts}, {bad} words differ")
    del got, want
    torch.cuda.synchronize()


def phase_fold_in(errs: dict, launches: dict) -> None:
    """The fold-in kernel bitwise against the eager form at the
    Swendsen-Wang cells' shapes, and its launches in one 5120^2 sweep of
    the cells' main path."""
    import torch
    from repro_torch import random as jr
    from repro_torch.api import EngineConfig, IsingEngine
    from repro_torch.cluster import bonds as B
    from repro_torch.cluster import label as LBL
    from repro_torch.core import lattice as L
    from repro_torch.kernels import build
    n = SW_SIZE
    key = jr.fold_in(jr.PRNGKey(51), 7)
    gi = B.global_index(n, n, device="cuda")
    for d in (0, 1):
        _fold_in_equals_eager(f"{n}^2 bonds d={d}", jr.fold_in(key, 0),
                              gi * 2 + d, errs)
    full = L.random_lattice(jr.PRNGKey(52), n, n, device="cuda")
    br, bd = B.fk_bonds(full, jr.fold_in(key, 0),
                        B.bond_threshold_u24(BETA))
    lab = LBL.label_components(br, bd)
    if lab.dtype != torch.int32:
        raise AssertionError(f"labels are {lab.dtype}, not int32")
    _fold_in_equals_eager(f"{n}^2 labels", jr.fold_in(key, 1), lab, errs)
    del gi, full, br, bd, lab
    keys = [jr.fold_in(key, i) for i in range(16)]
    rows = jr.shared(keys, B.global_index(4096, 4096, device="cuda"))
    if rows.stride(0) != 0:
        raise AssertionError("jr.shared rows are not stride 0")
    _fold_in_equals_eager("16 x 4096^2 shared rows", keys, rows, errs)
    del rows
    log(f"fold-in kernel == eager form on the card: {n}^2 bond counters "
        f"(d = 0, 1), {n}^2 int32 labels, 16 x 4096^2 shared rows; one "
        "launch each")
    eng = IsingEngine(EngineConfig(
        size=n, beta=BETA, n_sweeps=1, algorithm="swendsen_wang",
        dtype="bfloat16", measure=True, hot=True), device="cuda")
    eng.simulate(0)                         # warm-up
    torch.cuda.synchronize()
    reset_launches()
    eng.simulate(1)
    torch.cuda.synchronize()
    counts = (build.launches["fold_in_bits"],
              jr.counters["fold_in_bits_eager"])
    if counts != (3, 0) or build.launches["flip_lut"]:
        raise AssertionError(f"one {n}^2 SW sweep: (fold-in launches, eager "
                             f"passes) {counts}, want (3, 0); flip "
                             f"launches {build.launches['flip_lut']}, want 0")
    launches["fold_in_bits"] = counts[0]
    log(f"one {n}^2 Swendsen-Wang sweep (IsingEngine, measured): "
        f"{counts[0]} fold-in launches, {counts[1]} eager passes")


def _draw_equals_eager(label: str, draw, eager, words: int,
                       errs: dict) -> None:
    """``draw()`` (one of ``random``'s draws on the card): one draw kernel
    launch, ``words`` words counted, bitwise ``eager()``."""
    import torch
    from repro_torch import random as jr
    from repro_torch.kernels import build
    reset_launches()
    got = draw()
    counts = (build.launches["threefry_draw"], jr.counters["draw_words"])
    want = eager()
    ints = {2: torch.int16, 4: torch.int32}[got.element_size()]
    bad = int((got.view(ints) != want.view(ints)).sum())
    errs["threefry_draw"] = max(errs["threefry_draw"], bad)
    if counts != (1, words) or bad or got.shape != want.shape \
            or got.dtype != want.dtype:
        raise AssertionError(f"draw {label}: (launches, words) {counts}, "
                             f"want (1, {words}); {bad} elements differ")
    del got, want
    torch.cuda.synchronize()


def phase_draw(errs: dict, launches: dict) -> None:
    """The draw kernel bitwise against the eager form at the launcher's
    colour draw, and its launches in one 20480^2 sweep of the launcher's
    default engine."""
    import torch
    from repro_torch import random as jr
    from repro_torch.api import IsingEngine
    from repro_torch.kernels import build
    from repro_torch.launch import simulate
    key = jr.fold_in(jr.PRNGKey(61), 2)
    keys = [jr.fold_in(key, i) for i in range(16)]
    n = math.prod(DRAW_SHAPE)
    _draw_equals_eager(
        f"bf16 {list(DRAW_SHAPE)}",
        lambda: jr.uniform(key, DRAW_SHAPE, torch.bfloat16, "cuda"),
        lambda: jr._draw_eager(key, DRAW_SHAPE, torch.bfloat16, "cuda"),
        n, errs)
    _draw_equals_eager(
        f"f32 16 x {list(DRAW_SHAPE)}",
        lambda: jr.uniform(keys, DRAW_SHAPE, torch.float32, "cuda"),
        lambda: jr._draw_eager(keys, DRAW_SHAPE, torch.float32, "cuda"),
        16 * n, errs)
    _draw_equals_eager(
        f"randint [-3, 4) {list(DRAW_SHAPE)}",
        lambda: jr.randint(key, DRAW_SHAPE, -3, 4, "cuda"),
        lambda: jr._draw_eager(key, DRAW_SHAPE, torch.int32, "cuda",
                               (-3, 4)), 2 * n, errs)
    log(f"draw kernel == eager form on the card: {list(DRAW_SHAPE)} bf16 "
        "uniforms, 16-key f32 uniforms, randint [-3, 4); one launch each")
    cfg = simulate.build(simulate.parse_args([
        "--mesh", "1,1", "--blocks-per-device", str(DRAW_SHAPE[1]),
        "--block-size", str(BS), "--chunk", "1"]))[0]
    eng = IsingEngine(cfg, device="cuda")
    state = (jr.bernoulli(key, 0.5, (4,) + DRAW_SHAPE[1:], "cuda")
             .to(torch.bfloat16) * 2 - 1)
    eng.run_sweeps(state, jr.fold_in(key, 1), 1)         # warm-up
    torch.cuda.synchronize()
    reset_launches()
    eng.run_sweeps(state, jr.fold_in(key, 2), 1)
    torch.cuda.synchronize()
    counts = (build.launches["threefry_draw"], jr.counters["draw_words"])
    if counts != (2, SIZE * SIZE):
        raise AssertionError(f"one {SIZE}^2 launcher sweep: (draw launches, "
                             f"words) {counts}, want (2, {SIZE * SIZE})")
    launches["threefry_draw"] = counts[0]
    log(f"one {SIZE}^2 sweep of the launcher's engine: {counts[0]} draw "
        f"launches, {counts[1]} words")


def flip_inputs(seed: int, spin, prob) -> tuple:
    """+-1 spins, neighbour sums in {-4, -2, 0, 2, 4} and uniforms over
    ``FLIP_SHAPE`` on the card."""
    import torch
    from repro_torch import random as jr
    key = jr.fold_in(jr.PRNGKey(seed), 0)
    sigma = jr.bernoulli(key, 0.5, FLIP_SHAPE, "cuda").to(spin) * 2 - 1
    nn = (jr.randint(jr.fold_in(key, 1), FLIP_SHAPE, 0, 5, "cuda") * 2
          - 4).to(spin)
    probs = jr.uniform(jr.fold_in(key, 2), FLIP_SHAPE, prob, "cuda")
    torch.cuda.synchronize()
    return sigma, nn, probs


def _flip_equals_eager(label: str, sigma, nn, probs, errs: dict,
                       out=None) -> None:
    """``core.checkerboard._flip`` of the LUT rule at T_c on the card: one
    flip launch, bitwise the eager chain."""
    import torch
    from repro_torch.core import checkerboard as cb
    from repro_torch.core import update_rules as rules
    from repro_torch.kernels import build
    want = rules.get_rule("lut").flip_probs(sigma, nn, probs, BETA)
    reset_launches()
    got = cb._flip(sigma, nn, probs, BETA, "lut", out=out)
    count = build.launches["flip_lut"]
    ints = {2: torch.int16, 4: torch.int32}[got.element_size()]
    bad = int((got.view(ints) != want.view(ints)).sum())
    errs["flip_lut"] = max(errs["flip_lut"], bad)
    if count != 1 or bad or (out is not None and got is not out):
        raise AssertionError(f"flip {label}: {count} launches, want 1; "
                             f"{bad} sites differ")
    del got, want
    torch.cuda.synchronize()


def phase_flip(errs: dict, launches: dict) -> None:
    """The flip kernel bitwise against the eager LUT chain at a quad of the
    launcher's colour update, and its launches in one 20480^2 sweep of the
    launcher's default engine."""
    import torch
    from repro_torch import random as jr
    from repro_torch.api import IsingEngine
    from repro_torch.kernels import build
    from repro_torch.launch import simulate
    bf16, f32 = torch.bfloat16, torch.float32
    shape = list(FLIP_SHAPE)
    sigma, nn, probs = flip_inputs(71, bf16, bf16)
    _flip_equals_eager(f"bf16 {shape}", sigma, nn, probs, errs)
    _flip_equals_eager(f"bf16 {shape} in place", sigma, nn, probs, errs,
                       out=sigma)
    del sigma, nn, probs
    for spin, prob in ((bf16, f32), (f32, bf16)):
        sigma, nn, probs = flip_inputs(72, spin, prob)
        _flip_equals_eager(f"{spin} spins, {prob} uniforms {shape}", sigma,
                           nn, probs, errs)
        del sigma, nn, probs
    log(f"flip kernel == eager LUT chain on the card: {shape} at T_c, bf16 "
        "spins and uniforms (new tensor and in place), bf16 / f32, f32 / "
        "bf16; one launch each")
    cfg = simulate.build(simulate.parse_args([
        "--mesh", "1,1", "--blocks-per-device", str(FLIP_SHAPE[0]),
        "--block-size", str(BS), "--chunk", "1"]))[0]
    eng = IsingEngine(cfg, device="cuda")
    key = jr.fold_in(jr.PRNGKey(73), 0)
    state = (jr.bernoulli(key, 0.5, (4,) + FLIP_SHAPE, "cuda")
             .to(bf16) * 2 - 1)
    eng.run_sweeps(state, jr.fold_in(key, 1), 1)         # warm-up
    torch.cuda.synchronize()
    reset_launches()
    eng.run_sweeps(state, jr.fold_in(key, 2), 1)
    torch.cuda.synchronize()
    if build.launches["flip_lut"] != 4:
        raise AssertionError(f"one {SIZE}^2 launcher sweep: "
                             f"{build.launches['flip_lut']} flip launches, "
                             "want 4")
    launches["flip_lut"] = build.launches["flip_lut"]
    log(f"one {SIZE}^2 sweep of the launcher's engine: "
        f"{launches['flip_lut']} flip launches")


def sw_bonds(beta: float, n: int = SW_SIZE, sweeps: int = 3) -> tuple:
    """FK bond masks of an n^2 lattice at ``beta`` that ``sweeps``
    Swendsen-Wang sweeps brought from a hot start toward equilibrium."""
    from repro_torch import random as jr
    from repro_torch.cluster import bonds as B
    from repro_torch.cluster import sweep as CS
    from repro_torch.core import lattice as L
    t = B.bond_threshold_u24(beta)
    full = L.random_lattice(jr.PRNGKey(54), n, n, device="cuda")
    key = jr.PRNGKey(55)
    for _ in range(sweeps):
        full = CS.cluster_sweep(full, key, t)
        key = jr.fold_in(key, 1)
    return B.fk_bonds(full, jr.fold_in(key, 0), t)


def _label_equals_plain(label: str, br, bd, errs: dict) -> int:
    """The label kernel's labels for masks ``br``, ``bd`` on the card (one
    launch, no iteration) equal the plain propagation's on the same masks;
    returns the propagation's iterations."""
    from repro_torch.cluster import label as LBL
    from repro_torch.kernels import build
    build.reset_launches()
    LBL.reset_counters()
    got, iters = LBL.label_components(br, bd, with_iters=True)
    counts = (build.launches["label_components"], LBL.counters["iterations"],
              iters)
    want, plain_iters = LBL.propagate(br, bd)
    bad = int((got != want).sum())
    errs["label_components"] = max(errs["label_components"], bad)
    if counts != (1, 0, 0) or bad:
        raise AssertionError(f"labels {label}: (launches, iterations, "
                             f"iters) {counts}, want (1, 0, 0); {bad} sites "
                             "differ from the propagation")
    return plain_iters


def phase_label(errs: dict, launches: dict) -> None:
    """The label kernel bitwise against the plain propagation at the
    Swendsen-Wang cells' shape and betas, on a stack and a ragged shape,
    and its launches in one 5120^2 sweep of the cells' main path."""
    import torch
    from repro_torch.api import EngineConfig, IsingEngine
    from repro_torch.cluster import label as LBL
    from repro_torch.kernels import build
    for cell, beta in SW_BETAS.items():
        br, bd = sw_bonds(beta)
        iters = _label_equals_plain(f"{SW_SIZE}^2 {cell}", br, bd, errs)
        log(f"label kernel == propagation on the card: {SW_SIZE}^2 FK bonds "
            f"at beta {beta} ({cell}; the propagation took {iters} "
            "iterations)")
        del br, bd
    g = torch.Generator(device="cuda").manual_seed(56)
    for shape, p in (((4, 1000, 1000), 0.5), ((37, 53), 0.6)):
        br = torch.rand(shape, generator=g, device="cuda") < p
        bd = torch.rand(shape, generator=g, device="cuda") < p
        _label_equals_plain(f"{shape} p={p}", br, bd, errs)
    eng = IsingEngine(EngineConfig(
        size=SW_SIZE, beta=SW_BETAS["sw-near-critical"], n_sweeps=1,
        algorithm="swendsen_wang", dtype="bfloat16", measure=True, hot=True),
        device="cuda")
    eng.simulate(0)                         # warm-up
    torch.cuda.synchronize()
    reset_launches()
    LBL.reset_counters()
    eng.simulate(1)
    torch.cuda.synchronize()
    counts = (build.launches["label_components"], LBL.counters["iterations"])
    if counts != (1, 0):
        raise AssertionError(f"one {SW_SIZE}^2 SW sweep: (label launches, "
                             f"label iterations) {counts}, want (1, 0)")
    launches["label_components"] = counts[0]
    log(f"label kernel == propagation on [4, 1000, 1000] and 37 x 53; one "
        f"{SW_SIZE}^2 Swendsen-Wang sweep (IsingEngine, measured): "
        f"{counts[0]} label launch, {counts[1]} label iterations")


def _read_launches(label: str, want: dict) -> dict:
    """The half-sweep forms' and the measurement kernel's launch counts
    since the last reset; ``want`` gives those that must have launched,
    every other must read 0."""
    from repro_torch.kernels import build
    counts = {name: build.launches[name] for name in SWEEP_LAUNCHES}
    if counts != {name: want.get(name, 0) for name in counts}:
        raise AssertionError(f"{label}: launches {counts}, want {want}")
    return counts


def phase_main_path(launches: dict) -> dict:
    """The port's main path at full size, through the public entry point;
    then the explicit-bits path (the operand forms) against the keyed
    sweeps at the same size."""
    import torch
    from repro_torch import random as jr
    from repro_torch.api import EngineConfig, IsingEngine
    from repro_torch.core import sampler
    from repro_torch.kernels import build
    from repro_torch.kernels import ops
    finals, out = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for backend, (keyed, _) in BACKENDS.items():
        cfg = EngineConfig(size=SIZE, beta=BETA, n_sweeps=MAIN_SWEEPS,
                           backend=backend, hot=True, block_size=BS)
        eng = IsingEngine(cfg)
        reset_launches()
        t0 = time.perf_counter()
        res = eng.simulate(0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _read_launches(f"main path {backend}",
                                {keyed: 2 * MAIN_SWEEPS,
                                 "blocked_totals": MAIN_SWEEPS})
        if build.launches["flip_lut"]:
            raise AssertionError(f"main path {backend}: "
                                 f"{build.launches['flip_lut']} flip "
                                 "launches, want 0")
        launches[keyed] = counts[keyed]
        launches["blocked_totals"] = MAIN_SWEEPS
        m, e = res.magnetization, res.energy
        if not (torch.isfinite(m).all() and torch.isfinite(e).all()
                and float(m.abs().max()) <= 1.0
                and -2.0 <= float(e.min()) and float(e.max()) <= 2.0):
            raise AssertionError(f"{backend}: bad series {m} {e}")
        if res.state.shape != (4, SIZE // 2, SIZE // 2):
            raise AssertionError(f"bad state shape {tuple(res.state.shape)}")
        finals[backend] = res.state
        out[backend] = dict(seconds=seconds, m=m.tolist(), e=e.tolist(),
                            moments=res.moments)
        log(f"main path {backend}: {SIZE}^2, {MAIN_SWEEPS} sweeps "
            f"in {seconds:.3f} s, launches {counts}, m[-1]={float(m[-1])}, "
            f"E[-1]={float(e[-1])}")
    a, b = finals.values()
    if exact_diff(a, b):
        raise AssertionError("pallas and pallas_lines final states differ")
    log("main path: pallas == pallas_lines final state, bitwise")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"main path peak device memory: {out['peak_bytes'] / 2**30:.2f} GiB")
    del finals, a, b
    # The explicit-bits path: ops.update_color fed ops.color_bits launches
    # the operand forms; it must end where the keyed sweeps end.
    key = jr.PRNGKey(9)
    quads = sampler.init_state(jr.PRNGKey(8), SIZE, SIZE, device="cuda")
    for backend, (keyed, operand) in BACKENDS.items():
        want = ops.run_sweeps(quads, key, n_sweeps=MAIN_SWEEPS, beta=BETA,
                              bs=BS, backend=backend)
        qb = ops._block_quads(quads, BS)
        reset_launches()
        for step in range(MAIN_SWEEPS):
            for color in (0, 1):
                bits = ops.color_bits(key, step, color, qb.shape[1:], "cuda")
                qb = ops.update_color(qb, bits, BETA, color, backend)
        torch.cuda.synchronize()
        counts = _read_launches(f"explicit bits {backend}",
                                {operand: 2 * MAIN_SWEEPS})
        launches[operand] = counts[operand]
        if exact_diff(ops._unblock_quads(qb), want):
            raise AssertionError(f"{backend}: the operand form on color_bits "
                                 "!= the keyed sweeps at full size")
        log(f"explicit-bits path {backend}: {SIZE}^2, {MAIN_SWEEPS} sweeps, "
            f"launches {counts}; == the keyed sweeps, bitwise")
        del want, qb, bits
    del quads
    return out


def phase_small_and_chain() -> dict:
    """Kernel path at 256^2 on the card == CPU plain path; chain scenario."""
    import torch
    from repro_torch.api import EngineConfig, IsingEngine
    for backend in ("pallas", "pallas_lines"):
        for rule in ("metropolis", "heat_bath"):
            cfg = EngineConfig(size=256, beta=BETA, n_sweeps=4,
                               backend=backend, rule=rule, hot=True)
            dev = IsingEngine(cfg).simulate(1)
            cpu = IsingEngine(cfg, device="cpu").simulate(1)
            if (exact_diff(dev.state.cpu(), cpu.state)
                    or not torch.equal(dev.magnetization, cpu.magnetization)
                    or not torch.equal(dev.energy, cpu.energy)
                    or dev.moments != cpu.moments):
                raise AssertionError(f"256^2 {backend} {rule}: card != CPU")
    log("kernel path 256^2: card == CPU plain path (state, m, E, moments)")
    small = EngineConfig(size=64, beta=BETA, n_sweeps=4, hot=True)
    dev = IsingEngine(small).simulate(2)
    cpu = IsingEngine(small, device="cpu").simulate(2)
    if exact_diff(dev.state.cpu(), cpu.state) or not torch.equal(
            dev.energy, cpu.energy):
        raise AssertionError("chain 64^2: card != CPU")
    cfg = EngineConfig(size=CHAIN_SIZE, beta=BETA, n_sweeps=4, hot=True)
    eng = IsingEngine(cfg)
    eng.simulate(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.simulate(3)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    m, e = res.magnetization, res.energy
    if not (torch.isfinite(m).all() and torch.isfinite(e).all()
            and float(m.abs().max()) <= 1.0 and float(e.abs().max()) <= 2.0):
        raise AssertionError("chain: bad series")
    log(f"chain scenario {CHAIN_SIZE}^2: 4 measured sweeps in {seconds:.4f} s"
        f" ({4 * CHAIN_SIZE ** 2 / seconds / 1e9:.4f} flips/ns), "
        f"m[-1]={float(m[-1])}, E[-1]={float(e[-1])}; 64^2 card == CPU")
    return dict(chain_s=seconds)


def small_scenarios(beta_gap: float) -> list:
    """(label, EngineConfig) of every non-kernel scenario at a small size;
    ``beta_gap`` is where torch's exp and the f32 tables part."""
    from repro_torch.api import EngineConfig as cfg
    from repro_torch.api import beta_ladder
    from repro_torch.potts.state import beta_c
    b3 = beta_c(3)
    potts = dict(size=64, beta=b3, model="potts", q=3, n_sweeps=3)
    cluster = dict(size=64, n_sweeps=3)
    chain = dict(size=64, beta=beta_gap, dtype="float32", n_sweeps=4,
                 hot=True)
    return [
        ("ensemble", cfg(size=64, betas=(0.35, BETA, 0.55), n_sweeps=3)),
        ("ensemble f32 heat_bath", cfg(size=64, betas=(0.35, BETA),
                                       n_sweeps=3, dtype="float32",
                                       rule="heat_bath")),
        ("tempering", cfg(size=64, betas=beta_ladder(1.05, 1.1, 4),
                          ensemble="tempering", exchange_every=2,
                          n_sweeps=8)),
        ("3d 16^3", cfg(size=16, beta=0.2216546, dims=3, block_size=0,
                        n_sweeps=3, hot=True)),
        ("cluster sw", cfg(beta=BETA, algorithm="swendsen_wang", **cluster)),
        ("cluster wolff", cfg(beta=BETA, algorithm="wolff", **cluster)),
        ("cluster sw 2 betas", cfg(betas=(0.4, 0.48),
                                   algorithm="swendsen_wang", **cluster)),
        ("cluster wolff 2 betas", cfg(betas=(0.4, 0.48), algorithm="wolff",
                                      **cluster)),
        ("potts_cb heat_bath q=3", cfg(rule="heat_bath", **potts)),
        ("potts_cb metropolis q=3", cfg(rule="metropolis", **potts)),
        ("potts_cluster sw q=3", cfg(algorithm="swendsen_wang", **potts)),
        ("potts_cluster wolff q=3", cfg(algorithm="wolff", **potts)),
        (f"chain f32 beta={beta_gap}", cfg(**chain)),
        (f"chain f32 heat_bath beta={beta_gap}", cfg(rule="heat_bath",
                                                     **chain)),
    ]


def full_scenarios() -> list:
    """(label, EngineConfig) of every non-kernel scenario at a user size."""
    from repro_torch.api import EngineConfig as cfg
    from repro_torch.api import beta_ladder
    from repro_torch.potts.state import beta_c
    b3 = beta_c(3)
    return [
        ("ensemble 16 x 4096^2", cfg(
            size=4096, betas=beta_ladder(0.9, 1.1, 16), n_sweeps=2)),
        ("tempering 8 x 2048^2", cfg(
            size=2048, betas=beta_ladder(0.9, 1.1, 8), ensemble="tempering",
            exchange_every=2, n_sweeps=4)),
        ("3d 512^3", cfg(size=512, beta=0.2216546, dims=3, block_size=0,
                         n_sweeps=2)),
        ("cluster sw 2048^2", cfg(size=2048, beta=BETA, n_sweeps=3,
                                  algorithm="swendsen_wang")),
        ("cluster wolff 2048^2", cfg(size=2048, beta=BETA, n_sweeps=3,
                                     algorithm="wolff")),
        ("potts_cb heat_bath q=3 4096^2", cfg(
            size=4096, beta=b3, model="potts", q=3, rule="heat_bath",
            n_sweeps=2)),
        ("potts_cluster sw q=3 2048^2", cfg(
            size=2048, beta=b3, model="potts", q=3,
            algorithm="swendsen_wang", n_sweeps=2)),
    ]


def gap_beta() -> tuple:
    """(beta, card differs): the first beta in [0.40, 0.50] whose f32
    acceptance table from torch's own CPU exp differs from the port's
    (XLA's) table, and whether the card's torch.exp differs there too."""
    import numpy as np
    import torch
    from repro_torch.core import update_rules as R
    x = torch.tensor(R._X_VALUES, dtype=torch.float32)
    for beta in np.linspace(0.40, 0.50, 101):
        beta = float(beta)
        arg = -2.0 * torch.tensor(beta, dtype=torch.float32) * x
        table = R.acceptance_table(beta)
        if (torch.exp(arg) != table).any():
            card = (torch.exp(arg.to("cuda")).cpu() != table).any()
            return beta, bool(card)
    raise AssertionError("no beta in [0.40, 0.50] separates torch.exp "
                         "from the port's tables")


def _same_result(a, b) -> bool:
    import numpy as np
    import torch

    def eq(x, y):
        if x is None or y is None:
            return x is None and y is None
        return torch.equal(x.cpu(), y.cpu())
    if not (eq(a.state, b.state) and eq(a.magnetization, b.magnetization)
            and eq(a.energy, b.energy) and a.extra == b.extra):
        return False
    if a.moments is None or b.moments is None:
        return a.moments is None and b.moments is None
    return a.moments.keys() == b.moments.keys() and all(
        np.array_equal(a.moments[k], b.moments[k]) for k in a.moments)


def _no_launches(label: str) -> None:
    _read_launches(f"{label} (a path that launches none)", {})


def phase_scenarios_small() -> float:
    """Every non-kernel scenario: card == CPU, bitwise, at a small size."""
    import torch
    from repro_torch.api import IsingEngine
    beta, card = gap_beta()
    log(f"f32 table gap: torch.exp on the CPU differs from the XLA f32 "
        f"table at beta={beta} (the card's torch.exp differs there: {card});"
        " the port's chains use the latter")
    for i, (label, cfg) in enumerate(small_scenarios(beta)):
        reset_launches()
        dev = IsingEngine(cfg, device="cuda").simulate(10 + i)
        torch.cuda.synchronize()
        _no_launches(label)
        cpu = IsingEngine(cfg, device="cpu").simulate(10 + i)
        if dev.state.device.type != "cuda" or not _same_result(dev, cpu):
            raise AssertionError(f"{label}: card != CPU")
        if cfg.ensemble == "tempering" and not dev.extra["swap_fraction"]:
            raise AssertionError(f"{label}: no swap accepted, so the card "
                                 "never permuted replicas")
        log(f"small {label}: card == CPU (state, series, moments, extra "
            f"{dev.extra or '{}'})")
    return beta


def _check_series(label, res, cfg) -> None:
    import torch
    m, e = res.magnetization, res.energy
    rows = cfg.n_replicas() or 1
    t = (cfg.n_sweeps // cfg.exchange_every if cfg.ensemble == "tempering"
         else cfg.n_sweeps)
    if tuple(m.shape) != ((rows, t) if cfg.betas else (t,)):
        raise AssertionError(f"{label}: series shape {tuple(m.shape)}")
    if not (torch.isfinite(m).all() and float(m.abs().max()) <= 1.0):
        raise AssertionError(f"{label}: bad m series {m}")
    if e is not None and not (torch.isfinite(e).all()
                              and float(e.abs().max()) <= 3.0):
        raise AssertionError(f"{label}: bad E series {e}")


def phase_scenarios_full() -> dict:
    """Each non-kernel scenario at a size its users run, timed."""
    import torch
    from repro_torch import random as jr
    from repro_torch.api import IsingEngine
    from repro_torch.kernels import build
    out = {}
    for label, cfg in full_scenarios():
        eng = IsingEngine(cfg, device="cuda")
        state = eng.init(jr.PRNGKey(21))
        eng.run(state, jr.PRNGKey(20))      # warm the allocator
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = eng.run(state, jr.PRNGKey(22))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        _no_launches(label)
        _check_series(label, res, cfg)
        sweeps = cfg.n_sweeps
        spins = cfg.size ** cfg.dims * (cfg.n_replicas() or 1)
        line = (f"full {label}: {sweeps} sweeps in {seconds:.4f} s, "
                f"{seconds / sweeps * 1e3:.3f} ms per sweep, "
                f"{spins * sweeps / seconds / 1e9:.4f} sites/ns")
        if cfg.algorithm != "metropolis":
            line += (f", {build.launches['label_components'] / sweeps:.1f}"
                     " label kernel launches per sweep")
        if cfg.ensemble == "tempering":
            line += f", swap fraction {res.extra['swap_fraction']}"
        log(line)
        out[label] = seconds / sweeps
        del eng, state, res
    return out


def phase_replica_stack(n_rep: int = 64, size: int = 256,
                        sweeps: int = 4) -> None:
    """A temperature scan of many small replicas: the ensemble stepped in
    one pass over the replica axis against the same replicas run one at a
    time (each its own chain keyed fold_in(k, i) at its f32 beta, the way
    a per-replica loop runs them); both bitwise equal, both timed after a
    warm-up."""
    import torch
    from repro_torch import random as jr
    from repro_torch.api import EngineConfig, IsingEngine, beta_ladder
    from repro_torch.core import sampler
    cfg = EngineConfig(size=size, betas=beta_ladder(0.7, 1.3, n_rep),
                       n_sweeps=sweeps)
    eng = IsingEngine(cfg, device="cuda")
    state = eng.init(jr.PRNGKey(51))
    key = jr.PRNGKey(52)
    betas = torch.tensor(cfg.betas, dtype=torch.float32, device="cuda")

    def one_at_a_time():
        outs = [sampler.run_chain(state[i], jr.fold_in(key, i),
                                  sampler.ChainConfig(
                                      beta=betas[i], n_sweeps=sweeps,
                                      block_size=cfg.resolved_block_size()))
                for i in range(n_rep)]
        return [torch.stack([o[j] for o in outs]) for j in range(3)]

    def wall(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / sweeps * 1e3

    res, stack_ms = wall(lambda: eng.run(state, key))
    (f, m, e), loop_ms = wall(one_at_a_time)
    if not (torch.equal(res.state, f) and torch.equal(res.magnetization, m)
            and torch.equal(res.energy, e)):
        raise AssertionError("replica stack != replicas one at a time")
    log(f"replica stack {n_rep} x {size}^2: one pass {stack_ms:.3f} ms per "
        f"sweep, one replica at a time {loop_ms:.3f} ms per sweep "
        f"({loop_ms / stack_ms:.1f}x), bitwise equal")


def phase_rng_shares(per_sweep: dict) -> None:
    """The share of a sweep that is threefry bits, for the single-site
    scenarios: CUDA-event time of one sweep's draws at the same shapes
    against the sweep time of phase 6."""
    from repro_torch import random as jr
    from repro_torch.cluster import bonds as B
    from repro_torch.core import ising3d as I3
    from repro_torch.core import sampler
    key = jr.PRNGKey(41)
    gi3 = I3.global_index3d((512,) * 3, "cuda")
    gi2 = B.global_index(4096, 4096, device="cuda")
    draws = {
        "ensemble 16 x 4096^2": (1, lambda: sampler.sweep_probs(
            [jr.fold_in(key, i) for i in range(16)], 0, (2048, 2048),
            "float32", "cuda")),
        "tempering 8 x 2048^2": (1, lambda: sampler.sweep_probs(
            [jr.fold_in(key, i) for i in range(8)], 0, (1024, 1024),
            "float32", "cuda")),
        "3d 512^3": (2, lambda: I3.site_uniforms3d(key, gi3)),
        "potts_cb heat_bath q=3 4096^2": (2, lambda: B.counter_bits(
            key, gi2)),
    }
    for label, (count, fn) in draws.items():
        ms = count * time_ms(fn, reps=3, warmup=1)
        log(f"rng share {label}: {count} draws x {ms / count:.3f} ms = "
            f"{ms:.3f} ms of {per_sweep[label] * 1e3:.3f} ms per sweep "
            f"({ms / (per_sweep[label] * 1e3):.1%})")


def phase_cluster_breakdown(n: int = 2048) -> None:
    """Where one Swendsen-Wang sweep at 2048^2, beta_c goes: threefry bits
    (two bond words and one coin word per site) and the label kernel;
    beside them the plain propagation on the same bonds, its rounds and
    its changed-flag check (the propagation with a compare, reduce and
    host sync per iteration against the same rounds enqueued without
    them)."""
    import torch
    from repro_torch import random as jr
    from repro_torch.cluster import bonds as B
    from repro_torch.cluster import label as LBL
    from repro_torch.cluster import sweep as CS
    from repro_torch.core import lattice as L
    full = L.random_lattice(jr.PRNGKey(31), n, n, device="cuda")
    t24 = B.bond_threshold_u24(BETA)
    key = jr.PRNGKey(32)
    for _ in range(3):                      # equilibrate the clusters a bit
        full = CS.cluster_sweep(full, key, t24)
        key = jr.fold_in(key, 1)
    gi = B.global_index(n, n, device="cuda")
    kb, kc = jr.fold_in(key, 0), jr.fold_in(key, 1)
    br, bd = B.fk_bonds(full, kb, t24)
    lab = LBL.label_components(br, bd)
    iters = LBL.propagate(br, bd)[1]

    def bits():
        B.bond_bits(kb, gi, 0)
        B.bond_bits(kb, gi, 1)
        B.counter_bits(kc, lab)

    def rounds():
        new = LBL.init_labels(n, n, "cuda")
        for _ in range(2 * iters):
            new = LBL.pointer_jump(LBL.neighbor_min(new, br, bd), jumps=1)

    def wall(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    sweep_ms = wall(lambda: CS.cluster_sweep(full, key, t24))
    bits_ms = time_ms(bits, reps=5)
    label_ms = time_ms(lambda: LBL.label_components(br, bd), reps=20)
    plain_ms = wall(lambda: LBL.propagate(br, bd))
    rounds_ms = wall(rounds)
    check_ms = plain_ms - rounds_ms
    rest = sweep_ms - bits_ms - label_ms
    log(f"cluster sweep breakdown SW {n}^2 beta_c: {sweep_ms:.3f} ms per "
        f"sweep; threefry bits {bits_ms:.3f} ms ({bits_ms / sweep_ms:.1%}); "
        f"label kernel {label_ms:.3f} ms ({label_ms / sweep_ms:.1%}); rest "
        f"{rest:.3f} ms ({rest / sweep_ms:.1%}). The plain propagation on "
        f"the same bonds: {plain_ms:.3f} ms, of it rounds {rounds_ms:.3f} "
        f"ms ({iters} iterations x 2 rounds) and changed-flag check + sync "
        f"{check_ms:.3f} ms ({iters} checks)")


GRID_PATHS = [
    # (label, EngineConfig overrides): the decomposed lattice on one rank
    ("mesh xla paper", dict(topology="mesh", mesh_shape=(1, 1))),
    ("mesh xla opt", dict(topology="mesh", mesh_shape=(1, 1),
                          pipeline="opt")),
    ("mesh pallas_lines", dict(topology="mesh", mesh_shape=(1, 1),
                               backend="pallas_lines")),
    ("opt xla", dict(pipeline="opt")),
    ("opt pallas_lines", dict(pipeline="opt", backend="pallas_lines")),
]


def _check_launches(label: str, cfg, sweeps: int) -> dict:
    return _read_launches(label, {"update_color_lines_keyed": 2 * sweeps}
                          if cfg.backend == "pallas_lines" else {})


def grid_cluster_scenarios(size: int, full: bool) -> list:
    """(label, EngineConfig) of the cluster and Potts meshes and the
    replica-sharded ensemble on a one-rank grid: at ``size`` (bs 16) for
    the card == CPU checks, or at the sizes their single-device twins run
    (``full_scenarios``)."""
    from repro_torch.api import EngineConfig as cfg
    from repro_torch.api import beta_ladder
    from repro_torch.potts.state import beta_c
    b3 = beta_c(3)
    mesh = dict(topology="mesh", mesh_shape=(1, 1))
    if not full:
        mesh.update(block_size=16, hot=True)
    big, side = (4096, 2048) if full else (size, size)
    n_rep, sweeps = (16, 2) if full else (4, 3)
    return [
        (f"cluster_mesh sw {side}^2", cfg(
            size=side, beta=BETA, algorithm="swendsen_wang", n_sweeps=3,
            **mesh)),
        (f"cluster_mesh wolff {side}^2", cfg(
            size=side, beta=BETA, algorithm="wolff", n_sweeps=3, **mesh)),
        (f"potts_cb_mesh heat_bath q=3 {big}^2", cfg(
            size=big, beta=b3, model="potts", q=3, rule="heat_bath",
            n_sweeps=sweeps, **mesh)),
        (f"potts_cluster_mesh sw q=3 {side}^2", cfg(
            size=side, beta=b3, model="potts", q=3,
            algorithm="swendsen_wang", n_sweeps=sweeps, **mesh)),
        (f"ensemble on a mesh {n_rep} x {big}^2", cfg(
            size=big, betas=beta_ladder(0.9, 1.1, n_rep), n_sweeps=sweeps,
            **mesh)),
    ]


# each grid scenario's single-device twin in full_scenarios()
GRID_TWINS = {"cluster_mesh sw": "cluster sw 2048^2",
              "cluster_mesh wolff": "cluster wolff 2048^2",
              "potts_cb_mesh heat_bath q=3": "potts_cb heat_bath q=3 4096^2",
              "potts_cluster_mesh sw q=3": "potts_cluster sw q=3 2048^2",
              "ensemble on a mesh 16 x": "ensemble 16 x 4096^2"}


def phase_grid_small() -> None:
    """The decomposed lattice at a small size: card == CPU, bitwise."""
    import torch
    from repro_torch.api import EngineConfig, IsingEngine
    cases = []
    for label, kw in GRID_PATHS:
        cases.append((label + " measured", EngineConfig(
            size=256, beta=BETA, n_sweeps=3, block_size=16, hot=True, **kw)))
        cases.append((label + " heat_bath f32", EngineConfig(
            size=256, beta=BETA, n_sweeps=3, block_size=16, hot=True,
            rule="heat_bath", dtype="float32", measure=False, **kw)))
    for measure in (True, False):
        cases.append((f"mesh3d 16^3 measure={measure}", EngineConfig(
            size=16, beta=0.2216546, dims=3, n_sweeps=3, hot=True,
            topology="mesh", mesh_shape=(1, 1), measure=measure)))
    cases += grid_cluster_scenarios(256, full=False)
    for i, (label, cfg) in enumerate(cases):
        reset_launches()
        dev = IsingEngine(cfg, device="cuda").simulate(60 + i)
        torch.cuda.synchronize()
        _check_launches(label, cfg, cfg.n_sweeps)
        cpu = IsingEngine(cfg, device="cpu").simulate(60 + i)
        if dev.state.device.type != "cuda" or not _same_result(dev, cpu):
            raise AssertionError(f"{label}: card != CPU")
        log(f"small grid {label}: card == CPU (state, moments "
            f"{'m_abs=%r' % dev.moments['m_abs'] if dev.moments else None})")


def phase_lines_halo(errs: dict) -> None:
    """Both lines forms fed halo lines that are not the local torus roll
    (each line negated), bitwise against their plain versions on the same
    lines, at a small shape and the main path's."""
    import torch
    from repro_torch import random as jr
    from repro_torch.core import checkerboard as cb
    from repro_torch.kernels import checkerboard as kern

    def negated(xb, side):
        return -cb.default_edges(xb, side)

    mr = SIZE // 2 // BS
    key = jr.PRNGKey(17)
    forms = (("update_color_lines", kern.update_color_lines,
              kern.update_color_lines_plain, None),
             ("update_color_lines_keyed", kern.update_color_lines_keyed,
              kern.update_color_lines_keyed_plain, key))
    for grid, bs in (((2, 3), 16), ((mr, mr), BS)):
        qb, bits = blocked_state(17, *grid, bs, torch.bfloat16, "cuda")
        for color in (0, 1):
            for rule in ("metropolis_lut", "heat_bath"):
                lines = kern._lines(qb, color, negated)
                for name, fn, plain, k in forms:
                    arg = bits if k is None else k
                    got = fn(qb.clone(), arg, BETA, color, rule,
                             edges=negated)
                    want = plain(qb.clone(), arg, BETA, color, rule, lines)
                    torus = fn(qb.clone(), arg, BETA, color, rule)
                    torch.cuda.synchronize()
                    err = exact_diff(got, want)
                    errs[name] = max(errs[name], err)
                    if err or not exact_diff(got, torus):
                        raise AssertionError(
                            f"{name} with halo lines {grid} bs={bs} "
                            f"color={color} {rule}: err={err}, differs from "
                            f"the torus run: {bool(exact_diff(got, torus))}")
                    del got, want, torus
        del qb, bits
    log("both lines forms with non-torus halo lines (negated) == plain "
        "versions on the same lines, bitwise, at [4, 2, 3, 16, 16] and "
        f"[4, {mr}, {mr}, {BS}, {BS}]; the torus run differs")


def init_group():
    """A one-rank NCCL process group on card 0 (the grid scenarios'
    all-reduce goes through it)."""
    import socket
    import torch
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    log(f"process group: backend {dist.get_backend()}, world size "
        f"{dist.get_world_size()}")


def phase_grid_full() -> dict:
    """The decomposed lattice at the main path's size through the NCCL
    group, measured and not, timed on the host clock (synchronised)."""
    import torch
    from repro_torch import random as jr
    from repro_torch.api import EngineConfig, IsingEngine
    from repro_torch.launch import mesh as mesh_lib
    out = {}
    for label, kw in GRID_PATHS:
        for measure in (True, False):
            cfg = EngineConfig(size=SIZE, beta=BETA, n_sweeps=MAIN_SWEEPS,
                               block_size=BS, hot=True, measure=measure,
                               **kw)
            torch.cuda.reset_peak_memory_stats()
            eng = IsingEngine(cfg)
            if not eng.grid.distributed:
                raise AssertionError(f"{label}: the grid has no group")
            state = eng.init(jr.PRNGKey(70))
            # one untimed sweep of the same kind warms cuBLAS and the
            # allocator
            IsingEngine(dataclasses.replace(cfg, n_sweeps=1)).run(
                state, jr.PRNGKey(71))
            torch.cuda.synchronize()
            reset_launches()
            mesh_lib.reset_counters()
            t0 = time.perf_counter()
            res = eng.run(state, jr.PRNGKey(72))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            name = f"{label} measure={measure}"
            counts = _check_launches(name, cfg, MAIN_SWEEPS)
            reduces = mesh_lib.counters["all_reduce"]
            if measure and (reduces != 2 * MAIN_SWEEPS
                            or not all(map(math.isfinite,
                                           res.moments.values()))
                            or abs(res.moments["m_abs"]) > 1.0):
                raise AssertionError(f"{name}: all-reduces {reduces}, "
                                     f"moments {res.moments}")
            if res.state.shape != (4, SIZE // 2 // BS, SIZE // 2 // BS, BS,
                                   BS):
                raise AssertionError(f"{name}: state "
                                     f"{tuple(res.state.shape)}")
            peak = torch.cuda.max_memory_allocated()
            rate = MAIN_SWEEPS * SIZE ** 2 / seconds / 1e9
            out[name] = dict(seconds=seconds, flips_per_ns=rate, peak=peak)
            log(f"grid {name} {SIZE}^2: {MAIN_SWEEPS} sweeps in "
                f"{seconds:.4f} s, {seconds / MAIN_SWEEPS * 1e3:.3f} ms per "
                f"sweep, {rate:.4f} flips/ns, launches "
                f"{counts}, all-reduces {reduces}, peak "
                f"{peak / 2**30:.2f} GiB"
                + (f", E={res.moments['E']:.6f}" if measure else ""))
            del eng, state, res
    return out


def phase_grid_cluster_full(twins: dict) -> None:
    """The cluster and Potts meshes and the replica-sharded ensemble on
    the one-rank NCCL grid at their twins' sizes, measured, timed on the
    host clock after a one-sweep warm-up: ms per sweep (beside the
    single-device twin's), local label iterations, cross-rank merge
    iterations and all-reduces per sweep. One rank never enters the merge
    (nrows = ncols = 1); the merge itself is held on gloo ranks on the CPU
    only."""
    import torch
    from repro_torch import random as jr
    from repro_torch.api import IsingEngine
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_lib
    for label, cfg in grid_cluster_scenarios(0, full=True):
        eng = IsingEngine(cfg)
        if not eng.grid.distributed:
            raise AssertionError(f"{label}: the grid has no group")
        state = eng.init(jr.PRNGKey(90))
        IsingEngine(dataclasses.replace(cfg, n_sweeps=1)).run(
            state, jr.PRNGKey(91))
        torch.cuda.synchronize()
        reset_launches()
        mesh_lib.reset_counters()
        t0 = time.perf_counter()
        res = eng.run(state, jr.PRNGKey(92))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        _no_launches(label)
        n = cfg.n_sweeps
        mom = res.moments
        m_abs = (mom["m_abs"] if not cfg.betas
                 else float(max(abs(x) for x in mom["m_abs"])))
        if not (math.isfinite(m_abs) and m_abs <= 1.0):
            raise AssertionError(f"{label}: moments {mom}")
        if mesh_lib.counters["label_merge"]:
            raise AssertionError(f"{label}: one rank entered the merge")
        twin = next((twins[v] for k, v in GRID_TWINS.items()
                     if label.startswith(k)), None)
        spins = cfg.size * cfg.resolved_width() * (cfg.n_replicas() or 1)
        log(f"grid {label} (one rank, NCCL): {n} measured sweeps in "
            f"{seconds:.4f} s, {seconds / n * 1e3:.3f} ms per sweep "
            f"(single-device twin "
            f"{twin * 1e3 if twin else float('nan'):.3f} ms), "
            f"{spins * n / seconds / 1e9:.4f} sites/ns, label kernel "
            f"launches {build.launches['label_components'] / n:.1f}, "
            "cross-rank merge "
            f"iterations {mesh_lib.counters['label_merge'] / n:.1f} (one "
            "rank never merges), all-reduces "
            f"{mesh_lib.counters['all_reduce'] / n:.1f} per sweep")
        del eng, state, res


def phase_mesh3d_full(side: int = 512, sweeps: int = 2) -> None:
    import torch
    from repro_torch import random as jr
    from repro_torch.api import EngineConfig, IsingEngine
    cfg = EngineConfig(size=side, beta=0.2216546, dims=3, n_sweeps=sweeps,
                       topology="mesh", mesh_shape=(1, 1))
    eng = IsingEngine(cfg)
    state = eng.init(jr.PRNGKey(80))
    eng.run_sweeps(state, jr.PRNGKey(81), 1)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = eng.run(state, jr.PRNGKey(82))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _no_launches("mesh3d")
    if not abs(res.moments["m_abs"]) <= 1.0:
        raise AssertionError(f"mesh3d: moments {res.moments}")
    log(f"grid mesh3d {side}^3: {sweeps} measured sweeps in {seconds:.4f} s,"
        f" {seconds / sweeps * 1e3:.3f} ms per sweep, "
        f"{side ** 3 * sweeps / seconds / 1e9:.4f} sites/ns")


# the seven-request shape mix of the serving plane's bitwise tests
SERVE_MIX = [
    dict(L=16, beta=0.3, n_sweeps=14, n_samples=2, seed=11),
    dict(L=16, beta=0.6, n_sweeps=9, n_samples=3, seed=12, rule="heat_bath"),
    dict(L=16, beta=0.44, n_sweeps=7, n_samples=1, seed=13,
         algorithm="swendsen_wang", dtype="float32"),
    dict(L=16, beta=0.5, n_sweeps=11, n_samples=2, seed=14,
         algorithm="wolff", dtype="float32"),
    dict(L=16, beta=1.1, n_sweeps=13, n_samples=2, seed=15, model="potts",
         q=3, rule="heat_bath"),
    dict(L=16, beta=0.9, n_sweeps=8, n_samples=2, seed=16, model="potts",
         q=3, algorithm="swendsen_wang"),
    dict(L=8, beta=0.25, n_sweeps=10, n_samples=2, seed=17, dims=3),
]
SERVE_SWEEPS = 64


def phase_serve_small() -> None:
    """The serving plane on the seven-shape mix at width 4, chunk 5:
    served on the card == served on the CPU == the standalone engine on
    the card, bitwise (moments, series, snapshots)."""
    import numpy as np
    import torch
    from repro_torch.api import IsingEngine
    from repro_torch.serve import DONE, MCServeEngine, SimRequest
    reqs = [SimRequest(**kw) for kw in SERVE_MIX]
    reset_launches()
    card = MCServeEngine(replica_width=4, chunk_sweeps=5).serve(reqs)
    torch.cuda.synchronize()
    _no_launches("serve small")
    cpu = MCServeEngine(replica_width=4, chunk_sweeps=5,
                        device="cpu").serve(reqs)
    for req, a, b in zip(reqs, card, cpu):
        alone = IsingEngine(req.engine_config(),
                            device="cuda").simulate(req.seed)
        same = (a.status == b.status == DONE
                and a.moments == b.moments == alone.moments
                and np.array_equal(a.magnetization, b.magnetization)
                and np.array_equal(a.magnetization,
                                   alone.magnetization.numpy())
                and np.array_equal(a.energy, b.energy)
                and np.array_equal(a.energy, alone.energy.numpy())
                and [u.moments for u in a.updates]
                == [u.moments for u in b.updates])
        if not same:
            raise AssertionError(f"serve small {req}: card served != CPU "
                                 "served != card standalone")
    log(f"serve small: {len(reqs)} requests (every family, width 4, chunk "
        "5): card served == CPU served == card standalone, bitwise")


def phase_serve_full() -> None:
    """``repro_torch.launch.serve`` on the card at the launcher's own mix:
    64 requests of 512^2 and 1024^2, Ising (Metropolis, SW, Wolff) and
    Potts (q=2, 3; heat-bath, Metropolis), width 8, chunk 16; req/s,
    Msites/s, latency, ms per chunk of each bucket and the share of a
    chunk outside the sweeps; request 0 re-run standalone, bitwise."""
    from repro_torch.launch import serve
    argv = ["--requests", "64", "--sizes", "512,1024", "--models",
            "ising,potts", "--sweeps", str(SERVE_SWEEPS), "--samples", "4",
            "--replica-width", "8", "--chunk", "16", "--seed", "0",
            "--verify", "--quiet", "--chunk-stats"]
    reset_launches()
    t0 = time.perf_counter()
    if serve.main(argv):
        raise AssertionError("serve: the launcher's bitwise check failed")
    _no_launches("serve")
    log(f"serve full: {' '.join(argv)}; {time.perf_counter() - t0:.1f} s "
        "with the verify run")


def phase_launcher(size: int = 4096) -> None:
    """``repro_torch.launch.simulate`` on one rank of the card: 6 sweeps,
    a checkpoint every 3, a resume to 9 == a straight 9-sweep run."""
    import shutil
    import numpy as np
    from repro_torch.launch import simulate
    work = ROOT / "build" / "chip_smoke_launcher"
    shutil.rmtree(work, ignore_errors=True)
    common = ["--mesh", "1,1", "--blocks-per-device", str(size // 2 // BS),
              "--block-size", str(BS), "--chunk", "3"]
    reset_launches()
    t0 = time.perf_counter()
    for sweeps, where in ((6, "resumed"), (9, "resumed"), (9, "straight")):
        if simulate.main(common + ["--sweeps", str(sweeps), "--ckpt-dir",
                                   str(work / where)]):
            raise AssertionError("the launcher failed")
    _no_launches("launcher")
    with np.load(work / "resumed" / "step_00000009.npz") as a, \
            np.load(work / "straight" / "step_00000009.npz") as b:
        if not np.array_equal(a["qb"], b["qb"]):
            raise AssertionError("launcher: resumed != straight at sweep 9")
    shutil.rmtree(work, ignore_errors=True)
    log(f"launcher {size}^2 on one rank: 6 sweeps (checkpoint every 3), "
        f"resume to 9 == straight 9, bitwise; "
        f"{time.perf_counter() - t0:.1f} s for the three runs")


def phase_algorithm1(size: int = 4096, bs: int = 128) -> None:
    """Paper Algorithm 1 (``update_naive``): card == CPU bitwise at 256^2
    (bs 16), both colours, the table and exp rules, bf16 and f32; then one
    sweep at ``size``^2 (bs ``bs``, bf16) against Algorithm 2's compact
    sweep on the same uniforms, CUDA events, the draws made outside (the
    paper's Algorithm 1 vs 2 claim), and the ``"chain"`` scenario's whole
    sweep (its threefry draws included) beside them."""
    import torch
    from repro_torch import random as jr
    from repro_torch.api import EngineConfig, IsingEngine
    from repro_torch.core import checkerboard as cb
    from repro_torch.core import lattice as L
    reset_launches()
    for dtype in (torch.bfloat16, torch.float32):
        full = L.random_lattice(jr.PRNGKey(101), 256, 256, dtype, "cuda")
        for color in (0, 1):
            for accept in ("lut", "exp"):
                probs = jr.uniform(jr.PRNGKey(102 + color), (256, 256),
                                   device="cuda")
                dev = cb.update_naive(full, probs, BETA, color, 16, accept)
                cpu = cb.update_naive(full.cpu(), probs.cpu(), BETA, color,
                                      16, accept)
                if exact_diff(dev.cpu(), cpu):
                    raise AssertionError(f"update_naive {dtype} {accept} "
                                         f"colour {color}: card != CPU")
    log("Algorithm 1 (update_naive) 256^2 bs 16: card == CPU bitwise, bf16 "
        "and f32, lut and exp, both colours")
    full = L.random_lattice(jr.PRNGKey(103), size, size, device="cuda")
    pb, pw = (jr.uniform(jr.PRNGKey(104 + c), (size, size), device="cuda")
              for c in (0, 1))
    probs = cb.quad_probs_from_full(pb, pw)
    quads = L.to_quads(full)
    naive = cb.sweep_full(full, pb, pw, BETA)       # the oracle, once
    if exact_diff(cb.update_naive(cb.update_naive(full, pb, BETA, 0, bs),
                                  pw, BETA, 1, bs), naive) or exact_diff(
            L.from_quads(cb.sweep_compact(quads, probs, BETA, bs)), naive):
        raise AssertionError("Algorithm 1 or 2 != the oracle at full size")
    alg1_ms = time_ms(lambda: cb.update_naive(
        cb.update_naive(full, pb, BETA, 0, bs), pw, BETA, 1, bs), reps=10)
    alg2_ms = time_ms(lambda: cb.sweep_compact(quads, probs, BETA, bs),
                      reps=10)
    cfg = EngineConfig(size=size, beta=BETA, n_sweeps=4, hot=True)
    eng = IsingEngine(cfg)
    eng.simulate(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.simulate(3)
    torch.cuda.synchronize()
    chain_ms = (time.perf_counter() - t0) / 4 * 1e3
    _no_launches("Algorithm 1 / 2")
    log(f"Algorithm 1 vs 2 at {size}^2 bs {bs} bf16, uniforms drawn outside:"
        f" Algorithm 1 {alg1_ms:.3f} ms per sweep, Algorithm 2 {alg2_ms:.3f}"
        f" ms ({alg1_ms / alg2_ms:.2f}x); both == the full-lattice oracle; "
        f"the chain scenario (Algorithm 2 with its threefry draws) "
        f"{chain_ms:.3f} ms per sweep")


def phase_rbg(sweeps: int = 3) -> None:
    """``DistIsingConfig(rng="rbg")`` on a one-rank grid: the device
    generator's bits repeat for one key and differ for another; the
    reference's physics bounds at 128^2 (cold beta 1.0 stays ordered, hot
    beta 0.2 disordered, 40 sweeps, uint16 bits); then the xla opt sweep
    at 20480^2 with rbg against the same sweep with threefry, host clock
    around synchronised runs after a one-sweep warm-up each, in turns
    (threefry, rbg, rbg, threefry)."""
    import torch
    from repro_torch import random as jr
    from repro_torch.core import lattice as L
    from repro_torch.distributed import ising as dising
    from repro_torch.launch import mesh as mesh_lib
    k = jr.fold_in(jr.PRNGKey(110), 3)
    a = dising.rbg_bits(k, (2, 80, 80, 128, 128), "cuda")
    if not torch.equal(a, dising.rbg_bits(k, a.shape, "cuda")) or \
            torch.equal(a, dising.rbg_bits(jr.fold_in(k, 1), a.shape,
                                           "cuda")):
        raise AssertionError("rbg: one key must give the same bits, "
                             "another key others")
    ones = float((a.view(torch.uint8).unsqueeze(-1).bitwise_and(
        torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                     device="cuda")) != 0).float().mean())
    del a
    grid = mesh_lib.make_grid((1, 1), ("data", "model"), "cuda")

    def blocked(full, bs):
        quads = L.to_quads(full)
        return torch.stack([L.block(quads[i], bs) for i in range(4)])

    ms = []
    for beta, full, key in (
            (1.0, L.cold_lattice(128, 128, device="cuda"), 0),
            (0.2, L.random_lattice(jr.PRNGKey(1), 128, 128, device="cuda"),
             1)):
        cfg = dising.DistIsingConfig(beta=beta, block_size=16,
                                     pipeline="opt", rng="rbg",
                                     bits_dtype="uint16")
        out = dising.make_run_sweeps_fn(grid, cfg, 40)(blocked(full, 16),
                                                       jr.PRNGKey(key))
        ms.append(abs(float(out.float().mean())))
    if not (ms[0] > 0.95 and ms[1] < 0.2):
        raise AssertionError(f"rbg physics at 128^2: |m| {ms}")
    log(f"rbg bits: same key == same bits, another key differs; share of "
        f"one bits {ones:.6f}; 128^2 uint16 40 sweeps: cold beta 1.0 |m| = "
        f"{ms[0]:.6f} > 0.95, hot beta 0.2 |m| = {ms[1]:.6f} < 0.2")
    qb = blocked(L.random_lattice(jr.PRNGKey(111), SIZE, SIZE,
                                  device="cuda"), BS)
    times = {"threefry": [], "rbg": []}
    for rng in ("threefry", "rbg", "rbg", "threefry"):
        cfg = dising.DistIsingConfig(beta=BETA, block_size=BS,
                                     pipeline="opt", rng=rng)
        dising.make_run_sweeps_fn(grid, cfg, 1)(qb, jr.PRNGKey(112))
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = dising.make_run_sweeps_fn(grid, cfg, sweeps)(qb,
                                                           jr.PRNGKey(113))
        torch.cuda.synchronize()
        times[rng].append((time.perf_counter() - t0) / sweeps * 1e3)
        _no_launches(f"opt xla {rng}")
        if not abs(float(out.float().mean())) <= 1.0:
            raise AssertionError(f"opt xla {rng}: bad lattice")
        del out
    t, r = (min(times[n]) for n in ("threefry", "rbg"))
    log(f"opt xla {SIZE}^2 bs {BS} bf16, {sweeps} sweeps a run: threefry "
        f"{times['threefry']} ms per sweep, rbg {times['rbg']} ms per sweep "
        f"(best {t:.3f} vs {r:.3f}: {t / r:.1f}x); "
        f"{SIZE ** 2 / r / 1e6:.4f} flips/ns with rbg")


# qwen3-0.6b as published (the LM full-width phase)
LM_ARCH = "qwen3-0.6b"
LM_SEQ, LM_BATCH, LM_MICRO, LM_STEPS = 4096, 8, 4, 4
# the slice-7 families: mamba2-780m (the main path of the new layers),
# recurrentgemma-2b and kimi-k2 at full width
SSM_ARCH, REC_ARCH, MOE_ARCH = "mamba2-780m", "recurrentgemma-2b", \
    "kimi-k2-1t-a32b"
REC_TRAIN_LAYERS = 12        # depth cut of recurrentgemma's training run
REC_MICRO = 8


def _avg_context(cfg, kind: str, seq: int) -> float:
    """Keys a query attends to, averaged over a causal sequence: seq / 2
    for global attention, the trailing window for 'l'."""
    w = cfg.window if kind == "l" else 0
    if not w or w >= seq:
        return seq / 2
    return (w * (w + 1) / 2 + (seq - w) * w) / seq


def lm_forward_flops(cfg, seq: int) -> float:
    """The forward's FLOPs a token: 2 per weight a token touches (routed
    and shared experts, the router, the unembedding included), causal
    attention's QK^T and PV (2 x 2 x context x heads x head_dim), and the
    chunked SSD's dense products (C.B, the chunk's quadratic form, the
    chunk states and the cross-chunk term). The RG-LRU scan's elementwise
    work is not counted."""
    d, hd = cfg.d_model, cfg.head_dim
    n_mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
    flops = 2.0 * d * cfg.padded_vocab * max(cfg.n_codebooks, 1)
    for kind in cfg.pattern:
        if kind in ("a", "l"):
            flops += 2 * d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
                + 2 * cfg.n_heads * hd * d \
                + 4 * _avg_context(cfg, kind, seq) * cfg.n_heads * hd
        elif kind == "r":
            flops += 2 * 5 * d * d
        else:
            d_inner = cfg.ssm_expand * d
            nh, ns = d_inner // cfg.ssm_head_dim, cfg.ssm_state
            q = min(cfg.ssm_chunk, seq)
            flops += 2 * d * (2 * d_inner + 2 * ns + nh) + 2 * d_inner * d \
                + 2 * q * ns + 2 * q * d_inner + 4 * d_inner * ns
            continue
        if cfg.n_experts:
            flops += 2 * d * cfg.n_experts + 2 * n_mats * d * cfg.moe_d_ff \
                * (cfg.experts_per_token + cfg.n_shared_experts)
        else:
            flops += 2 * n_mats * d * cfg.d_ff
    return flops


def lm_model_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 3 x the forward's. Remat's
    recomputed forward is not counted."""
    return 3.0 * batch * seq * lm_forward_flops(cfg, seq)


def _free() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


# f32 tolerances of the CPU tests: absolute on logits and losses, of each
# tensor's largest entry on grads, the state after the optimizer steps and
# the decode states
LM_TOL = {"logits": (1e-5, False), "loss": (1e-5, False),
          "grads": (1e-4, True), "state after 3 steps": (1e-4, True),
          "prefill logits": (1e-5, False), "decode logits": (1e-5, False),
          "decode states": (1e-4, True)}
# a family's own f32 conditioning: one ulp of noise on every initial
# parameter moves the CPU's results by d; the card is held to
# max(tolerance, NOISE_MARGIN * d) for each result
NOISE_MARGIN = 4.0


def _lm_outputs(cfg, ocfg, state, device, prompt: int, max_len: int,
                tokens=None) -> dict:
    """name -> the f32 results on the CPU: logits, loss and grads of one
    batch; prefill + 4 decode steps (fed ``tokens`` [B, 4], or greedy,
    recorded under "tokens") and the decode states; the losses and the
    whole state after 3 optimizer steps."""
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS
    shape = ShapeConfig("small", seq_len=64, global_batch=4, kind="train")
    out = {}

    def put(name, *ts):
        out.setdefault(name, []).extend(t.detach().float().cpu() for t in ts)

    batch = syn.device_batch(0, shape, cfg, device)
    put("logits", T.forward(state["params"], cfg, batch))
    loss, grads = TS.value_and_grad(cfg)(state["params"], batch)
    put("loss", loss)
    put("grads", *tree.leaves(grads))
    logits, states = M.make_prefill(cfg, max_len)(
        state["params"], {"tokens": batch["tokens"][:, :prompt]})
    put("prefill logits", logits)
    decode = M.make_decode_step(cfg)
    fed = []
    for j, pos in enumerate(range(prompt, prompt + 4)):
        tok = (logits.argmax(-1).int() if tokens is None
               else tokens[:, j:j + 1].to(device))
        fed.append(tok.cpu())
        logits, states = decode(state["params"], states,
                                {"tokens": tok, "pos": pos})
        put("decode logits", logits)
    put("decode states", *tree.leaves(states))
    out["tokens"] = torch.cat(fed, 1)
    step = TS.make_train_step(cfg, ocfg)
    for i in range(3):
        state, metrics = step(state, syn.device_batch(i, shape, cfg, device))
        put("loss", metrics["loss"])
    put("state after 3 steps", *tree.leaves(state))
    return out


def _lm_card_vs_cpu(label: str, cfg, ocfg, seed: int, prompt: int = 48,
                    max_len: int = 56, calibrate: bool = False) -> tuple:
    """The same weights on the card and the CPU: logits, loss, grads, 3
    optimizer steps, prefill + 4 decode steps (the CPU's greedy tokens fed
    to both), held to ``LM_TOL``; with ``calibrate`` each result's bound is
    max(``LM_TOL``, ``NOISE_MARGIN`` x what one ulp of noise on the
    initial parameters moves it on the CPU). Returns (the largest
    differences, their bounds), by name."""
    import torch
    from repro_torch import tree
    from repro_torch.train import train_step as TS
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: f32 products would not "
                             "be f32")
    cpu = TS.init_train_state(cfg, ocfg, torch.Generator().manual_seed(seed))
    want = _lm_outputs(cfg, ocfg, cpu, "cpu", prompt, max_len)
    got = _lm_outputs(cfg, ocfg, tree.map(lambda a: a.to("cuda"), cpu),
                      "cuda", prompt, max_len, want["tokens"])

    def diffs(a_out, b_out):
        d = {}
        for name, (tol, rel) in LM_TOL.items():
            d[name] = [float((a - b).abs().max()) / (
                max(float(b.abs().max()), 1e-30) if rel else 1.0)
                for a, b in zip(a_out[name], b_out[name])]
        return d

    errs = diffs(got, want)
    bounds = {name: [tol] * len(errs[name])
              for name, (tol, _) in LM_TOL.items()}
    if calibrate:
        gen = torch.Generator().manual_seed(seed + 1)
        noisy = tree.map(lambda a: a * (1 + torch.randint(
            -1, 2, a.shape, generator=gen).float() * 2.0 ** -23)
            if a.is_floating_point() else a.clone(), cpu)
        noise = diffs(_lm_outputs(cfg, ocfg, noisy, "cpu", prompt, max_len,
                                  want["tokens"]), want)
        bounds = {name: [max(b, NOISE_MARGIN * n) for b, n in
                         zip(bounds[name], noise[name])] for name in bounds}
    for name in LM_TOL:
        for i, (e, b) in enumerate(zip(errs[name], bounds[name])):
            if not e <= b:
                raise AssertionError(f"{label} small {name} [{i}]: card != "
                                     f"CPU, err {e} > {b}")
    _no_launches(f"{label} small")
    return ({name: max(v) for name, v in errs.items()},
            {name: max(v) for name, v in bounds.items()})


def _launch_resumed_equals_straight(arch: str, work: Path) -> float:
    """``repro_torch.launch.train`` on the card (``--scale 0.05``, bf16):
    4 steps with a checkpoint every 2, resumed to 6, equal bitwise to a
    straight 6-step run. Returns the seconds of the three runs."""
    import shutil
    import numpy as np
    from repro_torch.launch import train as launch_train
    shutil.rmtree(work, ignore_errors=True)
    common = ["--arch", arch, "--scale", "0.05", "--batch", "8", "--seq",
              "128", "--microbatches", "2", "--seed", "5"]
    t0 = time.perf_counter()
    for steps, where, every in ((4, "resumed", 2), (6, "resumed", 2),
                                (6, "straight", 6)):
        if launch_train.main(common + ["--steps", str(steps), "--ckpt-dir",
                                       str(work / where), "--ckpt-every",
                                       str(every)]):
            raise AssertionError(f"launch.train {arch} failed")
    _no_launches(f"launch.train {arch}")
    with np.load(work / "resumed" / "step_00000006.npz") as a, \
            np.load(work / "straight" / "step_00000006.npz") as b:
        if sorted(a.files) != sorted(b.files) or not all(
                np.array_equal(a[n], b[n]) for n in a.files):
            raise AssertionError(f"launch.train {arch}: resumed != straight "
                                 "at 6")
    shutil.rmtree(work, ignore_errors=True)
    return time.perf_counter() - t0


def phase_lm_small() -> None:
    """qwen3-0.6b at --scale 0.05 in f32 with the same weights on the card
    and the CPU (``_lm_card_vs_cpu``: AdamW); then
    ``repro_torch.launch.train`` on the card resumed == straight."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optimizer as opt
    reset_launches()
    cfg = dataclasses.replace(
        launch_train._reduce(get_config(LM_ARCH), 0.05), dtype="float32")
    errs, _ = _lm_card_vs_cpu("LM", cfg, opt.OptimizerConfig(
        lr=1e-3, warmup_steps=1), seed=7)
    log(f"LM small ({LM_ARCH} scale 0.05, f32, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}): card == CPU within the f32 tolerances, "
        f"largest differences {errs}")
    secs = _launch_resumed_equals_straight(
        LM_ARCH, ROOT / "build" / "chip_smoke_train")
    log(f"launch.train on the card (scale 0.05, bf16): 4 steps with a "
        f"checkpoint every 2, resumed to 6 == straight 6, bitwise; "
        f"{secs:.1f} s for the three runs")


def phase_lm_scores() -> None:
    """What the f32 scores of bf16 operands cost at the full-width shapes
    (one chunk pair of one microbatch: [B*KV, qc*G, hd] x [B*KV, hd, kc]):
    the bf16-in, f32-out GEMM the port uses against an f32 GEMM of the
    widened operands and a bf16 GEMM that rounds the scores."""
    import torch
    from repro_torch.models import layers as LY
    b, kv, g, hd, qc, kc = 2, 8, 2, 128, 1024, 1024
    q = torch.randn(b * kv, qc * g, hd, device="cuda").bfloat16()
    k = torch.randn(b * kv, kc, hd, device="cuda").bfloat16()
    kt = k.transpose(-1, -2)
    got = LY.matmul_f32(q, kt)
    want = torch.bmm(q.float(), kt.float())
    rel = float((got - want).abs().max() / want.abs().max())
    if got.dtype != torch.float32 or rel > 1e-5:
        raise AssertionError(f"matmul_f32: {got.dtype}, rel err {rel}")
    flops = 2 * b * kv * qc * g * kc * hd
    t_out = time_ms(lambda: LY.matmul_f32(q, kt), reps=50)
    t_f32 = time_ms(lambda: torch.bmm(q.float(), kt.float()), reps=50)
    t_bf16 = time_ms(lambda: torch.bmm(q, kt), reps=50)
    log(f"attention scores [{b * kv}, {qc * g}, {hd}] x [{hd}, {kc}]: bf16 "
        f"in, f32 out {t_out:.4f} ms ({flops / t_out / 1e9:.1f} TFLOP/s); "
        f"widened to f32 {t_f32:.4f} ms ({flops / t_f32 / 1e9:.1f}); bf16 "
        f"out (rounded) {t_bf16:.4f} ms ({flops / t_bf16 / 1e9:.1f}); "
        f"max rel diff to the f32 product {rel:.2e}")


def _small_family_configs() -> dict:
    """The new families at ``launch.train``'s --scale 0.05 in f32;
    recurrentgemma keeps a full 'rrl' cycle (3 layers) and a window of 32
    that a 48-token prompt overruns, so the ring is rolled."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train

    def small(arch, **kw):
        return dataclasses.replace(launch_train._reduce(
            get_config(arch), 0.05), dtype="float32", **kw)

    return {SSM_ARCH: small(SSM_ARCH), REC_ARCH: small(
        REC_ARCH, n_layers=3, window=32), MOE_ARCH: small(MOE_ARCH)}


def phase_lm_small_families() -> None:
    """mamba2, recurrentgemma and kimi (MoE) small, f32, card == CPU with
    the same weights and each config's optimizer, each result held to
    max(the CPU tests' tolerance, ``NOISE_MARGIN`` x the CPU's own
    response to one ulp of noise on the initial parameters): the SSD's
    chunk decays exp(cs_i - cs_j) and AdamW's normalised steps where a
    gradient sign flips amplify last-bit differences, so mamba2's
    logits differ between the card and the CPU by more than 1e-5 (the
    phase prints the differences and the bounds). Then
    ``launch.train`` resumed == straight on the card, bitwise, for kimi
    (MoE: a deterministic dispatch and combine) and mamba2."""
    from repro_torch.train import optimizer as opt
    reset_launches()
    for arch, cfg in _small_family_configs().items():
        t0 = time.perf_counter()
        errs, bounds = _lm_card_vs_cpu(arch, cfg, opt.OptimizerConfig(
            kind=cfg.optimizer, lr=1e-3, warmup_steps=1), seed=11,
            calibrate=True)
        log(f"{arch} small (scale 0.05, f32, {cfg.n_layers} layers "
            f"{cfg.pattern}, d_model {cfg.d_model}, experts "
            f"{cfg.n_experts}, {cfg.optimizer}): card == CPU, largest "
            f"differences {errs}, bounds {bounds}; "
            f"{time.perf_counter() - t0:.1f} s")
    for arch in (MOE_ARCH, SSM_ARCH):
        secs = _launch_resumed_equals_straight(
            arch, ROOT / "build" / "chip_smoke_train")
        log(f"launch.train {arch} on the card (scale 0.05, bf16): resumed "
            f"to 6 == straight 6, bitwise; {secs:.1f} s for the three runs")


def _train_report(label: str, cfg, trainer, res, wall: float, peak: int,
                  batch: int, seq: int, micro: int) -> float:
    """Log a full-width training run; returns the median step seconds
    after the first."""
    from repro_torch import tree
    losses = res["losses"]
    if len(losses) != len(trainer.step_times) or not all(
            map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses}")
    rest = sorted(trainer.step_times[1:])
    step_s = rest[len(rest) // 2]
    tokens = batch * seq
    flops = lm_model_flops(cfg, batch, seq)
    n_params = sum(a.numel() for a in tree.leaves(trainer.state["params"]))
    log(f"{label}: {n_params / 1e9:.4f} B params, seq {seq}, batch {batch} "
        f"in {micro} microbatches, {len(losses)} steps in {wall:.1f} s (init "
        f"included); step times "
        f"{[round(t * 1e3, 1) for t in trainer.step_times]} ms; median after "
        f"the first {step_s * 1e3:.1f} ms, {tokens / step_s:.1f} tokens/s; "
        f"losses {losses}; peak memory {peak / 2**30:.2f} GiB; model FLOPs a "
        f"step {flops:.4e}, {flops / step_s / 1e12:.1f} TFLOP/s = "
        f"{flops / step_s / BF16_FLOPS:.2%} of the {BF16_FLOPS:.3g} bf16 "
        f"dense peak (H100 SXM data sheet)")
    return step_s


def _profile_microbatch(label: str, cfg, params, mb) -> None:
    """One microbatch's forward and backward under the profiler (kernels
    only): wall, device busy, GEMMs' share, the top 10 kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import train_step as TS
    grad_fn = TS.value_and_grad(cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grad_fn(params, mb)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if not busy:
        raise AssertionError("the profiler saw no device time")
    gemm = sum(e.self_device_time_total for e in events
               if re.search(r"gemm|nvjet|xmma|cutlass", e.key)) / 1e6
    log(f"{label} profile of one microbatch (forward + backward, remat): "
        f"{prof_s * 1e3:.1f} ms wall, device busy {busy * 1e3:.1f} ms "
        f"({busy / prof_s:.1%}), GEMMs {gemm * 1e3:.1f} ms "
        f"({gemm / busy:.1%} of busy); top kernels by device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:9.1f} ms {e.count:6d} x "
            f"{e.key[:96]}")


def _fwd_bwd_ms(fn, inputs) -> tuple:
    """CUDA-event ms of ``fn(*inputs)`` forward, and forward + backward of
    the sum of its (first) output into the inputs that require grad."""
    import torch
    wrt = [a for a in inputs if a.requires_grad]

    def fwd():
        out = fn(*inputs)
        return out[0] if isinstance(out, tuple) else out

    fwd_ms = time_ms(fwd, reps=3, warmup=1)
    both_ms = time_ms(lambda: torch.autograd.grad(fwd().float().sum(), wrt),
                      reps=3, warmup=1)
    return fwd_ms, both_ms


def _serve(label: str, cfg, params, seq: int, n_decode: int = 32,
           batch=None) -> dict:
    """Prefill one ``seq``-token prompt (max_len seq + n_decode), then
    ``n_decode`` greedy decode steps, timed on the host clock around
    synchronised work after a warm-up; then 4 decode steps under the
    profiler: kernels a token and the device's busy time of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.models import model as M
    prompt = syn.device_batch(0, ShapeConfig("p", seq_len=seq,
                                             global_batch=1, kind="train"),
                              cfg, "cuda")["tokens"]
    prefill = M.make_prefill(cfg, seq + n_decode)
    decode = M.make_decode_step(cfg)
    logits, states = prefill(params, {"tokens": prompt})     # warm-up
    decode(params, states, {"tokens": logits.argmax(-1).int(), "pos": seq})
    del logits, states
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, states = prefill(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = logits.argmax(-1).int()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pos in range(seq, seq + n_decode):
        logits, states = decode(params, states, {"tokens": tok, "pos": pos})
        tok = logits.argmax(-1).int()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / n_decode
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{label} decode: non-finite logits")
    del states
    logits, states = prefill(params, {"tokens": prompt})
    tok = logits.argmax(-1).int()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for pos in range(seq, seq + 4):
            logits, states = decode(params, states,
                                    {"tokens": tok, "pos": pos})
            tok = logits.argmax(-1).int()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    out = {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
           "kernels": sum(e.count for e in events) / 4,
           "busy_ms": sum(e.self_device_time_total for e in events) / 4e3}
    _no_launches(f"{label} prefill/decode")
    log(f"{label} prefill 1 x {seq} (max_len {seq + n_decode}): "
        f"{prefill_ms:.1f} ms ({seq / prefill_ms * 1e3:.1f} tokens/s); "
        f"decode {decode_ms:.3f} ms a token ({n_decode} greedy steps, batch "
        f"1); a token launches {out['kernels']:.0f} kernels, device busy "
        f"{out['busy_ms']:.3f} ms of it (4 steps profiled)")
    return out


def phase_lm_full() -> dict:
    """``repro_torch.launch.train`` at the published qwen3-0.6b (28 layers,
    d_model 1024, 16/8 heads of 128, d_ff 3072, vocab 151936, already a
    multiple of the 128 it is padded to, qk_norm, SwiGLU, bf16), seq 4096,
    batch 8 in 4 microbatches, AdamW with f32 states, remat, no
    checkpoint: ms a step after the first, tokens/s, peak memory, the loss
    of each step, model FLOPs as a share of the bf16 peak; the device time
    of one microbatch by kernel (``torch.profiler``) and attention's share
    of a step; then prefill 1 x 4096 (max_len 4128) and 32 greedy decode
    steps, and the kernels a decode token launches. Returns the run's
    losses, grad norms, median step seconds and peak bytes (the twin of
    :func:`phase_lm_sharded`)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.launch import train as launch_train
    from repro_torch.models import layers as LY
    reset_launches()
    _free()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", LM_ARCH, "--scale", "1.0", "--seq", str(LM_SEQ),
            "--batch", str(LM_BATCH), "--microbatches", str(LM_MICRO),
            "--steps", str(LM_STEPS)]
    t0 = time.perf_counter()
    run = launch_train.train(launch_train.parse_args(argv))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _no_launches("LM full")
    cfg, trainer, res = run["cfg"], run["trainer"], run["result"]
    shape = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.padded_vocab,
             cfg.qk_norm, cfg.activation, cfg.dtype, cfg.remat)
    if shape != (28, 1024, 16, 8, 128, 3072, 151936, 151936, True,
                 "swiglu", "bfloat16", True):
        raise AssertionError(f"not the published qwen3-0.6b: {shape}")
    step_s = _train_report(f"LM full {LM_ARCH}", cfg, trainer, res, wall,
                           peak, LM_BATCH, LM_SEQ, LM_MICRO)
    twin = {"losses": res["losses"], "grad_norms": res["grad_norms"],
            "step_s": step_s, "peak": peak}
    # where a step's device time goes: one microbatch's forward and
    # backward under the profiler (kernels only), and the attention of one
    # layer and microbatch alone (CUDA events)
    mb = syn.device_batch(LM_STEPS, ShapeConfig(
        "p", seq_len=LM_SEQ, global_batch=LM_BATCH // LM_MICRO,
        kind="train"), cfg, "cuda")
    params = trainer.state["params"]
    _profile_microbatch("LM full", cfg, params, mb)
    del mb
    gen = torch.Generator("cuda").manual_seed(1)
    b = LM_BATCH // LM_MICRO
    q = torch.randn(b, LM_SEQ, cfg.n_heads, cfg.head_dim, device="cuda",
                    generator=gen).bfloat16().requires_grad_()
    k, v = (torch.randn(b, LM_SEQ, cfg.n_kv_heads, cfg.head_dim,
                        device="cuda", generator=gen).bfloat16()
            .requires_grad_() for _ in range(2))
    fwd_ms, both_ms = _fwd_bwd_ms(LY.flash_attention, (q, k, v))
    attn_s = LM_MICRO * cfg.n_layers * (fwd_ms + both_ms) / 1e3
    log(f"LM full attention of one layer and microbatch [{b}, {LM_SEQ}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, {cfg.head_dim}]: forward "
        f"{fwd_ms:.2f} ms, forward + backward {both_ms:.2f} ms; a step "
        f"(x {LM_MICRO} microbatches x {cfg.n_layers} layers, the forward "
        f"twice under remat) {attn_s * 1e3:.0f} ms, {attn_s / step_s:.1%} "
        f"of the step")
    del q, k, v, trainer, run
    # serving half: prefill one 4096-token prompt, then decode 32 tokens
    _serve("LM full", cfg, params, LM_SEQ)
    del params
    _free()
    return twin


def phase_lm_sharded(twin: dict) -> None:
    """The sharding engine on the card (no kernel): ``launch.train --mesh
    1,1`` at phase 4c's published qwen3-0.6b (seq 4096, batch 8 in 4
    microbatches, 4 steps, seed 0) on a one-rank NCCL group, through the
    sharded step (placements, the rank's rows, gathers and all-reduces
    that one rank makes identities). Its losses and grad norms are the
    unsharded run's, bitwise; ms a step and peak memory beside the twin.
    Then ``psum_compressed`` over the group of one microbatch's gradient
    tree == the quantize / dequantize round trip, bitwise, timed."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.distributed import compression as C
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    from repro_torch.train import train_step as TS
    card = card_line()
    reset_launches()
    _free()
    torch.cuda.reset_peak_memory_stats()
    init_group()
    argv = ["--arch", LM_ARCH, "--scale", "1.0", "--seq", str(LM_SEQ),
            "--batch", str(LM_BATCH), "--microbatches", str(LM_MICRO),
            "--steps", str(LM_STEPS), "--mesh", "1,1", "--seed", "0"]
    t0 = time.perf_counter()
    run = launch_train.train(launch_train.parse_args(argv), log_fn=log)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cfg, trainer, res = run["cfg"], run["trainer"], run["result"]
    if (res["losses"], res["grad_norms"]) != (twin["losses"],
                                             twin["grad_norms"]):
        raise AssertionError(
            f"LM sharded: --mesh 1,1 losses {res['losses']} grad norms "
            f"{res['grad_norms']} differ from the unsharded run's "
            f"{twin['losses']} {twin['grad_norms']}")
    step_s = _train_report(f"LM sharded {LM_ARCH} --mesh 1,1", cfg, trainer,
                           res, wall, peak, LM_BATCH, LM_SEQ, LM_MICRO)
    log(f"LM sharded --mesh 1,1 ({card}): losses and grad norms of 4 steps "
        f"== the unsharded run's, bitwise ({res['grad_norms']}); "
        f"{step_s * 1e3:.1f} ms a step, peak {peak / 2**30:.2f} GiB; the "
        f"unsharded twin {twin['step_s'] * 1e3:.1f} ms, "
        f"{twin['peak'] / 2**30:.2f} GiB")
    # one microbatch's gradient tree (bf16, the parameters' dtype)
    params = trainer.state["params"]
    del trainer, run
    mb = syn.device_batch(LM_STEPS, ShapeConfig(
        "p", seq_len=LM_SEQ, global_batch=LM_BATCH // LM_MICRO,
        kind="train"), cfg, "cuda")
    _, grads = TS.value_and_grad(cfg)(params, mb)
    del params, mb
    grid = mesh_lib.make_grid((1, 1, 1), ("pod", "data", "model"), "cuda")
    mesh_lib.reset_counters()
    summed = C.psum_compressed(grads, grid, None)
    reduces = mesh_lib.counters["all_reduce"]
    want = C.decompress_tree(C.compress_tree(grads))
    leaves = tree.leaves(grads)
    for got, ref, g in zip(tree.leaves(summed), tree.leaves(want), leaves):
        if not torch.equal(got, ref.to(g.dtype)):
            raise AssertionError("LM sharded: psum_compressed over one rank "
                                 "differs from the quantize round trip")
    if reduces != 2 * len(leaves):
        raise AssertionError(f"LM sharded: {reduces} all-reduces for "
                             f"{len(leaves)} leaves (want a pmax and a psum "
                             "each)")
    ms = time_ms(lambda: C.psum_compressed(grads, grid, None), reps=5,
                 warmup=1)
    nbytes = sum(g.numel() * g.element_size() for g in leaves)
    log(f"LM sharded psum_compressed ({card}): {len(leaves)} leaves, "
        f"{nbytes / 1e9:.3f} GB of bf16 gradients, == dequantize(quantize) "
        f"bitwise, {reduces} NCCL all-reduces (a pmax and an int32 psum a "
        f"leaf); {ms:.3f} ms a call (one rank: quantizing, no wire)")
    del grads, summed, want
    dist.destroy_process_group()
    _no_launches("LM sharded")
    _free()


def _moe_ep_one_rank(cfg, pm) -> None:
    """kimi's published MoE layer (phase 4d's) under the sharding engine on
    a one-rank NCCL grid: at prefill 1 x 4096 (T >= 2E) ``moe_forward``
    takes the expert-parallel form, == the unsharded ``moe_forward``
    bitwise; then one rank's share of the production 16-way model axis,
    ``_dispatch_combine`` over 24 of the 384 experts (capacity from the
    4096 local tokens), against its byte bound."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe
    card = card_line()
    init_group()
    grid = mesh_lib.make_grid((1, 1), ("data", "model"), "cuda")
    x = torch.randn(1, LM_SEQ, cfg.d_model, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(5)
                    ).bfloat16()
    calls = []
    ep = moe.moe_forward_ep

    def counting(*args, **kw):
        calls.append(1)
        return ep(*args, **kw)

    with torch.no_grad():
        y, aux = moe.moe_forward(pm, cfg, x)
        moe.moe_forward_ep = counting
        try:
            with SH.activation_sharding(grid, SH.rules_for(cfg)):
                y_ep, aux_ep = moe.moe_forward(pm, cfg, x)
        finally:
            moe.moe_forward_ep = ep
    if len(calls) != 1 or not (torch.equal(y, y_ep)
                               and torch.equal(aux, aux_ep)):
        raise AssertionError(f"MoE EP one rank: {len(calls)} EP calls; "
                             "y or aux differ from moe_forward")
    e_loc = cfg.n_experts // 16
    xf = x.reshape(-1, cfg.d_model)
    logits = xf.float() @ pm["router"]
    cap = moe.capacity(cfg, xf.shape[0])
    w = {k: pm[k][:e_loc] for k in ("wi", "wg", "wo")}
    with torch.no_grad():
        ms = time_ms(lambda: moe._dispatch_combine(
            cfg, xf, logits, w["wi"], w["wg"], w["wo"], 0, e_loc, cap),
            reps=10, warmup=2)
    wbytes = sum(a.numel() * a.element_size() for a in w.values())
    io = 2 * xf.numel() * xf.element_size() + logits.numel() * 4
    log(f"MoE EP one rank ({card}): prefill 1 x {LM_SEQ} through "
        f"moe_forward_ep == moe_forward, bitwise; one rank of the 16-way "
        f"model axis, {e_loc} of {cfg.n_experts} experts, capacity {cap}: "
        f"{ms:.3f} ms; bound {wbytes / HBM_BYTES_PER_S * 1e3:.3f} ms (its "
        f"{wbytes / 1e9:.2f} GB of expert weights at 3.35 TB/s; "
        f"{(wbytes + io) / HBM_BYTES_PER_S * 1e3:.3f} with the tokens, "
        f"logits and output), {wbytes / HBM_BYTES_PER_S * 1e3 / ms:.1%} "
        "of it")
    dist.destroy_process_group()


def phase_ssm_full() -> float:
    """The slice's main path: ``repro_torch.launch.train`` at the published
    mamba2-780m (48 's' layers, d_model 1536, d_inner 3072 = 48 heads of
    64, d_state 128, chunk 256, vocab 50280 padded to 50304, bf16, AdamW,
    remat), seq 4096, batch 8 in 4 microbatches, 4 steps: ms a step,
    tokens/s, the share of the bf16 peak, peak memory, the losses; one
    microbatch by kernel; the chunked SSD of one layer and microbatch
    alone (CUDA events) and its share of a step; then prefill 1 x 4096
    and 32 greedy decode steps. Returns the median step seconds."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.launch import train as launch_train
    from repro_torch.models import mamba2
    reset_launches()
    _free()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", SSM_ARCH, "--scale", "1.0", "--seq", str(LM_SEQ),
            "--batch", str(LM_BATCH), "--microbatches", str(LM_MICRO),
            "--steps", str(LM_STEPS)]
    t0 = time.perf_counter()
    run = launch_train.train(launch_train.parse_args(argv))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _no_launches("SSM full")
    cfg, trainer, res = run["cfg"], run["trainer"], run["result"]
    d_inner, nheads, _ = mamba2.dims(cfg)
    shape = (cfg.n_layers, cfg.pattern[0], cfg.d_model, d_inner, nheads,
             cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk, cfg.vocab_size,
             cfg.padded_vocab, cfg.dtype, cfg.remat, cfg.optimizer)
    if shape != (48, "s", 1536, 3072, 48, 64, 128, 256, 50280, 50304,
                 "bfloat16", True, "adamw"):
        raise AssertionError(f"not the published mamba2-780m: {shape}")
    step_s = _train_report(f"SSM full {SSM_ARCH}", cfg, trainer, res, wall,
                           peak, LM_BATCH, LM_SEQ, LM_MICRO)
    mb = syn.device_batch(LM_STEPS, ShapeConfig(
        "p", seq_len=LM_SEQ, global_batch=LM_BATCH // LM_MICRO,
        kind="train"), cfg, "cuda")
    params = trainer.state["params"]
    _profile_microbatch("SSM full", cfg, params, mb)
    del mb
    # the chunked SSD alone at one microbatch's shapes (x, B, C in the
    # model's dtype, dt f32 after softplus, as the mixer feeds it)
    gen = torch.Generator("cuda").manual_seed(2)
    b, ns = LM_BATCH // LM_MICRO, cfg.ssm_state

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, device="cuda", generator=gen).to(
            dtype).requires_grad_()

    x = rnd(b, LM_SEQ, nheads, cfg.ssm_head_dim)
    dt = torch.nn.functional.softplus(rnd(b, LM_SEQ, nheads,
                                          dtype=torch.float32)).detach()
    a = -torch.exp(torch.zeros(nheads, device="cuda"))
    bm, cm = rnd(b, LM_SEQ, ns), rnd(b, LM_SEQ, ns)
    fwd_ms, both_ms = _fwd_bwd_ms(
        lambda *t: mamba2.ssd_chunked(*t, cfg.ssm_chunk),
        (x, dt.requires_grad_(), a, bm, cm))
    ssd_s = LM_MICRO * cfg.n_layers * (fwd_ms + both_ms) / 1e3
    log(f"SSM full chunked SSD of one layer and microbatch [{b}, {LM_SEQ}, "
        f"{nheads}, {cfg.ssm_head_dim}], d_state {ns}, chunk "
        f"{cfg.ssm_chunk}: forward {fwd_ms:.2f} ms, forward + backward "
        f"{both_ms:.2f} ms; a step (x {LM_MICRO} microbatches x "
        f"{cfg.n_layers} layers, the forward twice under remat) "
        f"{ssd_s * 1e3:.0f} ms, {ssd_s / step_s:.1%} of the step")
    del x, dt, bm, cm, trainer, run
    _serve("SSM full", cfg, params, LM_SEQ)
    del params
    _free()
    return step_s


def _train_loop(cfg, seq: int, batch: int, micro: int, steps: int,
                seed: int = 0) -> tuple:
    """The launcher's loop (``launch.train.train``'s state, step and
    ``Trainer``) for a config it cannot name (a depth cut). Returns
    (trainer, result, wall seconds, peak bytes)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import Trainer, TrainLoopConfig
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ocfg = opt.OptimizerConfig(kind=cfg.optimizer)
    gen = torch.Generator("cuda").manual_seed(seed)
    trainer = Trainer(TS.make_train_step(cfg, ocfg, micro),
                      TS.init_train_state(cfg, ocfg, gen, "cuda"),
                      syn.iterate(ShapeConfig("cli", seq_len=seq,
                                              global_batch=batch,
                                              kind="train"), cfg, "cuda"),
                      TrainLoopConfig(total_steps=steps, log_every=1),
                      log_fn=log)
    res = trainer.run()
    return (trainer, res, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


def phase_rec_full() -> None:
    """recurrentgemma-2b as published (26 layers 'rrl', d_model 2560, 10
    heads of 256 with kv 1, window 2048, GeGLU, vocab 256000, bf16): prefill
    1 x 4096 (max_len 4128) and 32 greedy decode steps (O(1) state per 'r'
    layer, the window ring per 'l' layer); then 4 training steps at seq
    4096, batch 8 in 8 microbatches of 1, AdamW, with the depth cut to
    ``REC_TRAIN_LAYERS`` (the functional AdamW update holds the old and
    new parameters and moments together: 24 B a parameter, 85 GB at the
    full 3.55e9); the RG-LRU scan of one layer and microbatch alone and
    its share of a step."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.models import rglru
    from repro_torch.models import transformer as T
    reset_launches()
    _free()
    cfg = get_config(REC_ARCH)
    shape = (cfg.n_layers, cfg.pattern, cfg.d_model, cfg.n_heads,
             cfg.n_kv_heads, cfg.head_dim, cfg.window, cfg.activation,
             cfg.vocab_size, cfg.dtype)
    if shape != (26, "rrlrrlrrlrrlrrlrrlrrlrrlrr", 2560, 10, 1, 256, 2048,
                 "geglu", 256000, "bfloat16"):
        raise AssertionError(f"not the published recurrentgemma-2b: {shape}")
    t0 = time.perf_counter()
    params = T.init_model(cfg, torch.Generator("cuda").manual_seed(0),
                          "cuda")
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in tree.leaves(params))
    log(f"REC full {REC_ARCH}: {n_params / 1e9:.4f} B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    _serve("REC full", cfg, params, LM_SEQ)
    del params
    _free()
    tcfg = dataclasses.replace(cfg, n_layers=REC_TRAIN_LAYERS)
    trainer, res, wall, peak = _train_loop(tcfg, LM_SEQ, LM_BATCH,
                                           REC_MICRO, LM_STEPS)
    _no_launches("REC full train")
    step_s = _train_report(
        f"REC full {REC_ARCH} train, depth cut to {tcfg.n_layers} layers "
        f"{tcfg.pattern}", tcfg, trainer, res, wall, peak, LM_BATCH,
        LM_SEQ, REC_MICRO)
    mb = syn.device_batch(LM_STEPS, ShapeConfig(
        "p", seq_len=LM_SEQ, global_batch=LM_BATCH // REC_MICRO,
        kind="train"), tcfg, "cuda")
    _profile_microbatch("REC full", tcfg, trainer.state["params"], mb)
    del mb
    rec = T._layer_params(trainer.state["params"], tcfg)[0][1]["rec"]
    rec = {k: v.detach().requires_grad_(v.is_floating_point())
           for k, v in rec.items()}
    u = torch.randn(LM_BATCH // REC_MICRO, LM_SEQ, cfg.d_model,
                    device="cuda", generator=torch.Generator(
                        "cuda").manual_seed(3)).bfloat16().requires_grad_()
    fwd_ms, both_ms = _fwd_bwd_ms(lambda uu, *_: rglru.rglru_scan(rec, uu),
                                  (u, rec["w_r"], rec["w_i"], rec["lam"]))
    a, bb = (t.detach().requires_grad_() for t in rglru._gates(rec, u))
    sfwd, sboth = _fwd_bwd_ms(lambda *t: rglru.associative_scan(
        rglru._combine, t, 1)[1], (a, bb))
    n_r = tcfg.pattern.count("r")
    scan_s = REC_MICRO * n_r * (fwd_ms + both_ms) / 1e3
    log(f"REC full RG-LRU (gates + log-depth scan) of one layer and "
        f"microbatch [{LM_BATCH // REC_MICRO}, {LM_SEQ}, {cfg.d_model}]: "
        f"forward {fwd_ms:.2f} ms, forward + backward {both_ms:.2f} ms (the "
        f"scan alone {sfwd:.2f} / {sboth:.2f} ms); a step (x {REC_MICRO} "
        f"microbatches x {n_r} 'r' layers, the forward twice under remat) "
        f"{scan_s * 1e3:.0f} ms, {scan_s / step_s:.1%} of the step")
    del trainer, rec, u, a, bb
    _free()


def phase_moe_full() -> None:
    """kimi-k2-1t-a32b at its published width (d_model 7168, 64 heads of
    112 with kv 8, 384 experts of d_ff 2048, top-8, 1 shared expert,
    vocab 163840, bf16), depth cut to 1 layer (19.4e9 parameters): prefill
    1 x 4096 (max_len 4128) with the share of routed slots dropped beyond
    capacity (108 an expert), then 32 greedy decode steps; the MoE layer
    alone at the prefill's and at decode's shapes (CUDA events) against
    its bound: FLOPs at prefill, and at decode the bytes of every expert
    weight, which the capacity-4 dispatch reads for one token."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    reset_launches()
    _free()
    full = get_config(MOE_ARCH)
    shape = (full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
             full.n_experts, full.moe_d_ff, full.experts_per_token,
             full.n_shared_experts, full.vocab_size, full.dtype)
    if shape != (7168, 64, 8, 112, 384, 2048, 8, 1, 163840, "bfloat16"):
        raise AssertionError(f"not the published kimi-k2: {shape}")
    cfg = dataclasses.replace(full, n_layers=1)
    t0 = time.perf_counter()
    params = T.init_model(cfg, torch.Generator("cuda").manual_seed(0),
                          "cuda")
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in tree.leaves(params))
    log(f"MoE full {MOE_ARCH}, 1 layer: {n_params / 1e9:.4f} B params, "
        f"init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    kept = []
    route = moe.route

    def recording(*args, **kw):
        r = route(*args, **kw)
        kept.append((int(r["keep"].sum()), r["keep"].numel()))
        return r

    moe.route = recording
    try:
        served = _serve("MoE full", cfg, params, LM_SEQ)
    finally:
        moe.route = route
    # three prefills (warm-up, timed, before the profiled decodes), all
    # routed alike
    prefills = [r for r in kept if r[1] == LM_SEQ * cfg.experts_per_token]
    if len(prefills) != 3 or len(set(prefills)) != 1:
        raise AssertionError(f"MoE full: prefill routing {prefills}")
    k_slots, n_slots = prefills[0]
    pm = T._layer_params(params, cfg)[0][1]["moe"]
    gen = torch.Generator("cuda").manual_seed(4)
    for tokens in (LM_SEQ, 1):
        x = torch.randn(1, tokens, cfg.d_model, device="cuda",
                        generator=gen).bfloat16()
        with torch.no_grad():
            ms = time_ms(lambda: moe.moe_forward(pm, cfg, x), reps=5,
                         warmup=1)
        cap = moe.capacity(cfg, tokens)
        n_mats = 3
        flops = 2.0 * n_mats * cfg.n_experts * cap * cfg.d_model \
            * cfg.moe_d_ff + 2.0 * tokens * cfg.d_model * (
                cfg.n_experts + n_mats * cfg.moe_d_ff * cfg.n_shared_experts)
        nbytes = sum(a.numel() * a.element_size()
                     for a in tree.leaves(pm)) + 2 * x.numel() * 2
        bound = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        by = "FLOPs" if flops / BF16_FLOPS > nbytes / HBM_BYTES_PER_S \
            else "bytes"
        log(f"MoE full layer alone at {tokens} token(s): {ms:.3f} ms; "
            f"capacity {cap}, {flops:.4e} FLOPs (the {cfg.n_experts} x {cap}"
            f" buffer), {nbytes / 1e9:.2f} GB of weights; bound "
            f"{bound:.3f} ms (by {by}), {bound / ms:.1%} of it")
        if tokens == 1:
            log(f"MoE full decode: the layer {ms:.3f} ms of "
                f"{served['decode_ms']:.3f} ms a token ({ms / served['decode_ms']:.1%})")
        else:
            log(f"MoE full prefill: {n_slots - k_slots} of {n_slots} routed "
                f"slots dropped beyond capacity ({(n_slots - k_slots) / n_slots:.2%}); "
                f"the layer {ms:.1f} ms of the prefill's "
                f"{served['prefill_ms']:.1f} ms ({ms / served['prefill_ms']:.1%})")
    _moe_ep_one_rank(cfg, pm)
    _no_launches("MoE full")
    del params, pm, x
    _free()


# phase 4f: the dry-run's CLI processes (each default arch on each
# production layout, the Ising cells, kimi's diagnose), run on the host's
# cores beside the card's work; the archs with the most ops first
DRYRUN_FIRST = ("kimi-k2-1t-a32b", "command-r-35b",
                "llama4-maverick-400b-a17b", "nemotron-4-15b", "qwen3-4b")
DIAGNOSE = ["--arch", "kimi-k2-1t-a32b", "--shape", "train_4k",
            "--top", "10"]
SERVE_PAIRS = 10    # 4f(a): timed runs of each serving path


def _dryrun_jobs(out: Path) -> list:
    """(argv, log path) of every dry-run CLI process."""
    from repro_torch.configs import list_configs
    archs = list(DRYRUN_FIRST) + [a for a in list_configs()
                                  if a not in DRYRUN_FIRST]
    py = [sys.executable, "-m"]
    jobs = []
    for i, arch in enumerate(archs):
        for mesh in ("single", "multi"):
            jobs.append((py + ["repro_torch.launch.dryrun", "--arch", arch,
                               "--mesh", mesh, "--out",
                               str(out / f"{arch}-{mesh}.jsonl")],
                         out / f"{arch}-{mesh}.log"))
        if i == 0:
            jobs.append((py + ["repro_torch.launch.diagnose"] + DIAGNOSE,
                         out / "diagnose.log"))
    for arch in ("ising-640x128", "ising-pod"):
        jobs.append((py + ["repro_torch.launch.dryrun", "--arch", arch,
                           "--mesh", "both", "--out",
                           str(out / f"{arch}.jsonl")],
                     out / f"{arch}.log"))
    return jobs


def _run_jobs(jobs: list, workers: int, stop, done: list) -> None:
    """Run ``jobs`` at most ``workers`` at a time (CPU only: no process
    sees the card), appending (argv, return code, log path, seconds) to
    ``done``; on ``stop`` kill what runs."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    pending, running = list(jobs), []
    try:
        while (pending or running) and not stop.is_set():
            while pending and len(running) < workers:
                argv, path = pending.pop(0)
                f = open(path, "w")
                running.append((subprocess.Popen(
                    argv, stdout=f, stderr=subprocess.STDOUT, env=env,
                    cwd=str(ROOT)), argv, f, path, time.perf_counter()))
            time.sleep(0.5)
            for item in list(running):
                if item[0].poll() is not None:
                    running.remove(item)
                    item[2].close()
                    done.append((item[1], item[0].returncode, item[3],
                                 time.perf_counter() - item[4]))
    finally:
        for proc, _, f, _, _ in running:
            proc.kill()
            proc.wait()
            f.close()


def _sharded_serving(cfg, params) -> None:
    """(a): qwen3-0.6b through the sharded prefill (1 x 4096) and 32
    greedy decode steps on a one-rank NCCL grid against the unsharded
    prefill and decode of 4c, bitwise (every step's logits, the final
    states); prefill ms and decode ms a token of both, over
    ``SERVE_PAIRS`` runs of each in alternating order (median, range)."""
    import statistics
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    card = card_line()
    n_decode, max_len = 32, LM_SEQ + 32
    prompt = syn.device_batch(0, ShapeConfig(
        "p", seq_len=LM_SEQ, global_batch=1, kind="train"), cfg,
        "cuda")["tokens"]
    init_group()
    grid = mesh_lib.make_grid((1, 1), ("data", "model"), "cuda")
    rules = SH.rules_for(cfg)
    places = SH.resolve_tree(grid, T.model_specs(cfg), params, rules)
    axes, _ = SH.batch_rows(grid, rules, 1)
    sp = M.decode_state_placements(cfg, grid, 1, max_len, rules)
    fns = {"unsharded": (M.make_prefill(cfg, max_len),
                         M.make_decode_step(cfg)),
           "sharded": (M.make_sharded_prefill(cfg, grid, places, axes, sp,
                                              rules, max_len),
                       M.make_sharded_decode_step(cfg, grid, places, axes,
                                                  sp, rules))}
    for prefill, decode in fns.values():                       # warm-up
        logits, states = prefill(params, {"tokens": prompt})
        decode(params, states, {"tokens": logits.argmax(-1).int(),
                                "pos": LM_SEQ})
        del logits, states
    # u s s u u s s u ...: each side runs first as often as second
    order = [("unsharded", "sharded")[(i + 1) // 2 % 2]
             for i in range(2 * SERVE_PAIRS)]
    ms = {name: ([], []) for name in fns}
    first = None
    for name in order:
        prefill, decode = fns[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, states = prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        ms[name][0].append((time.perf_counter() - t0) * 1e3)
        seen = [logits]
        tok = logits.argmax(-1).int()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(LM_SEQ, LM_SEQ + n_decode):
            logits, states = decode(params, states,
                                    {"tokens": tok, "pos": pos})
            tok = logits.argmax(-1).int()
            seen.append(logits)
        torch.cuda.synchronize()
        ms[name][1].append((time.perf_counter() - t0) * 1e3 / n_decode)
        seen += tree.leaves(states)
        if first is None:
            first = seen
        elif not all(torch.equal(a, b) for a, b in zip(first, seen)):
            raise AssertionError(f"4f sharded serving: a {name} run's "
                                 "logits or states differ from the first "
                                 "unsharded run's")
        del logits, states, seen

    def stat(xs, fmt):
        return (f"{statistics.median(xs):{fmt}} ({min(xs):{fmt}}-"
                f"{max(xs):{fmt}})")
    log(f"4f sharded serving {LM_ARCH} on a one-rank NCCL grid ({card}): "
        f"prefill 1 x {LM_SEQ} and {n_decode} greedy decode steps == the "
        f"unsharded ones, bitwise (every step's logits, the final states); "
        f"{SERVE_PAIRS} runs of each, order {' '.join(n[0] for n in order)}"
        f", median (min-max): prefill {stat(ms['sharded'][0], '.1f')} ms "
        f"(unsharded {stat(ms['unsharded'][0], '.1f')}), decode "
        f"{stat(ms['sharded'][1], '.3f')} ms a token (unsharded "
        f"{stat(ms['unsharded'][1], '.3f')}); runs in order: sharded "
        f"{[round(x, 3) for x in ms['sharded'][1]]}, unsharded "
        f"{[round(x, 3) for x in ms['unsharded'][1]]}")
    dist.destroy_process_group()


def _meta_step_count(cfg, micro: int):
    """The ``meta`` count of ``cfg``'s train step at seq 4096, batch 8 in
    ``micro`` microbatches, on a rankless 1 x 1 layout."""
    from repro_torch.analysis import op_cost as OC
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun_lib as lib
    from repro_torch.launch import mesh as mesh_lib
    grid = mesh_lib.rankless_grid(mesh_lib.Layout((1, 1), ("data",
                                                           "model")))
    fn, args = lib.build_train_cell(cfg, ShapeConfig(
        "4c", seq_len=LM_SEQ, global_batch=LM_BATCH, kind="train"), grid,
        micro)
    return OC.count(fn, *args, records=grid.records)[1]


def _card_vs_meta(cfg, ocfg):
    """(b): the op counter around one real train step of 4c on the card
    against the meta count of the same step; returns the card's counter."""
    import torch
    from repro_torch.analysis import op_cost as OC
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.train import train_step as TS
    card = card_line()
    gen = torch.Generator("cuda").manual_seed(0)
    state = TS.init_train_state(cfg, ocfg, gen, "cuda")
    batch = syn.device_batch(0, ShapeConfig(
        "4c", seq_len=LM_SEQ, global_batch=LM_BATCH, kind="train"), cfg,
        "cuda")
    step = TS.make_train_step(cfg, ocfg, LM_MICRO)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    counter = OC.OpCounter((state, batch))
    with counter:
        out = step(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    alloc_peak = torch.cuda.max_memory_allocated()
    mem = counter.memory(out)
    del state, batch, out
    _free()
    t0 = time.perf_counter()
    meta = _meta_step_count(cfg, LM_MICRO)
    meta_s = time.perf_counter() - t0
    names = sorted(set(counter.per_op) | set(meta.per_op))
    diff = {n: (counter.per_op.get(n), meta.per_op.get(n)) for n in names
            if counter.per_op.get(n) != meta.per_op.get(n)}
    n_ops = sum(v[0] for v in counter.per_op.values())
    log(f"4f card vs meta ({card}): one {LM_ARCH} train step (seq "
        f"{LM_SEQ}, batch {LM_BATCH} in {LM_MICRO}) counted on the card "
        f"({wall:.1f} s under the counter) and on meta, 1 x 1 layout "
        f"({meta_s:.1f} s): {n_ops} ops of {len(counter.per_op)} kinds on "
        f"the card, {sum(v[0] for v in meta.per_op.values())} on meta; "
        f"FLOPs {counter.flops:.6e} / {meta.flops:.6e}, bytes "
        f"{counter.bytes:.6e} / {meta.bytes:.6e}, matmul FLOPs by type "
        f"{counter.matmul_flops} / {meta.matmul_flops}; tracked peak "
        f"{mem['peak_gb']:.3f} GB on the card, "
        f"{(meta.argument_bytes + meta.peak_bytes) / 1e9:.3f} GB on meta, "
        f"torch.cuda.max_memory_allocated "
        f"{alloc_peak / 1e9:.3f} GB")
    # the port picks no op by device but layers.matmul_f32, which takes
    # the card's form on meta too: any difference is a fault to explain
    for n, (c, m) in diff.items():
        log(f"  differs: {n}: card [count, FLOPs, bytes] {c}, meta {m}")
    if diff:
        raise AssertionError(f"4f card vs meta: {sorted(diff)} differ")
    log("  every op's count, FLOPs and bytes: equal")
    return counter


# 4f(f): one rank's share of a production tensor-parallel train step:
# arch -> (ms of the same step in PR 20's final call on an H100 at 700 W,
# or None, and whether its gathers' gradients are reduce-scattered);
# qwen2-vl-7b carries its batch over "model" too, so every weight block
# is gathered and its gradient reduce-scattered over the model ring
SHARES = {"qwen3-4b": (8223.3, False), "qwen2-vl-7b": (None, True)}
SHARE_SHAPE, SHARE_RANK = "train_4k", 0


def _rank_share_on_card(arch: str) -> None:
    """(f): rank ``SHARE_RANK`` of the 16 x 16 layout on the card, through
    the dry-run's own cell (``dryrun_lib.build_train_cell``): the same
    rankless grid on ``cuda``, its ``meta`` blocks made real (small
    seeded values, token ids 0). Nothing is sent, so the values are not a
    real rank's and are only checked finite; the op count must equal the
    ``meta`` count of the same rank op for op, and the collectives the
    ``meta`` rank's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tree
    from repro_torch.analysis import collectives as CL
    from repro_torch.analysis import op_cost as OC
    from repro_torch.analysis import roofline as RL
    from repro_torch.configs import get_config
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.launch import dryrun_lib as lib
    from repro_torch.launch import mesh as mesh_lib
    card = card_line()
    cfg, shape = get_config(arch), LM_SHAPES[SHARE_SHAPE]
    pr20_ms, scatters = SHARES[arch]
    layout = mesh_lib.production_layout()
    micro = lib.MICROBATCHES[arch]
    t0 = time.perf_counter()
    meta_grid = mesh_lib.rankless_grid(layout, SHARE_RANK)
    fn, args = lib.build_train_cell(cfg, shape, meta_grid, micro)
    _, meta = OC.count(fn, *args, records=meta_grid.records)
    meta_s = time.perf_counter() - t0
    rl = RL.from_cost(meta.cost(), math.prod(layout.shape),
                      RL.lm_model_flops(cfg, shape))
    grid = mesh_lib.rankless_grid(layout, SHARE_RANK, "cuda")
    fn, args = lib.build_train_cell(cfg, shape, grid, micro)
    gen = torch.Generator("cuda").manual_seed(0)

    def real(x):
        if not isinstance(x, torch.Tensor):
            return x
        if not x.is_meta:
            return x.to("cuda")
        if x.dtype.is_floating_point:   # >= 0: second moments are
            return (torch.randn(x.shape, generator=gen, device="cuda")
                    .abs_() * 0.02).to(x.dtype)
        return torch.zeros(x.shape, dtype=x.dtype, device="cuda")

    args = tree.map(real, list(args))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter = OC.OpCounter(args, records=grid.records)
    with counter:
        out = fn(*args)
    torch.cuda.synchronize()
    alloc_peak = torch.cuda.max_memory_allocated()
    mem = counter.memory(out)
    finite = all(bool(torch.isfinite(t).all()) for t in tree.leaves(out)
                 if t.dtype.is_floating_point)
    del out
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        del out
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t1
    del out
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    launched = sum(e.count for e in events)
    names = sorted(set(counter.per_op) | set(meta.per_op))
    diff = {n: (counter.per_op.get(n), meta.per_op.get(n)) for n in names
            if counter.per_op.get(n) != meta.per_op.get(n)}
    n_ops = sum(v[0] for v in counter.per_op.values())
    ms = sorted(times)[1] * 1e3

    def by_kind(colls):
        wire = CL.collective_summary(colls)["by_kind"]
        return {k: (sum(c.kind == k for c in colls), f"{wire[k] / 1e9:.3f}")
                for k in sorted(wire)}
    log(f"4f rank share {arch} collectives ({card}): by kind (count, "
        f"wire GB) {by_kind(counter.collectives)} on the card, "
        f"{by_kind(meta.collectives)} on meta")
    log(f"4f rank share ({card}): rank {SHARE_RANK} of 16 x 16 "
        f"{SHARE_SHAPE} {arch} ({micro} microbatches; meta count "
        f"{meta_s:.1f} s): {n_ops} ops of {len(counter.per_op)} kinds on "
        f"the card, {sum(v[0] for v in meta.per_op.values())} on meta; "
        f"FLOPs {counter.flops:.6e} / {meta.flops:.6e}, bytes "
        f"{counter.bytes:.6e} / {meta.bytes:.6e}; collectives recorded "
        f"{len(counter.collectives)} / {len(meta.collectives)}; "
        f"finite: {finite}; one step {ms:.1f} ms (median of 3: "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)}; PR 20 "
        f"{pr20_ms or 'not measured'} ms) against its "
        f"roofline {rl.step_time_s * 1e3:.1f} ms (compute "
        f"{rl.compute_s * 1e3:.1f}, memory {rl.memory_s * 1e3:.1f}, "
        f"collective {rl.collective_s * 1e3:.1f}: {rl.dominant}), "
        f"{ms / 1e3 / rl.step_time_s:.2f}x; without the collectives' "
        f"{rl.collective_s * 1e3:.1f} ms, "
        f"{ms / 1e3 / max(rl.compute_s, rl.memory_s):.2f}x the larger of "
        f"compute and memory; tracked peak {mem['peak_gb']:.3f} GB on the "
        f"card, {(meta.argument_bytes + meta.peak_bytes) / 1e9:.3f} GB on "
        f"meta, torch.cuda.max_memory_allocated {alloc_peak / 1e9:.3f} GB; "
        f"one step under the profiler: {prof_s * 1e3:.1f} ms wall, "
        f"{launched} kernels, device busy {busy * 1e3:.1f} ms "
        f"({busy / prof_s:.1%}), {n_ops / (ms / 1e3) / 1e3:.1f}k ops a "
        f"second unprofiled")
    for n, (c, m) in diff.items():
        log(f"  differs: {n}: card [count, FLOPs, bytes] {c}, meta {m}")
    if diff:
        raise AssertionError(f"4f rank share: {sorted(diff)} differ")
    if counter.collectives != meta.collectives:
        raise AssertionError("4f rank share: the card's collectives differ "
                             "from the meta rank's")
    if any(c.kind == "reduce-scatter"
           for c in counter.collectives) != scatters:
        raise AssertionError(f"4f rank share {arch}: reduce-scatters "
                             f"recorded: {not scatters}, expected "
                             f"{scatters}")
    if not finite:
        raise AssertionError("4f rank share: a result is not finite")
    log("  every op's count, FLOPs and bytes: equal")
    del args, counter
    _free()


def _roofline_line(label: str, cfg, counter, step_s: float) -> None:
    """(c): a measured step beside its roofline step time."""
    from repro_torch.analysis import roofline as RL
    from repro_torch.configs.base import ShapeConfig
    rl = RL.from_cost(counter.cost(), 1, RL.lm_model_flops(cfg, ShapeConfig(
        "4c", seq_len=LM_SEQ, global_batch=LM_BATCH, kind="train")))
    log(f"4f roofline {label} ({card_line()}): measured {step_s * 1e3:.1f} "
        f"ms a step; roofline {rl.step_time_s * 1e3:.1f} ms (compute "
        f"{rl.compute_s * 1e3:.1f}: matmul FLOPs by type "
        f"{ {k: f'{v:.4e}' for k, v in counter.matmul_flops.items()} }, "
        f"other {counter.flops - sum(counter.matmul_flops.values()):.4e}; "
        f"memory {rl.memory_s * 1e3:.1f}: {counter.bytes:.4e} bytes; "
        f"collective {rl.collective_s * 1e3:.1f}), {rl.dominant} dominates; "
        f"the eager step takes {step_s / rl.step_time_s:.2f}x its roofline "
        f"time; model FLOPs {rl.model_flops:.4e}, MFU at the roofline "
        f"{rl.mfu:.2%}")


def _dryrun_table(out: Path, done: list) -> None:
    """(d), (e): every default cell [OK] or the reference's [SKIP], the
    per-rank table, and kimi's diagnose."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.launch import dryrun_lib as lib
    bad = [(argv, rc, path) for argv, rc, path, _ in done if rc]
    for argv, rc, path in bad:
        log(f"4f dry-run: {' '.join(argv[2:])} exited {rc}:\n"
            f"{Path(path).read_text()[-3000:]}")
    if bad:
        raise AssertionError(f"4f dry-run: {len(bad)} processes failed")
    recs = {}
    for path in sorted(out.glob("*.jsonl")):
        for line in path.read_text().splitlines():
            r = json.loads(line)
            recs[(r["arch"], r["shape"], r["mesh"])] = r
    want = [(a, s, m) for a, s in lib.default_cells()
            for m in ("pod-16x16", "pods-2x16x16")]
    missing = [k for k in want if k not in recs]
    if missing:
        raise AssertionError(f"4f dry-run: no record of {missing}")
    log(f"4f dry-run ({card_line()}): {len(want)} cells in "
        f"{len(done)} CLI processes, "
        f"{max(t for *_, t in done):.1f} s the longest; per rank:")
    log(f"  {'arch':26s} {'shape':12s} {'layout':13s} {'trace_s':>8s} "
        f"{'peak_gb':>10s} {'fits':>5s} {'dominant':>10s} {'mfu':>9s} "
        f"{'TFLOP':>10s} {'HBM GB':>10s} {'wire GB':>9s}  wire GB by kind")
    for a, sh, m in want:
        r = recs[(a, sh, m)]
        if r.get("skipped"):
            reason = lib.skip_reason(get_config(a), LM_SHAPES[sh])
            if r["reason"] != reason:
                raise AssertionError(f"4f dry-run: {a} {sh} skipped: "
                                     f"{r['reason']}")
            log(f"  {a:26s} {sh:12s} {m:13s} [SKIP] {reason[:40]}")
            continue
        if not r["ok"]:
            raise AssertionError(f"4f dry-run: {a} {sh} {m} failed: "
                                 f"{r.get('error')}")
        rl, mem = r["roofline"], r["memory"]
        log(f"  {a:26s} {sh:12s} {m:13s} {r['trace_s']:8.2f} "
            f"{mem['peak_gb']:10.2f} {str(r['fits']):>5s} "
            f"{rl['dominant']:>10s} {rl['mfu']:9.4%} "
            f"{rl['flops_per_device'] / 1e12:10.2f} "
            f"{rl['hbm_bytes_per_device'] / 1e9:10.1f} "
            f"{rl['wire_bytes_per_device'] / 1e9:9.2f}  "
            + " ".join(f"{k} {v / 1e9:.2f}"
                       for k, v in sorted(rl["coll_by_kind"].items())))
    log("4f diagnose --arch kimi-k2-1t-a32b --shape train_4k --top 10:")
    for line in (out / "diagnose.log").read_text().splitlines():
        log(f"  {line}")


def phase_dryrun(qwen_step_s: float, ssm_step_s: float) -> None:
    """Phase 4f (no kernel): (a) the sharded serving path on one NCCL
    rank, then, while the dry-run's CLI processes run on the host's other
    cores, (b) the op counter on the card against meta, (c) 4c's and
    4d's steps beside their roofline and (f) one rank's share of two
    production tensor-parallel steps on the card; then (d) the dry-run's
    per-rank table and (e) kimi's diagnose. Every kernel count stays 0."""
    import os
    import threading
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    reset_launches()
    _free()
    cfg = get_config(LM_ARCH)
    gen = torch.Generator("cuda").manual_seed(0)
    params = T.init_model(cfg, gen, "cuda")
    _sharded_serving(cfg, params)
    del params
    _free()
    out = ROOT / "build" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    for old in out.glob("*"):
        old.unlink()
    jobs = _dryrun_jobs(out)
    workers = max(1, min(6, (os.cpu_count() or 2) - 2))
    stop, done = threading.Event(), []
    runner = threading.Thread(target=_run_jobs,
                              args=(jobs, workers, stop, done))
    t0 = time.perf_counter()
    runner.start()
    try:
        counter = _card_vs_meta(cfg, opt.OptimizerConfig(kind=cfg.optimizer))
        _roofline_line(f"{LM_ARCH} (4c)", cfg, counter, qwen_step_s)
        del counter
        ssm = get_config(SSM_ARCH)
        _roofline_line(f"{SSM_ARCH} (4d, the meta count)", ssm,
                       _meta_step_count(ssm, LM_MICRO), ssm_step_s)
        for arch in SHARES:
            _rank_share_on_card(arch)
        runner.join()
    finally:
        stop.set()
        runner.join()
    log(f"4f dry-run processes ({workers} at a time): "
        f"{time.perf_counter() - t0:.1f} s wall")
    if len(done) != len(jobs):
        raise AssertionError(f"4f dry-run: {len(done)} of {len(jobs)} "
                             "processes ended")
    _dryrun_table(out, done)
    _no_launches("4f dry-run, counter and sharded serving")


def sm_clock_hz() -> float:
    """The SM clock the card may run at (``clocks.max.sm``), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.split()[0]) * 1e6


def keyed_sass(name: str) -> dict:
    """A diagnostic beside the keyed bound: the instructions of the longest
    loop (a backward branch to its target) in ``cuobjdump -sass`` of the
    keyed kernel at the main path's instantiation (bs 128, bf16, colour 0),
    whose trips each update 2 x 8 sites; None where it is not found."""
    import shutil
    from repro_torch.kernels import build
    lib, halo = (("checkerboard_tiles", "TileHalo")
                 if name == "update_color_tiles_keyed"
                 else ("checkerboard_lines", "LineHalo"))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(build.library_path(lib))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    want = f"__nv_bfloat16Li128ELi0ELb1ENS_8{halo}"
    body = text.split("Function : ")
    func = next((f for f in body if f.startswith("_ZN5ising14half_sweep_vec")
                 and want in f.split(None, 1)[0]), None)
    if func is None:
        return None
    ins = [(int(a, 16), op) for a, op in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", func)]
    labels = {k: int(a, 16) for k, a in re.findall(
        r"(\.L_x_\d+):(?=(?:\s*\.L_x_\d+:)*\s*/\*([0-9a-f]{4,})\*/)", func)}
    best = []
    for addr, op in ins:
        m = re.search(r"\bBRA\b.*?(?:\((\.L_x_\d+)\)|0x([0-9a-f]+))", op)
        target = (addr + 1 if not m else int(m.group(2), 16) if m.group(2)
                  else labels.get(m.group(1), addr + 1))
        loop = [o for a, o in ins if target <= a <= addr]
        if len(loop) > len(best):
            best = loop
    opcodes = {}
    for op in best:
        code = re.sub(r"^@!?U?P\w+\s+", "", op).split()[0]
        opcodes[code] = opcodes.get(code, 0) + 1
    return dict(function=func.split(None, 1)[0], per_site=len(best) / 16,
                opcodes=opcodes)


def bound(name: str, qb, bits, clock_hz=None, sms=None) -> tuple:
    """(bound_ms, bound_by) of one launch: each input read once, each
    output written once, against the HBM rate; and the operations, against
    the card's rate for them: about 10 f32 operations per site for an
    operand form, the benchmark's ``work.site_clocks()`` per site for a
    keyed form."""
    from perfbench.work import site_clocks
    nq = qb[0].numel()
    e = qb.element_size()
    moved = 4 * nq * e + 2 * nq * e
    if not KERNELS[name]["keyed"]:
        moved += bits.numel() * bits.element_size()
    if name.startswith("update_color_lines"):
        _, mr, mc, bs, _ = qb.shape
        moved += 4 * mr * mc * bs * e
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    if KERNELS[name]["keyed"]:
        clocks = site_clocks()
        t_ops = 2 * nq * clocks / (sms * clock_hz) * 1e3
    else:
        t_ops = 2 * nq * FLOPS_PER_SITE / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed_run(backend: str, measure: bool, sweeps: int) -> float:
    """Seconds of a synchronised ``IsingEngine.run`` at 20480^2 after a
    warm-up run of one sweep."""
    import torch
    from repro_torch import random as jr
    from repro_torch.api import EngineConfig, IsingEngine
    cfg = EngineConfig(size=SIZE, beta=BETA, n_sweeps=sweeps,
                       backend=backend, hot=True, measure=measure,
                       block_size=BS)
    eng = IsingEngine(cfg)
    state = eng.init(jr.PRNGKey(5))
    IsingEngine(dataclasses.replace(cfg, n_sweeps=1)).run(state,
                                                          jr.PRNGKey(4))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(state, jr.PRNGKey(6))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_fold_in_timing(errs: dict, launches: dict, clock_hz: float,
                         sms: int) -> dict:
    """The fold-in kernel at the Swendsen-Wang cells' shape (one bond
    hash: 5120^2 counters under one key) against its bound and its eager
    form; the bound is bytes (4 in and 4 out a counter) or integer issue
    (``FOLD_*`` a counter), whichever is larger."""
    from perfbench.work import INT_PER_CLOCK, ISSUE_PER_CLOCK
    from repro_torch import random as jr
    from repro_torch.cluster import bonds as B
    from repro_torch.kernels import rng
    n = SW_SIZE * SW_SIZE
    key = jr.fold_in(jr.PRNGKey(53), 0)
    c = B.global_index(SW_SIZE, SW_SIZE, device="cuda") * 2
    _fold_in_equals_eager(f"{SW_SIZE}^2 timed counters", key, c, errs)
    ms = time_ms(lambda: rng.fold_in_bits(key, c), reps=50)
    eager_ms = time_ms(lambda: jr._fold_in_bits_eager(key, c), reps=3,
                       warmup=1)
    t_bytes = n * 8 / HBM_BYTES_PER_S * 1e3
    clocks = max(FOLD_ALU_ONLY / INT_PER_CLOCK,
                 (FOLD_ALU_ONLY + FOLD_ADDS) / ISSUE_PER_CLOCK)
    t_ops = n * clocks / (sms * clock_hz) * 1e3
    b_ms, b_by = max((t_bytes, "bytes"), (t_ops, "integer issue"))
    keys = [jr.fold_in(key, i) for i in range(16)]
    rows = jr.shared(keys, B.global_index(4096, 4096, device="cuda"))
    rows_ms = time_ms(lambda: rng.fold_in_bits(keys, rows), reps=10)
    del c, rows
    log(f"time fold_in_bits {SW_SIZE}^2: {ms:.4f} ms per launch, bound "
        f"{b_ms:.4f} ms ({b_by}; bytes {t_bytes:.4f}, integer issue "
        f"{t_ops:.4f}), {b_ms / ms:.1%} of bound; eager form "
        f"{eager_ms:.3f} ms; 16 x 4096^2 shared rows {rows_ms:.4f} ms")
    return dict(
        name="fold_in_bits", route="cuda", source=FOLD_CU, replaces=None,
        launches=launches["fold_in_bits"], max_abs_err=errs["fold_in_bits"],
        ms=ms, plain_ms=eager_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None)


def phase_draw_timing(errs: dict, launches: dict, clock_hz: float,
                      sms: int) -> dict:
    """The draw kernel at the launcher's colour draw (bf16 uniforms under
    one key) against its bound and its eager form, and beside it f32
    uniforms under a 16-key batch and randint at the same shape; the bound
    is integer issue (``DRAW_*`` a word) or bytes (the output written
    once), whichever is larger."""
    import torch
    from perfbench.work import INT_PER_CLOCK, ISSUE_PER_CLOCK
    from repro_torch import random as jr
    from repro_torch.kernels import rng
    n = math.prod(DRAW_SHAPE)
    key = jr.fold_in(jr.PRNGKey(63), 0)
    _draw_equals_eager(
        "timed bf16", lambda: jr.uniform(key, DRAW_SHAPE, torch.bfloat16,
                                         "cuda"),
        lambda: jr._draw_eager(key, DRAW_SHAPE, torch.bfloat16, "cuda"), n,
        errs)
    clocks = max(DRAW_ALU_ONLY / INT_PER_CLOCK,
                 (DRAW_ALU_ONLY + DRAW_ADDS) / ISSUE_PER_CLOCK)

    def bound(words, nbytes):
        return max((words * clocks / (sms * clock_hz) * 1e3,
                    "integer issue"),
                   (words * nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))

    ms = time_ms(lambda: rng.draw(key, DRAW_SHAPE, torch.bfloat16, "cuda"),
                 reps=50)
    eager_ms = time_ms(lambda: jr._draw_eager(key, DRAW_SHAPE,
                                              torch.bfloat16, "cuda"),
                       reps=3, warmup=1)
    b_ms, b_by = bound(n, 2)
    keys = [jr.fold_in(key, i) for i in range(16)]
    f32_ms = time_ms(lambda: rng.draw(keys, DRAW_SHAPE, torch.float32,
                                      "cuda"), reps=10)
    f32_bound = bound(16 * n, 4)[0]
    int_ms = time_ms(lambda: rng.draw(key, DRAW_SHAPE, torch.int32, "cuda",
                                      (-3, 4)), reps=20)
    int_bound = bound(2 * n, 4)[0]
    log(f"time draw bf16 {list(DRAW_SHAPE)}: {ms:.4f} ms per launch, bound "
        f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound; eager form "
        f"{eager_ms:.3f} ms; f32 16 keys {f32_ms:.4f} ms "
        f"({f32_bound / f32_ms:.1%} of {f32_bound:.4f}); randint [-3, 4) "
        f"{int_ms:.4f} ms (two hashes a word and three remainders: "
        f"{int_bound / int_ms:.1%} of {int_bound:.4f})")
    return dict(
        name="threefry_draw", route="cuda", source=DRAW_CU, replaces=None,
        launches=launches["threefry_draw"], max_abs_err=errs["threefry_draw"],
        ms=ms, plain_ms=eager_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, f32_batch16_ms=f32_ms, randint_ms=int_ms)


def phase_flip_timing(errs: dict, launches: dict) -> dict:
    """The flip kernel at a quad of the launcher's colour update (bf16
    spins and uniforms, T_c), written in place, against its byte bound
    (the spin, its sum and its uniform read and the spin written: 8 B a
    site) and the eager LUT chain with its copy into the stack."""
    import torch
    from repro_torch.core import update_rules as rules
    from repro_torch.kernels import flip as kflip
    bf16 = torch.bfloat16
    sigma, nn, probs = flip_inputs(74, bf16, bf16)
    work = sigma.clone()
    _flip_equals_eager("timed bf16 in place", work, nn, probs, errs,
                       out=work)
    del work
    table = kflip.lut_table(BETA, bf16)
    n = math.prod(FLIP_SHAPE)
    bound_ms = n * 8 / HBM_BYTES_PER_S * 1e3
    ms = time_ms(lambda: kflip.flip_lut(sigma, nn, probs, table, out=sigma),
                 reps=50)
    rule = rules.get_rule("lut")
    eager_ms = time_ms(lambda: sigma.copy_(rule.flip_probs(sigma, nn, probs,
                                                           BETA)), reps=10)
    del sigma, nn, probs
    log(f"time flip_lut bf16 {list(FLIP_SHAPE)}: {ms:.4f} ms per launch, "
        f"bound {bound_ms:.4f} ms (bytes, 8 B a site), "
        f"{bound_ms / ms:.1%} of bound; eager chain and copy {eager_ms:.3f} "
        "ms")
    return dict(
        name="flip_lut", route="cuda", source=FLIP_CU, replaces=None,
        launches=launches["flip_lut"], max_abs_err=errs["flip_lut"], ms=ms,
        plain_ms=eager_ms, bound_ms=bound_ms, bound_by="bytes",
        library_ms=None)


def phase_label_timing(errs: dict, launches: dict) -> dict:
    """The label kernel at the Swendsen-Wang cells' shape, on FK bonds at
    each cell's beta, against its byte bound (the two masks read and the
    labels written once) and the plain propagation run to its fixed
    point on the same masks."""
    from repro_torch.cluster import label as LBL
    from repro_torch.kernels import label as K
    n = SW_SIZE * SW_SIZE
    bound_ms = n * (1 + 1 + 4) / HBM_BYTES_PER_S * 1e3
    rows = {}
    for cell, beta in SW_BETAS.items():
        br, bd = sw_bonds(beta)
        iters = _label_equals_plain(f"{SW_SIZE}^2 {cell} timed", br, bd, errs)
        ms = time_ms(lambda: K.label_components(br, bd), reps=50)
        plain_ms = time_ms(lambda: LBL.propagate(br, bd), reps=3, warmup=1)
        rows[cell] = (ms, plain_ms)
        log(f"time label_components {SW_SIZE}^2 {cell} (beta {beta}): "
            f"{ms:.4f} ms per launch, bound {bound_ms:.4f} ms (bytes: 2 "
            f"masks of 1 B and labels of 4 B a site), {bound_ms / ms:.1%} "
            f"of bound; plain propagation {plain_ms:.3f} ms ({iters} "
            "iterations)")
        del br, bd
    ms, plain_ms = rows["sw-near-critical"]
    return dict(
        name="label_components", route="cuda", source=LABEL_CU,
        replaces=None, launches=launches["label_components"],
        max_abs_err=errs["label_components"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes", library_ms=None,
        hot_ms=rows["sw-hot"][0], hot_plain_ms=rows["sw-hot"][1])


def phase_timing(launches: dict, errs: dict, sweeps: int = 20) -> tuple:
    import torch
    from perfbench.work import SITE_ADDS, SITE_F32, SITE_INT_ONLY, site_clocks
    from repro_torch import random as jr
    from repro_torch.core import measure
    from repro_torch.kernels import checkerboard as kern
    from repro_torch.kernels import measure as kmeasure
    from repro_torch.kernels import ops
    mr = mc = SIZE // 2 // BS
    qb, bits = blocked_state(7, mr, mc, BS, torch.bfloat16, "cuda")
    key = jr.fold_in(jr.PRNGKey(7), 3)
    clock_hz = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    records = []
    for name, (fn, plain, keyed) in kernel_fns().items():
        arg = key if keyed else bits
        # the kernel at the main path's shape, once more against its plain
        # version before it is timed
        got = fn(qb.clone(), arg, BETA, 0)
        want = plain(qb.clone(), arg, BETA, 0)
        errs[name] = max(errs[name], exact_diff(got, want))
        if errs[name]:
            raise AssertionError(f"{name} != plain at full size")
        del got, want
        work = qb.clone()
        kw, call_ms = {}, None
        if name.startswith("update_color_lines"):
            # the kernel alone: its four halo lines made once, outside the
            # timed launches (a colour-0 edge provider of cached lines);
            # the wrapper's own line making is timed beside it
            cached = dict(zip(("north", "west", "south", "east"),
                              kern._lines(qb, 0)))
            kw = dict(edges=lambda xb, side: cached[side])
            call_ms = time_ms(lambda: fn(work, arg, BETA, 0), reps=20)
        ms = time_ms(lambda: fn(work, arg, BETA, 0, **kw), reps=50)
        plain_ms = time_ms(lambda: plain(work, arg, BETA, 0), reps=3,
                           warmup=1)
        b_ms, b_by = bound(name, qb, bits, clock_hz, sms)
        del work
        records.append(dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=launches[name],
            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None))
        log(f"time {name}: {ms:.4f} ms per launch, bound {b_ms:.4f} ms "
            f"({b_by}), {b_ms / ms:.1%} of bound; plain {plain_ms:.3f} ms; "
            f"{qb[0].numel() * 2 / ms / 1e6:.1f} flips/ns"
            + (f"; the wrapper with its halo lines {call_ms:.4f} ms"
               if call_ms else ""))
        if keyed:
            sass = keyed_sass(name)
            log(f"  bound per site: {SITE_INT_ONLY} ALU-only, {SITE_ADDS} "
                f"adds, {SITE_F32} f32 -> {site_clocks()} SM clocks at "
                f"{clock_hz / 1e6:.0f} MHz x {sms} SMs; SASS " + (
                    f"{sass['function']}: row loop {sass['per_site']:.4f} "
                    f"instructions per site, per 16 sites {sass['opcodes']}"
                    if sass else "row loop not found"))
    reset_launches()
    bits_ms = time_ms(lambda: ops.color_bits(key, 0, 0, qb.shape[1:],
                                             "cuda"), reps=3, warmup=1)
    # the measurement kernel: its bound is bytes, each spin read once
    got = kmeasure.blocked_totals(qb)
    want = kmeasure.blocked_totals_plain(qb)
    errs["blocked_totals"] = max(errs["blocked_totals"],
                                 float((got - want).abs().max()))
    if errs["blocked_totals"]:
        raise AssertionError("blocked_totals != plain at full size")
    del got, want
    totals_ms = time_ms(lambda: kmeasure.blocked_totals(qb), reps=50)
    totals_plain_ms = time_ms(lambda: kmeasure.blocked_totals_plain(qb),
                              reps=3, warmup=1)
    totals_bound_ms = qb.numel() * qb.element_size() / HBM_BYTES_PER_S * 1e3
    stats_ms = time_ms(lambda: measure.blocked_stats(qb), reps=20)
    fold = phase_fold_in_timing(errs, launches, clock_hz, sms)
    records.append(dict(
        name="blocked_totals", route="cuda", source=TOTALS_CU,
        replaces=None, launches=launches["blocked_totals"],
        max_abs_err=errs["blocked_totals"], ms=totals_ms,
        plain_ms=totals_plain_ms, bound_ms=totals_bound_ms, bound_by="bytes",
        library_ms=None))
    log(f"time color_bits [2, {mr}, {mc}, {BS}, {BS}]: {bits_ms:.3f} ms per "
        f"colour; blocked_totals {totals_ms:.4f} ms, bound "
        f"{totals_bound_ms:.4f} ms (bytes, 2 B a site), "
        f"{totals_bound_ms / totals_ms:.1%} of bound; plain "
        f"{totals_plain_ms:.3f} ms; blocked_stats (the kernel, its f32 "
        f"sums and means): {stats_ms:.4f} ms per sweep")
    records.append(fold)
    records.append(phase_label_timing(errs, launches))
    records.append(phase_draw_timing(errs, launches, clock_hz, sms))
    records.append(phase_flip_timing(errs, launches))
    del qb, bits
    runs = {}
    for backend, (keyed, _) in BACKENDS.items():
        for measured in (False, True):
            reset_launches()
            seconds = _timed_run(backend, measured, sweeps)
            _read_launches(f"timed {backend}", {
                keyed: 2 * (sweeps + 1),
                "blocked_totals": sweeps + 1 if measured else 0})
            runs[backend, measured] = seconds
            log(f"time {'measured' if measured else 'measurement-free'} "
                f"{backend} run {SIZE}^2 x {sweeps} sweeps: {seconds:.4f} s,"
                f" {seconds / sweeps * 1e3:.3f} ms per sweep, "
                f"{sweeps * SIZE ** 2 / seconds / 1e9:.4f} flips/ns end to "
                "end")
    return records, dict(bits_ms=bits_ms, totals_ms=totals_ms,
                         stats_ms=stats_ms, runs=runs)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    global HBM_BYTES_PER_S, F32_FLOPS, BF16_FLOPS
    from repro_torch.analysis import roofline as RL
    HBM_BYTES_PER_S, F32_FLOPS, BF16_FLOPS = (RL.HBM_BW, RL.F32_FLOPS,
                                              RL.BF16_FLOPS)
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    names = (*KERNELS, "blocked_totals", "fold_in_bits", "label_components",
             "threefry_draw", "flip_lut")
    errs = {name: 0.0 for name in names}
    launches = {name: 0 for name in names}
    phase_kernels_vs_plain(errs)
    phase_fold_in(errs, launches)
    phase_label(errs, launches)
    phase_draw(errs, launches)
    phase_flip(errs, launches)
    phase_main_path(launches)
    phase_small_and_chain()
    t_lm = time.perf_counter()
    twin, ssm_step_s = {}, 0.0
    for phase in (phase_algorithm1, phase_rbg, phase_lm_small,
                  phase_lm_scores, phase_lm_full, phase_lm_sharded,
                  phase_lm_small_families, phase_ssm_full, phase_rec_full,
                  phase_moe_full, phase_dryrun):
        t0 = time.perf_counter()
        if phase is phase_lm_full:
            twin = phase()
        elif phase is phase_lm_sharded:
            phase(twin)
        elif phase is phase_ssm_full:
            ssm_step_s = phase()
        elif phase is phase_dryrun:
            phase(twin["step_s"], ssm_step_s)
        else:
            phase()
        log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    log(f"Algorithm 1, rbg and LM phases: {time.perf_counter() - t_lm:.1f} s")
    t_new = time.perf_counter()
    phase_scenarios_small()
    twins = phase_scenarios_full()
    phase_rng_shares(twins)
    phase_replica_stack()
    phase_cluster_breakdown()
    log(f"single-device scenario phases: {time.perf_counter() - t_new:.1f} s")
    t_grid = time.perf_counter()
    phase_grid_small()
    phase_lines_halo(errs)
    t_serve = time.perf_counter()
    phase_serve_small()
    phase_serve_full()
    log(f"serve phases: {time.perf_counter() - t_serve:.1f} s")
    init_group()
    phase_grid_full()
    phase_grid_cluster_full(twins)
    phase_mesh3d_full()
    phase_launcher()
    log(f"grid phases: {time.perf_counter() - t_grid:.1f} s")
    records, _ = phase_timing(launches, errs)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    import torch.distributed as dist
    dist.destroy_process_group()
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
