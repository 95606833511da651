#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py            # from the repository root, one card

Phases (any failure exits non-zero; nothing is caught and passed over):

1. the card's name and power limit, from ``nvidia-smi``;
2. build both CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` each, started together) and time the build;
3. hold each kernel bitwise against its plain PyTorch version on the card:
   both colours, both rules, bf16 and f32, bs 16, 32 and 128, square and
   non-square tile grids including mr = 1; and the card's plain version
   against the CPU's at one small shape;
4. the main path at full size: ``IsingEngine(EngineConfig(size=20480,
   beta=0.4406868, backend=b, hot=True)).simulate(0)`` for b in pallas and
   pallas_lines, measured, with every launch count reset just before and
   read just after (2 per sweep for the backend's kernel); the two
   backends' final states bitwise equal; the kernel path at 256^2 on the
   card equal to the CPU plain path (state and series); the "chain"
   scenario at 4096^2;
5. CUDA-event timings at the main path's shapes: each kernel against its
   bound and its plain version, color_bits, blocked_stats, sweeps per
   second without measurement (flips/ns), peak memory.

It prints one JSON line of kernel records, then the card line, then the
contract line ``{"ok": true, "device": {...}}`` last. Without a CUDA device,
or without the repository beside it, it prints no result and exits 1.
"""
from __future__ import annotations

import json
import statistics
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
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12            # H100 SXM, f32 outside the tensor cores
FLOPS_PER_SITE = 10          # 3 adds, 1 multiply, <= 4 compares, 1 convert

KERNELS = {
    "update_color_tiles": dict(
        backend="pallas", source="src/repro_torch/kernels/csrc/"
        "checkerboard_tiles.cu",
        replaces="src/repro/kernels/checkerboard.py:208"),
    "update_color_lines": dict(
        backend="pallas_lines", source="src/repro_torch/kernels/csrc/"
        "checkerboard_lines.cu",
        replaces="src/repro/kernels/checkerboard.py:169"),
}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of one call of ``fn``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_fns():
    from repro_torch.kernels import checkerboard as kern
    return {"update_color_tiles": (kern.update_color_tiles,
                                   kern.update_color_tiles_plain),
            "update_color_lines": (kern.update_color_lines,
                                   kern.update_color_lines_plain)}


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
        for line in text.splitlines():
            if "registers" in line or name + ":" in line or "spill" in line:
                log("  nvcc", line.strip())
    log(f"build: {len(logs)} libraries in {seconds:.2f} s")
    return seconds


def phase_kernels_vs_plain(errs: dict) -> None:
    """Each kernel against its plain version on the card, bitwise."""
    import torch
    grids = [(1, 1), (2, 3), (1, 4), (3, 1)]
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for bs in (16, 32, 128):
            for grid in grids:
                qb, bits = blocked_state(n, *grid, bs, dtype, "cuda")
                for color in (0, 1):
                    for rule in ("metropolis_lut", "heat_bath"):
                        for beta in (0.1, BETA, 1.5):
                            for name, (fn, plain) in kernel_fns().items():
                                got = fn(qb.clone(), bits, beta, color, rule)
                                want = plain(qb.clone(), bits, beta, color,
                                             rule)
                                torch.cuda.synchronize()
                                err = exact_diff(got, want)
                                errs[name] = max(errs[name], err)
                                if err:
                                    raise AssertionError(
                                        f"{name} != plain: {dtype} bs={bs} "
                                        f"grid={grid} color={color} "
                                        f"{rule} beta={beta} err={err}")
                n += 1
    log(f"kernels vs plain on the card: {n} shapes x 2 colours x 2 rules x "
        "3 betas, bitwise equal")
    # the card's plain version against the CPU's, one small shape
    qb, bits = blocked_state(99, 2, 3, 16, torch.bfloat16, "cuda")
    for name, (_, plain) in kernel_fns().items():
        for color in (0, 1):
            dev = plain(qb.clone(), bits, BETA, color)
            cpu = plain(qb.cpu().clone(), bits.cpu(), BETA, color)
            if exact_diff(dev.cpu(), cpu):
                raise AssertionError(f"{name} plain: card != CPU")
    log("plain versions: card == CPU at [4, 2, 3, 16, 16]")


def phase_main_path(launches: dict) -> dict:
    """The port's main path at full size, through the public entry point."""
    import torch
    from repro_torch.api import EngineConfig, IsingEngine
    from repro_torch.kernels import checkerboard as kern
    finals, out = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for name, spec in KERNELS.items():
        cfg = EngineConfig(size=SIZE, beta=BETA, n_sweeps=MAIN_SWEEPS,
                           backend=spec["backend"], hot=True,
                           block_size=BS)
        eng = IsingEngine(cfg)
        kern.reset_launches()
        t0 = time.perf_counter()
        res = eng.simulate(0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(kern.launches)
        if counts[name] != 2 * MAIN_SWEEPS:
            raise AssertionError(f"{spec['backend']}: {name} launched "
                                 f"{counts[name]} times, want "
                                 f"{2 * MAIN_SWEEPS}")
        launches[name] = counts[name]
        m, e = res.magnetization, res.energy
        if not (torch.isfinite(m).all() and torch.isfinite(e).all()
                and float(m.abs().max()) <= 1.0
                and -2.0 <= float(e.min()) and float(e.max()) <= 2.0):
            raise AssertionError(f"{spec['backend']}: bad series {m} {e}")
        if res.state.shape != (4, SIZE // 2, SIZE // 2):
            raise AssertionError(f"bad state shape {tuple(res.state.shape)}")
        finals[name] = res.state
        out[name] = dict(seconds=seconds, m=m.tolist(), e=e.tolist(),
                         moments=res.moments)
        log(f"main path {spec['backend']}: {SIZE}^2, {MAIN_SWEEPS} sweeps "
            f"in {seconds:.3f} s, launches {counts}, m[-1]={float(m[-1])}, "
            f"E[-1]={float(e[-1])}")
    a, b = finals.values()
    if exact_diff(a, b):
        raise AssertionError("pallas and pallas_lines final states differ")
    log("main path: pallas == pallas_lines final state, bitwise")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"main path peak device memory: {out['peak_bytes'] / 2**30:.2f} GiB")
    del finals, a, b
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


def bound(name: str, qb, bits) -> tuple:
    """(bound_ms, bound_by) of one launch: each input read once, each
    output written once; about 10 f32 operations per updated site."""
    nq = qb[0].numel()
    e = qb.element_size()
    moved = 4 * nq * e + bits.numel() * bits.element_size() + 2 * nq * e
    if name == "update_color_lines":
        _, mr, mc, bs, _ = qb.shape
        moved += 4 * mr * mc * bs * e
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * nq * FLOPS_PER_SITE / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(launches: dict, errs: dict) -> tuple:
    import torch
    from repro_torch.api import EngineConfig, IsingEngine
    from repro_torch import random as jr
    from repro_torch.core import measure
    from repro_torch.kernels import checkerboard as kern
    from repro_torch.kernels import ops
    mr = mc = SIZE // 2 // BS
    qb, bits = blocked_state(7, mr, mc, BS, torch.bfloat16, "cuda")
    records = []
    for name, (fn, plain) in kernel_fns().items():
        # the kernel at the main path's shape, once more against its plain
        # version before it is timed
        got = fn(qb.clone(), bits, BETA, 0)
        want = plain(qb.clone(), bits, BETA, 0)
        errs[name] = max(errs[name], exact_diff(got, want))
        if errs[name]:
            raise AssertionError(f"{name} != plain at full size")
        del got, want
        work = qb.clone()
        ms = time_ms(lambda: fn(work, bits, BETA, 0), reps=20)
        plain_ms = time_ms(lambda: plain(work, bits, BETA, 0), reps=3,
                           warmup=1)
        b_ms, b_by = bound(name, qb, bits)
        del work
        records.append(dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=launches[name],
            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None))
        log(f"time {name}: {ms:.4f} ms per launch, bound {b_ms:.4f} ms "
            f"({b_by}), {b_ms / ms:.1%} of bound; plain {plain_ms:.3f} ms; "
            f"{qb[0].numel() * 2 / ms / 1e6:.1f} flips/ns")
    kern.reset_launches()
    key = jr.PRNGKey(3)
    bits_ms = time_ms(lambda: ops.color_bits(key, 0, 0, qb.shape[1:],
                                             "cuda"), reps=3, warmup=1)
    stats_ms = time_ms(lambda: measure.blocked_stats(qb), reps=5)
    log(f"time color_bits [2, {mr}, {mc}, {BS}, {BS}]: {bits_ms:.3f} ms per "
        f"colour; blocked_stats: {stats_ms:.3f} ms per sweep")
    del qb, bits
    cfg = EngineConfig(size=SIZE, beta=BETA, n_sweeps=MAIN_SWEEPS,
                       backend="pallas", hot=True, measure=False,
                       block_size=BS)
    eng = IsingEngine(cfg)
    state = eng.init(jr.PRNGKey(5))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(state, jr.PRNGKey(6))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log(f"time measurement-free pallas run {SIZE}^2 x {MAIN_SWEEPS} sweeps: "
        f"{seconds:.4f} s, {MAIN_SWEEPS * SIZE ** 2 / seconds / 1e9:.4f} "
        "flips/ns end to end")
    return records, dict(bits_ms=bits_ms, stats_ms=stats_ms,
                         free_s=seconds)


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
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    errs = {name: 0.0 for name in KERNELS}
    launches = {name: 0 for name in KERNELS}
    phase_kernels_vs_plain(errs)
    phase_main_path(launches)
    phase_small_and_chain()
    records, _ = phase_timing(launches, errs)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
