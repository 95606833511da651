"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload ising2d-free --seed 7 --seconds 10 \
        --trace 0

from the root of a checkout, on a machine with the chips the cell asks
for. The run:

1. makes the cell's inputs from the seed, builds the program
   (``repro_torch``, found under ``src/``) and warms it up on one chunk;
   that is the set-up;
2. measures whole chunks until ``--seconds`` have passed, the window
   ending at the end of a chunk, under ``torch.profiler`` with
   ``--trace 1``;
3. frees the program and checks what it produced against the plain
   reference (:mod:`perfbench.reference`), through the configuration's
   driver;
4. prints each number compared beside its limit on standard error, and the
   result as one JSON line on standard output, its ``checks`` last.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in ``perfbench/configs/<config>.json``, its traffic in
``perfbench/traffic/<traffic>.json``, the configuration's driver in
``perfbench/drivers/<driver>.py``, and each per-layer metric's reader in
``perfbench/metrics/<metric>.py``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from perfbench import trace

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """When this process started, on the wall clock (Linux ``/proc``)."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        started = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f
                    if line.startswith("btime"))
    return boot + started / ticks


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"perfbench._loaded.{path.parent.name}.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of ``BENCHMARK.json`` with everything it names loaded."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = _json(root / "BENCHMARK.json")
        here = root / "perfbench"
        self.spec = next(w for w in bench["workloads"] if w["name"] == name)
        self.name = name
        self.config = _json(here / "configs" / f"{self.spec['config']}.json")
        self.traffic = _json(here / "traffic" / f"{self.spec['traffic']}.json")
        self.driver = _module(here / "drivers"
                              / f"{self.config['driver']}.py").Driver
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if self._has(m) and m["moves"] in moved]
        self.readers = {m["name"]: _module(here / "metrics"
                                           / f"{m['name']}.py").read
                        for m in self.per_layer}

    def _has(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device="cuda", started: float | None = None,
             control: str | None = None) -> dict:
    """Steps 1 to 3 for ``cell``; returns ``{"line": the result line}``
    and, with ``control`` (a precision), ``"control"``: the readings with
    the reference at that precision in the program's place."""
    started = time.time() if started is None else started
    device = torch.device(device)
    cuda = device.type == "cuda"
    driver = cell.driver(cell.config, cell.traffic, seed, device)
    driver.setup()
    _sync(device)
    setup_s = time.time() - started
    counters = getattr(driver, "counters", dict)
    before = counters()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    sweeps = chunks = 0
    with torch.profiler.record_function(trace.WINDOW):
        t0 = time.perf_counter()
        while True:
            with torch.profiler.record_function(trace.CHUNK):
                sweeps += driver.chunk()
            _sync(device)
            chunks += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    after = counters()
    line = {"correct": False, "attempted": chunks + 1, "failed": 0,
            "metrics": {}}
    if traced:
        w = trace.window(*trace.from_profiler(prof), seconds=window_s,
                         sweeps=sweeps, sites=driver.sites,
                         config=cell.config,
                         counters={k: after[k] - before.get(k, 0)
                                   for k in after})
        prof = None
        for m in cell.per_layer:
            value = cell.readers[m["name"]](w)
            if value is not None:
                line["metrics"][m["name"]] = {"value": value,
                                              "unit": m["unit"]}
        extra = {"busy_s": w.busy_seconds(), "window_s": w.t1 - w.t0}
        line["breakdown"] = w.breakdown()
    else:
        rate = driver.sites * sweeps / window_s / 1e9
        e2e = {"flips_per_ns": rate, "cluster_flips_per_ns": rate,
               "peak_mem_gib": (peak - driver.harness_bytes) / 2 ** 30,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            line["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                          "unit": m["unit"]}
        extra = {}
    line["device"] = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": 1, "memory_peak_bytes": peak, **extra}
    driver.release()
    t_check = time.perf_counter()
    readings, checked, wrong = driver.check()
    print(f"perfbench: set-up {setup_s:.3f} s, window {window_s:.3f} s "
          f"({chunks} chunks), check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    line["failed"] = wrong
    line["correct"] = (wrong == 0 and checked > 0
                       and all(v <= lim for _, v, lim in readings))
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in readings}
    out = {"line": line}
    if control:
        out["control"] = driver.check(control)[0]
    return out


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "not read"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def chips_present(needed: int) -> str | None:
    """Why the run cannot start on this machine, or None."""
    if not torch.cuda.is_available():
        return "no CUDA device"
    if torch.cuda.device_count() < needed:
        return (f"{torch.cuda.device_count()} CUDA devices, the cell needs "
                f"{needed}")
    return None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    started = process_start()
    args = parse_args(argv)
    cell = Cell(args.workload)
    missing = chips_present(cell.spec["chips"])
    if missing:
        print(f"perfbench: {missing}; no result", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda", started)
    line = out["line"]
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 4
    checks = line.pop("checks")
    line["card"] = card_line()
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
