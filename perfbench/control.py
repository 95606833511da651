"""Read the check's numbers for several seeds in one process: the program's,
and the control's (the plain reference at the precision below the one the
configuration states, put in the program's place). The limits in
``perfbench/configs/`` are set between the two. The benchmark's own runs
never run the control.

    python3 -m perfbench.control --workload ising2d-measured \
        --seeds 11,12,13 --seconds 3

prints one JSON line a seed. Needs the cell's chips, as a run does.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from perfbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--precision", default="bfloat16")
    args = ap.parse_args(argv)
    missing = run.chips_present(run.Cell(args.workload).spec["chips"])
    if missing:
        print(f"perfbench.control: {missing}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(run.ROOT / "src"))
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(run.Cell(args.workload), seed, args.seconds,
                           False, "cuda", control=args.precision)
        line = out["line"]
        print(json.dumps({
            "seed": seed, "correct": line["correct"],
            "program": {k: v["value"] for k, v in line["checks"].items()},
            "control": {n: v for n, v, _ in out["control"]},
            "metrics": {k: v["value"] for k, v in line["metrics"].items()},
        }), flush=True)
        del out, line
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
