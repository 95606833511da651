"""Multi-pod dry-run: count one rank's program of every (arch x shape x
layout) cell on the production layouts, with no process group and no
allocation (the port of ``repro.launch.dryrun``; see
:mod:`repro_torch.launch.dryrun_lib`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both \\
        --out dryrun.jsonl
"""
import argparse
import json
import sys

from repro_torch.configs.base import LM_SHAPES
from repro_torch.launch import dryrun_lib as lib
from repro_torch.launch.mesh import production_layout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Multi-pod dry-run: count one rank of every "
                    "(arch x shape x mesh) cell.")
    ap.add_argument("--arch", default="all",
                    help="arch id, 'ising-*', or 'all'")
    ap.add_argument("--shape", default="all",
                    help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--out", default="", help="append JSONL records here")
    args = ap.parse_args(argv)

    layouts = []
    if args.mesh in ("single", "both"):
        layouts.append(("pod-16x16", production_layout(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        layouts.append(("pods-2x16x16", production_layout(multi_pod=True)))

    if args.arch == "all":
        cells = lib.default_cells()
    else:
        shapes = (list(LM_SHAPES) if args.shape == "all" else [args.shape]) \
            if not args.arch.startswith("ising") else ["sweep"]
        cells = [(args.arch, s) for s in shapes]

    failures = 0
    out_f = open(args.out, "a") if args.out else None
    try:
        for layout_name, layout in layouts:
            for arch, shape in cells:
                rec = lib.run_cell(arch, shape, layout, layout_name,
                                   args.microbatches or None)
                status = ("SKIP" if rec.get("skipped")
                          else "OK" if rec["ok"] else "FAIL")
                if out_f:
                    out_f.write(json.dumps(rec) + "\n")
                    out_f.flush()
                summary = {k: rec.get(k) for k in
                           ("arch", "shape", "mesh", "trace_s")}
                if rec.get("roofline"):
                    summary["dominant"] = rec["roofline"]["dominant"]
                    summary["peak_gb"] = round(rec["memory"]["peak_gb"], 2)
                    summary["fits"] = rec["fits"]
                print(f"[{status}] {summary}", flush=True)
                if not rec["ok"]:
                    print(rec.get("error"), file=sys.stderr)
                    failures += 1
    finally:
        if out_f:
            out_f.close()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
