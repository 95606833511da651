"""Perf diagnostics: count one dry-run cell and print where the bytes,
flops and wire traffic go (the port of ``repro.launch.diagnose``).

    PYTHONPATH=src python -m repro_torch.launch.diagnose \\
        --arch kimi-k2-1t-a32b --shape train_4k --top 25

``--dump-ops FILE`` writes one JSON line per (op, result shape): its
bytes, FLOPs, wire bytes and count over the whole step.
"""
import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--pipeline", default="paper",
                    help="ising cells: paper | opt")
    ap.add_argument("--bits", default="uint32", help="ising: uint32|uint16")
    ap.add_argument("--rng", default="threefry", help="ising: threefry|rbg")
    ap.add_argument("--dump-ops", default="",
                    help="write every (op, shape) row here as JSONL")
    args = ap.parse_args(argv)

    from repro_torch.analysis import op_cost
    from repro_torch.analysis import roofline as RL
    from repro_torch.configs import get_ising_config
    from repro_torch.launch import dryrun_lib as lib
    from repro_torch.launch import mesh as mesh_lib

    layout = mesh_lib.production_layout(multi_pod=(args.mesh == "multi"))
    grid = mesh_lib.rankless_grid(layout)
    if args.arch.startswith("ising"):
        fn, cell_args = lib.build_ising_cell(
            get_ising_config(args.arch), grid, pipeline=args.pipeline,
            bits_dtype=args.bits, rng=args.rng)
    else:
        fn, cell_args, _ = lib.build_cell(args.arch, args.shape, grid,
                                          args.microbatches or None)

    _, counter = op_cost.count(fn, *cell_args, records=grid.records)
    if args.dump_ops:
        rows = counter.breakdown(top=None)
        with open(args.dump_ops, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        print(f"# {len(rows)} op rows written to {args.dump_ops}")

    total = counter.cost()
    rl = RL.from_cost(total, grid.size)
    print(f"# totals: flops={total.flops:.3e} bytes={total.bytes:.3e} "
          f"wire={total.wire_bytes:.3e}")
    print(f"# roofline (H100 SXM): compute={rl.compute_s:.3f}s "
          f"memory={rl.memory_s:.3f}s collective={rl.collective_s:.3f}s")
    print("# collectives by kind:",
          json.dumps({k: f"{v:.3e}" for k, v in total.coll_by_kind.items()}))
    print(f"\n# top {args.top} ops by HBM bytes "
          f"(count = executions, every loop iteration included):")
    print(f"{'op':22s} {'bytes':>12s} {'flops':>12s} {'wire':>12s} "
          f"{'count':>8s}  shape")
    for row in counter.breakdown(args.top):
        print(f"{row['op']:22s} {row['bytes']:12.3e} {row['flops']:12.3e} "
              f"{row['wire']:12.3e} {row['count']:8.0f}  {row['shape'][:70]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
