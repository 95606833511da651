"""Simulation-as-a-service launcher: drive the continuous-batched MC
serving engine with a seeded synthetic workload.

The port of ``repro.launch.serve``: the same flags, workload and output
lines, plus ``--device`` (the card unless ``cpu`` is asked for) and
``--chunk-stats``.

    # 16 mixed ising/potts requests, 8-wide replica buckets, on the card:
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 \\
        --replica-width 8 --chunk 16 --sweeps 200

    # on the CPU, verifying one served request bitwise against a
    # standalone engine run:
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 4 \\
        --sizes 16 --sweeps 20 --device cpu --verify

The workload generator draws request shapes, couplings, and seeds from
``--seed`` — rerunning the same command replays the exact same request
stream (and, by the serving plane's batching-independence guarantee, the
exact same per-request results, those of the JAX launcher).
"""
from __future__ import annotations

import argparse
import random
import sys
import time


def make_workload(n: int, sizes, models, sweeps: int, samples: int,
                  seed: int) -> list:
    """n seeded pseudo-random requests across the requested shape mix."""
    from repro_torch.serve import SimRequest
    rng = random.Random(seed)
    out = []
    for i in range(n):
        model = rng.choice(models)
        size = rng.choice(sizes)
        kw = dict(L=size, n_sweeps=sweeps, n_samples=samples,
                  seed=rng.randrange(1 << 30))
        if model == "potts":
            q = rng.choice((2, 3))
            from repro_torch.potts import state as potts_state
            kw.update(model="potts", q=q,
                      beta=rng.uniform(0.8, 1.2) * potts_state.beta_c(q),
                      rule=rng.choice(("heat_bath", "metropolis")))
        else:
            from repro_torch.core import observables as obs
            beta_c = 1.0 / obs.critical_temperature()
            algo = rng.choice(("metropolis", "metropolis",
                               "swendsen_wang", "wolff"))
            kw.update(beta=rng.uniform(0.8, 1.2) * beta_c, algorithm=algo)
        out.append(SimRequest(**kw))
    return out


def chunk_report(engine) -> list:
    """One line per bucket from ``engine.chunk_times``: chunks swept, ms
    per chunk (host clock), and the share of the chunks' time outside the
    sweeps (scheduling, stacking, the copy to the host, harvest)."""
    by_bucket: dict = {}
    for ct in engine.chunk_times:
        by_bucket.setdefault(ct.bucket_key, []).append(ct)
    lines = []
    for key, cts in by_bucket.items():
        chunk_s = sum(ct.chunk_s for ct in cts)
        sweep_s = sum(ct.sweep_s for ct in cts)
        live = sum(ct.live for ct in cts) / len(cts)
        lines.append(f"[serve] bucket {key}: {len(cts)} chunks, "
                     f"{live:.1f} live slots, "
                     f"{chunk_s / len(cts) * 1e3:.3f} ms per chunk, "
                     f"outside the sweeps {1 - sweep_s / chunk_s:.1%}")
    total = sum(ct.chunk_s for ct in engine.chunk_times)
    sweeps = sum(ct.sweep_s for ct in engine.chunk_times)
    if total:
        lines.append(f"[serve] {len(engine.chunk_times)} chunks in "
                     f"{total:.3f} s, outside the sweeps "
                     f"{1 - sweeps / total:.1%}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="continuous-batched MC serving launcher")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--replica-width", type=int, default=8,
                    help="replica slots per bucket run")
    ap.add_argument("--chunk", type=int, default=16,
                    help="sweeps per chunk (admission cadence)")
    ap.add_argument("--sizes", default="32,64",
                    help="comma-separated lattice sides to mix")
    ap.add_argument("--models", default="ising,potts")
    ap.add_argument("--sweeps", type=int, default=200)
    ap.add_argument("--samples", type=int, default=4,
                    help="streamed snapshots per request")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="re-run one request standalone and check the "
                         "served moments are bitwise identical")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where requests run (default: cuda, failing when "
                         "there is no card)")
    ap.add_argument("--chunk-stats", action="store_true",
                    help="print ms per chunk of each bucket and the share "
                         "of a chunk spent outside the sweeps")
    args = ap.parse_args(argv)

    from repro_torch.serve import MCServeEngine
    sizes = tuple(int(s) for s in args.sizes.split(","))
    models = tuple(args.models.split(","))
    reqs = make_workload(args.requests, sizes, models, args.sweeps,
                         args.samples, args.seed)
    engine = MCServeEngine(replica_width=args.replica_width,
                           chunk_sweeps=args.chunk, device=args.device)

    def on_update(u):
        if not args.quiet:
            mark = "done" if u.done else f"{u.sweeps_done} sweeps"
            print(f"[serve] req {u.request_id:3d} {mark:>12s}  "
                  f"|m|={u.moments['m_abs']:.4f}  E={u.moments['E']:+.4f}")

    t0 = time.perf_counter()
    results = engine.serve(reqs, callback=on_update)
    wall = time.perf_counter() - t0

    lat = sorted(r.latency for r in results)
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
    spins = sum(r.n_spins() * r.n_sweeps for r in reqs)
    print(f"[serve] {len(results)} requests in {wall:.2f}s "
          f"({len(results) / wall:.2f} req/s, "
          f"{spins / wall / 1e6:.2f} Msites/s aggregate) "
          f"latency P50={p50:.2f}s P99={p99:.2f}s")
    if args.chunk_stats:
        for line in chunk_report(engine):
            print(line)

    if args.verify:
        from repro_torch.api import IsingEngine
        req, res = reqs[0], results[0]
        ref = IsingEngine(req.engine_config(),
                          device=engine.device).simulate(seed=req.seed)
        same = all(ref.moments[k] == res.moments[k] for k in ref.moments)
        print(f"[serve] bitwise batching-independence check "
              f"(req 0 vs standalone engine): "
              f"{'OK' if same else 'MISMATCH'}")
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
