"""Ising simulation launcher (the paper's Table 1/2 workload), ported.

The port of ``repro.launch.simulate``: the same flags and output lines, a
thin CLI over :class:`repro_torch.api.IsingEngine`. A 2-D or 3-D Ising
lattice is decomposed over a process grid of ``--mesh`` ranks, run in
chunks of ``--chunk`` sweeps with exact global stats logged after each,
and checkpointed (the state gathered to rank 0) so that a rerun with a
larger ``--sweeps`` resumes from the newest checkpoint, bitwise as if it
had not stopped.

    # 2x2 grid of gloo ranks on CPU tensors:
    PYTHONPATH=src python -m repro_torch.launch.simulate --devices 4 \\
        --mesh 2,2 --blocks-per-device 1 --block-size 16 --sweeps 20

    # one rank on the card (the default device):
    PYTHONPATH=src python -m repro_torch.launch.simulate --mesh 1,1 \\
        --blocks-per-device 16 --block-size 128 --sweeps 9 --chunk 3

    # q=3 Potts heat-bath checkerboard, or Swendsen-Wang, on a 2x2 grid:
    PYTHONPATH=src python -m repro_torch.launch.simulate --devices 4 \
        --mesh 2,2 --model potts --q 3 --rule heat_bath --sweeps 20
    PYTHONPATH=src python -m repro_torch.launch.simulate --devices 4 \
        --mesh 2,2 --algo swendsen_wang --block-size 16 --sweeps 20

``--devices N`` starts N ranks (``torch.multiprocessing``, gloo, CPU
tensors); without it the run is one rank on the CUDA device, or on the
CPU with ``--device cpu``. ``--replicas`` runs an ensemble on one device.
"""
import argparse
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=0,
                    help="start this many gloo ranks on CPU tensors")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="device of a run without --devices (default: "
                         "cuda, failing when there is no card)")
    ap.add_argument("--mesh", default="1,1")
    ap.add_argument("--blocks-per-device", type=int, default=2)
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--sweeps", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=50,
                    help="sweeps per chunk (checkpoint cadence)")
    ap.add_argument("--temperature-ratio", type=float, default=1.0)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--dims", type=int, default=2, choices=[2, 3],
                    help="2-D quads or the 3-D cube (side = "
                         "blocks-per-device * block-size, decomposed over "
                         "the mesh's trailing axes)")
    ap.add_argument("--pipeline", default="paper", choices=["paper", "opt"])
    ap.add_argument("--rule", default="metropolis",
                    choices=["metropolis", "heat_bath"])
    ap.add_argument("--algo", default="metropolis",
                    choices=["metropolis", "swendsen_wang", "wolff"],
                    help="single-site checkerboard dynamics or the "
                         "cluster-update plane (fast mixing at T_c)")
    ap.add_argument("--model", default="ising", choices=["ising", "potts"],
                    help="spin model; potts requires --q (checkerboard "
                         "and cluster dynamics both run on a grid)")
    ap.add_argument("--q", type=int, default=0,
                    help="Potts states (>= 2, with --model potts); "
                         "temperature-ratio is then relative to the exact "
                         "T_c(q) = 1/ln(1+sqrt(q))")
    ap.add_argument("--replicas", type=int, default=0,
                    help="run a multi-beta ensemble of N replicas spanning "
                         "[temperature-ratio, t-ratio-max] x Tc "
                         "(single-device topology)")
    ap.add_argument("--t-ratio-max", type=float, default=0.0,
                    help="upper T/Tc of the replica ladder "
                         "(default: temperature-ratio + 0.2)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.model == "potts" and args.q < 2:
        ap.error("--model potts requires --q >= 2 (e.g. --q 3)")
    if args.dims == 3 and args.model == "potts":
        ap.error("--dims 3 runs the Ising cube; potts is 2-D")
    if args.dims == 3 and args.replicas:
        ap.error("--replicas ensembles are 2-D (the replica runner sweeps "
                 "compact quads); drop --dims 3")
    if args.devices and args.device == "cuda":
        ap.error("--devices starts gloo ranks on CPU tensors; drop "
                 "--device cuda")
    return args


def build(args):
    """(EngineConfig, spins, description, grid shape, grid axes) of a
    run."""
    from repro_torch.api import EngineConfig
    from repro_torch.core import ising3d as I3
    from repro_torch.core import observables as obs
    from repro_torch.potts import state as potts_state

    shape = tuple(int(x) for x in args.mesh.split(","))
    axes = ("pod", "data", "model")[3 - len(shape):]
    sizes = dict(zip(axes, shape))
    nrows = 1
    for a in axes[:-1] or axes[:1]:
        nrows *= sizes[a]
    ncols = sizes[axes[-1]]
    bs = args.block_size
    if args.model == "potts":
        tc = 1.0 / potts_state.beta_c(args.q)
    elif args.dims == 3:
        tc = 1.0 / I3.BETA_C_3D
    else:
        tc = obs.critical_temperature()
    t = args.temperature_ratio * tc
    common = dict(model=args.model, q=args.q, pipeline=args.pipeline,
                  rule=args.rule, algorithm=args.algo, dtype=args.dtype,
                  n_sweeps=args.chunk, measure=False, hot=True)
    if args.replicas:
        h = w = 2 * args.blocks_per_device * bs
        t_max = args.t_ratio_max or (args.temperature_ratio + 0.2)
        n = args.replicas
        step = ((t_max - args.temperature_ratio) / (n - 1) if n > 1
                else 0.0)
        betas = tuple(1.0 / ((args.temperature_ratio + i * step) * tc)
                      for i in range(n))
        cfg = EngineConfig(size=h, betas=betas, topology="single",
                           block_size=bs, **common)
        return cfg, n * h * w, f"{n} replicas of {h}x{w}", (1,), ("data",)
    if args.dims == 3:
        side = args.blocks_per_device * bs
        cfg = EngineConfig(size=side, beta=1.0 / t, dims=3, topology="mesh",
                           mesh_shape=shape, mesh_axes=axes, **common)
        return cfg, side ** 3, f"{side}^3 cube", shape, axes
    mr = args.blocks_per_device * nrows
    mc = args.blocks_per_device * ncols
    h, w = 2 * mr * bs, 2 * mc * bs
    cfg = EngineConfig(size=h, width=w, beta=1.0 / t, topology="mesh",
                       mesh_shape=shape, mesh_axes=axes, block_size=bs,
                       prob_dtype="bfloat16", **common)
    return cfg, h * w, f"{h}x{w}", shape, axes


def run(args, device=None) -> int:
    """The launcher on this rank (the process group, if any, is up)."""
    import torch
    import torch.distributed as dist

    from repro_torch import random as jr
    from repro_torch.api import IsingEngine
    from repro_torch.checkpoint import ckpt
    from repro_torch.potts import state as potts_state

    cfg, spins, desc, shape, axes = build(args)
    engine = IsingEngine(cfg, device=device)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0

    def say(msg):
        if rank0:
            print(msg, flush=True)

    say(f"[simulate] mesh={dict(zip(axes, shape))} lattice {desc} "
        f"({spins/1e6:.1f}M spins) model={args.model}"
        f"{f'(q={args.q})' if args.model == 'potts' else ''} "
        f"dims={args.dims} T/Tc={args.temperature_ratio} "
        f"dtype={args.dtype} algo={args.algo} device={engine.device}")

    key = jr.PRNGKey(args.seed)
    start_sweep = 0
    sh = engine.state_sharding()
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        start_sweep = ckpt.latest_step(args.ckpt_dir)
        qb = ckpt.restore(args.ckpt_dir, {"qb": engine.state_template()},
                          shardings=({"qb": sh} if sh is not None
                                     else None),
                          device=engine.device)["qb"]
        say(f"[simulate] restored lattice at sweep {start_sweep}")
    else:
        qb = engine.init(key)

    done = start_sweep
    t_total = 0.0
    while done < args.sweeps:
        n = min(args.chunk, args.sweeps - done)
        t0 = time.perf_counter()
        qb = engine.run_sweeps(qb, jr.fold_in(key, done), n)
        if qb.device.type == "cuda":
            torch.cuda.synchronize(qb.device)
        dt = time.perf_counter() - t0
        t_total += dt
        done += n
        if sh is not None:
            m, e = engine.stats(qb)  # exact global stats, no gather
            say(f"[simulate] sweep {done:6d}  m={m:+.4f}  "
                f"E/spin={e:+.4f}  {n * spins / dt / 1e9:.4f} flips/ns")
        else:
            if args.model == "potts":
                views = qb if qb.dim() == 3 else qb[None]
                m = float(torch.mean(potts_state.order_parameter(
                    views, args.q)))
            else:
                m = engine.magnetization(qb)
            say(f"[simulate] sweep {done:6d}  m={m:+.4f}  "
                f"{n * spins / dt / 1e9:.4f} flips/ns")
        if args.ckpt_dir:
            ckpt.save(args.ckpt_dir, {"qb": qb}, step=done, keep=2,
                      shardings=({"qb": sh} if sh is not None else None))
    if t_total:
        say(f"[simulate] {args.sweeps - start_sweep} sweeps, avg "
            f"{(args.sweeps - start_sweep) * spins / t_total / 1e9:.4f} "
            "flips/ns")
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.devices:
        return run(args, device=args.device)
    from repro_torch.api.engine import check_ported
    from repro_torch.launch.mesh import run_ranks
    check_ported(build(args)[0])     # refuse before any rank starts
    return run_ranks(run, args.devices, args, "cpu")


if __name__ == "__main__":
    sys.exit(main())
