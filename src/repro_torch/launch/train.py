"""Training launcher for the decoder LM, ported: every registered arch
(dense, MoE, VLM, audio, the RG-LRU hybrid and the Mamba2 SSM), the
microbatched train step and the fault-tolerant loop, on one device or on
a process grid with the sharding engine (the port of
``repro.launch.train``).

``--mesh`` names the grid: axes (data, model) or (pod, data, model). Each
rank holds the blocks of the state the reference's sharding rules put on
it (``distributed.sharding.rules_for``), trains on its rows of each
microbatch and computes its block of every layer along "model"
(``train.train_step.make_sharded_train_step``). ``--devices N``
spawns N gloo ranks of CPU tensors (with ``--device cpu``); on the card
``--mesh 1,1`` starts a one-rank NCCL group. A larger grid needs as many
ranks in an initialised process group; nothing falls back to gloo or the
CPU.

    # on the card (the default device)
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 20 --batch 16 --seq 128 --scale 0.1 --ckpt-dir /tmp/ck

    # the published mamba2-780m on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
        --scale 1.0 --seq 4096 --batch 8 --microbatches 4 --steps 4

    # on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --device cpu --steps 4 --batch 4 --seq 32

    # 4 gloo ranks on a 2 x 2 grid; on the card, one rank: --mesh 1,1
    PYTHONPATH=src python -m repro_torch.launch.train --arch kimi-k2-1t-a32b \\
        --device cpu --devices 4 --mesh 2,2 --steps 4 --batch 8 --seq 32

``--scale`` reduces width and depth as the reference does (1.0 is the
published config). A rerun with the same ``--ckpt-dir`` and more
``--steps`` resumes from the newest checkpoint.
"""
import argparse
import dataclasses
import math
import signal
import socket
import sys


def _reduce(cfg, scale: float):
    if scale >= 1.0:
        return cfg
    def r(x, q=64):
        return max(q, int(x * scale) // q * q)
    kw = dict(
        n_layers=max(2, int(cfg.n_layers * scale)),
        d_model=r(cfg.d_model),
        vocab_size=min(cfg.vocab_size, 4096), vocab_pad_multiple=64)
    if cfg.family != "ssm":
        heads = max(2, int(cfg.n_heads * scale))
        kw.update(n_heads=heads, n_kv_heads=max(1, min(cfg.n_kv_heads, heads)),
                  d_ff=r(cfg.d_ff or 256), head_dim=max(16, r(cfg.d_model) // heads))
    if cfg.n_experts:
        n_e = max(4, int(cfg.n_experts * scale))
        kw.update(n_experts=n_e, moe_d_ff=r(cfg.moe_d_ff),
                  experts_per_token=min(cfg.experts_per_token, n_e))
    if cfg.window:
        kw.update(window=min(cfg.window, 512))
    return dataclasses.replace(cfg, **kw)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="default cuda, failing when there is no card")
    ap.add_argument("--devices", type=int, default=0,
                    help="spawn this many gloo ranks on CPU tensors (with "
                         "--device cpu); the grid is --mesh, or N,1")
    ap.add_argument("--mesh", default="",
                    help="comma grid shape, e.g. 2,2 or 2,2,2; axes are "
                         "(data, model) or (pod, data, model); on the card "
                         "1,1 starts a one-rank NCCL group")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.devices and args.device != "cpu":
        ap.error("--devices spawns gloo ranks on CPU tensors; pass --device "
                 "cpu")
    shape = _mesh_shape(args)
    if shape is not None:
        if len(shape) not in (2, 3):
            ap.error("--mesh has 2 (data, model) or 3 (pod, data, model) "
                     "sizes")
        n = math.prod(shape)
        if args.devices and n != args.devices:
            ap.error(f"--mesh {args.mesh} has {n} shards, --devices "
                     f"{args.devices} ranks")
        if n > 1 and not args.devices and _group_size() != n:
            ap.error(f"--mesh {args.mesh} needs {n} ranks: --devices {n} "
                     "--device cpu spawns them as gloo ranks, or start one "
                     "process per rank in an initialised process group")
    return args


def _mesh_shape(args):
    """The grid shape of a sharded run (``--mesh``, or ``--devices`` N as
    N,1), or None for one device without a grid."""
    if args.mesh:
        return tuple(int(x) for x in args.mesh.split(","))
    if args.devices:
        return (args.devices, 1)
    return None


def _group_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 0


def _one_rank_group(device) -> bool:
    """Start a one-rank NCCL group on the card when none is initialised
    (a grid of one shard on the CPU needs none); returns whether it did."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized() or device.type != "cuda":
        return False
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(device.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    return True


def train(args, log_fn=print) -> dict:
    """Build the state and run the loop; returns the config, the trainer
    (its ``state`` and ``step_times``) and the loop's result. With a grid
    the state is this rank's blocks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import optimizer as OPT

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the launcher trains on the CUDA device by "
                           "default and none is available; pass --device "
                           "cpu to run on the CPU")
    device = torch.device(args.device)
    cfg = _reduce(get_config(args.arch), args.scale)
    shape_cfg = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                            kind="train")
    ocfg = OPT.OptimizerConfig(kind=cfg.optimizer)
    shape = _mesh_shape(args)
    started = shape is not None and _one_rank_group(device)
    try:
        return _train(args, cfg, shape_cfg, ocfg, shape, device, log_fn)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, cfg, shape_cfg, ocfg, shape, device, log_fn) -> dict:
    import torch
    from repro_torch import tree
    from repro_torch.data import synthetic as syn
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import Trainer, TrainLoopConfig

    gen = torch.Generator(device)
    gen.manual_seed(args.seed)
    tcfg = TrainLoopConfig(total_steps=args.steps,
                           ckpt_dir=args.ckpt_dir or None,
                           ckpt_every=args.ckpt_every,
                           log_every=max(1, args.steps // 20))
    rows, shardings = None, None
    if shape is None:
        where = f"device={device}"
        step_fn = TS.make_train_step(cfg, ocfg, args.microbatches)
        state = TS.init_train_state(cfg, ocfg, gen, device)
    else:
        grid = mesh_lib.make_grid(shape, ("pod", "data", "model")[
            3 - len(shape):], device)
        where = f"mesh={dict(zip(grid.axes, grid.shape))} device={device}"
        rules = SH.rules_for(cfg)
        places = TS.state_placements(cfg, ocfg, grid, rules)
        axes, rows = SH.batch_rows(grid, rules, args.batch,
                                   args.microbatches)
        step_fn = TS.make_sharded_train_step(cfg, ocfg, grid, places, axes,
                                             rules, args.microbatches)
        state = SH.local_blocks(grid, TS.init_train_state(cfg, ocfg, gen,
                                                          device), places)
        # (grid, placement) per leaf: how the checkpoint gathers and
        # re-blocks the state
        shardings = tree.map(lambda _, p: (grid, p), state, places)
    log_fn(f"[launch] {cfg.name} scale={args.scale} "
           f"params~{cfg.param_count()/1e6:.1f}M {where}")
    # the trainer holds the only reference to the state, so each step's
    # old state is freed once the step returns its successor
    trainer = Trainer(step_fn, state, None, tcfg, state_shardings=shardings,
                      log_fn=log_fn)
    del state
    previous = signal.getsignal(signal.SIGTERM)
    trainer.install_signal_handler()
    try:
        start = trainer.maybe_restore() if args.ckpt_dir else 0
        trainer.data_iter = syn.iterate(shape_cfg, cfg, device,
                                        start_step=start, rows=rows)
        result = trainer.run()
    finally:
        signal.signal(signal.SIGTERM, previous)
    return {"cfg": cfg, "trainer": trainer, "result": result}


def _rank_train(args) -> dict:
    """One spawned rank of ``--devices``: rank 0 logs; its loop result
    comes back."""
    import torch.distributed as dist
    log = print if dist.get_rank() == 0 else (lambda *_: None)
    return train(args, log_fn=log)["result"]


def main(argv=None):
    args = parse_args(argv)
    if args.devices:
        from repro_torch.launch.mesh import run_ranks
        result = run_ranks(_rank_train, args.devices, args)
    else:
        result = train(args)["result"]
    print(f"[launch] done: {result['steps_run']} steps, "
          f"final loss {result['losses'][-1] if result['losses'] else None}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
