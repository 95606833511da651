"""Training launcher for the decoder LM, ported: every registered arch
(dense, MoE, VLM, audio, the RG-LRU hybrid and the Mamba2 SSM) on one
device, the microbatched train step and the fault-tolerant loop.

The port of ``repro.launch.train``, one device only: the sharding engine
(``--mesh`` other than ``1,1``, ``--devices``) comes with the sharding
slice (ROADMAP A19.4) and is refused until then.

    # on the card (the default device)
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 20 --batch 16 --seq 128 --scale 0.1 --ckpt-dir /tmp/ck

    # the published mamba2-780m on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
        --scale 1.0 --seq 4096 --batch 8 --microbatches 4 --steps 4

    # on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --device cpu --steps 4 --batch 4 --seq 32

``--scale`` reduces width and depth as the reference does (1.0 is the
published config). A rerun with the same ``--ckpt-dir`` and more
``--steps`` resumes from the newest checkpoint.
"""
import argparse
import dataclasses
import signal
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
                    help="not ported: the sharding slice (ROADMAP A19.4)")
    ap.add_argument("--mesh", default="",
                    help="only 1,1 until the sharding slice (ROADMAP A19.4)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.devices or args.mesh not in ("", "1,1"):
        ap.error("--devices and a --mesh other than 1,1 need the sharding "
                 "engine, which is not ported yet (ROADMAP A19.4); the port "
                 "trains on one device")
    return args


def train(args, log_fn=print) -> dict:
    """Build the state and run the loop; returns the config, the trainer
    (its ``state`` and ``step_times``) and the loop's result."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import Trainer, TrainLoopConfig

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the launcher trains on the CUDA device by "
                           "default and none is available; pass --device "
                           "cpu to run on the CPU")
    device = torch.device(args.device)
    cfg = _reduce(get_config(args.arch), args.scale)
    shape_cfg = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                            kind="train")
    ocfg = OPT.OptimizerConfig(kind=cfg.optimizer)
    log_fn(f"[launch] {cfg.name} scale={args.scale} "
           f"params~{cfg.param_count()/1e6:.1f}M device={device}")
    gen = torch.Generator(device)
    gen.manual_seed(args.seed)
    step_fn = TS.make_train_step(cfg, ocfg, args.microbatches)
    tcfg = TrainLoopConfig(total_steps=args.steps,
                           ckpt_dir=args.ckpt_dir or None,
                           ckpt_every=args.ckpt_every,
                           log_every=max(1, args.steps // 20))
    # the trainer holds the only reference to the state, so each step's
    # old state is freed once the step returns its successor
    trainer = Trainer(step_fn, TS.init_train_state(cfg, ocfg, gen, device),
                      None, tcfg, log_fn=log_fn)
    previous = signal.getsignal(signal.SIGTERM)
    trainer.install_signal_handler()
    try:
        start = trainer.maybe_restore() if args.ckpt_dir else 0
        trainer.data_iter = syn.iterate(shape_cfg, cfg, device,
                                        start_step=start)
        result = trainer.run()
    finally:
        signal.signal(signal.SIGTERM, previous)
    return {"cfg": cfg, "trainer": trainer, "result": result}


def main(argv=None):
    args = parse_args(argv)
    result = train(args)["result"]
    print(f"[launch] done: {result['steps_run']} steps, "
          f"final loss {result['losses'][-1] if result['losses'] else None}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
