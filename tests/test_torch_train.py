"""The port's synthetic data, optimizers, train step, trainer and training
launcher against the JAX package's on the CPU.

Synthetic batches are bitwise the reference's. Optimizer updates, three
train steps and microbatched steps are f32: parameters and states within
1e-4 of each leaf's largest entry (summation order and last-ulp rounding
of the two packages' f32 arithmetic; the update divides by sqrt(v), which
magnifies a gradient's last-ulp difference where v is tiny).
"""
import dataclasses
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import small_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainLoopConfig  # noqa: E402

REL = 1e-4
SHAPE = ShapeConfig("t", seq_len=16, global_batch=8, kind="train")
JSHAPE = JShape("t", seq_len=16, global_batch=8, kind="train")


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


def _leaf_close(got, want, rel=REL, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err)


def _trees_close(got, want, rel=REL):
    jl = jax.tree.leaves(want)
    tl = tree.paths(got)
    assert len(jl) == len(tl)
    for (path, g), w in zip(tl, jl):
        if np.asarray(w).dtype == np.int32:
            assert int(g) == int(w), path
        else:
            _leaf_close(g, w, rel, path)


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "musicgen-medium",
                                  "qwen2-vl-7b"])
def test_synthetic_batches_are_bitwise_the_reference(arch):
    jcfg = small_config(arch)
    cfg = port_cfg(jcfg)
    for step in (0, 1, 7, 123456):
        want = jsyn.host_batch(step, JSHAPE, jcfg)
        got = syn.host_batch(step, SHAPE, cfg)
        dev = syn.device_batch(step, SHAPE, cfg, "cpu")
        assert got.keys() == want.keys() == dev.keys()
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
            assert got[name].dtype == np.asarray(want[name]).dtype or \
                name == "vision_embeds"
            np.testing.assert_array_equal(dev[name].float().numpy(),
                                          np.asarray(want[name], np.float32))
    if cfg.family == "vlm":
        assert dev["vision_embeds"].dtype == torch.bfloat16
    it = syn.iterate(SHAPE, cfg, "cpu", start_step=5)
    first, second = next(it), next(it)
    assert torch.equal(first["tokens"],
                       syn.device_batch(5, SHAPE, cfg, "cpu")["tokens"])
    assert torch.equal(second["labels"],
                       syn.device_batch(6, SHAPE, cfg, "cpu")["labels"])


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def _opt_inputs(seed):
    """A parameter tree with a stacked 3-D leaf, a matrix, a [k, 1]
    column (not factored), a vector and a scalar; grads of the same
    shapes at several scales."""
    rng = np.random.default_rng(seed)
    shapes = {"stack": (3, 8, 6), "mat": (5, 7), "col": (4, 1),
              "vec": (9,), "s": ()}
    params = {k: np.asarray(rng.standard_normal(s), np.float32)
              for k, s in shapes.items()}
    grads = [{k: np.asarray(rng.standard_normal(s)
                            * 10.0 ** rng.integers(-3, 2), np.float32)
              for k, s in shapes.items()}
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_updates_match_jax(kind):
    """Three clipped updates from zero state (warm-up 2, so the schedule
    moves): parameters and every state leaf (m, v, count; vr, vc) against
    the reference, and the same state tree."""
    cfg = opt.OptimizerConfig(kind=kind, lr=1e-2, warmup_steps=2,
                              grad_clip=5.0)
    jcfg = jopt.OptimizerConfig(kind=kind, lr=1e-2, warmup_steps=2,
                                grad_clip=5.0)
    params, grads = _opt_inputs(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init_fn(kind)(jp, jcfg)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = opt.init_fn(kind)(tp, cfg)
    assert [p for p, _ in tree.paths(ts)] == [
        p for p, _ in tree.paths(jax.tree.map(np.asarray, js))]
    for g in grads:
        jg, jn = jopt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, jcfg.grad_clip)
        tg, tn = opt.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, cfg.grad_clip)
        _leaf_close(tn, jn, 1e-6, "norm")
        jp, js = jopt.update_fn(kind)(jg, js, jp, jcfg)
        tp, ts = opt.update_fn(kind)(tg, ts, tp, cfg)
        _trees_close(tp, jp)
        _trees_close(ts, js)


def test_schedule_norm_and_state_from_jax():
    cfg = opt.OptimizerConfig(lr=0.1, warmup_steps=4)
    for step in range(6):
        got = opt.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = jopt.schedule(jopt.OptimizerConfig(lr=0.1, warmup_steps=4),
                             jnp.int32(step))
        assert float(got) == float(want)
    params, _ = _opt_inputs(1)
    js = jopt.adafactor_init({k: jnp.asarray(v) for k, v in params.items()},
                             jopt.OptimizerConfig(kind="adafactor"))
    ts = bridge.opt_state_from_jax(jax.tree.map(np.asarray, js))
    assert ts["count"].dtype == torch.int32
    assert tuple(ts["v"]["stack"]["vr"].shape) == (3, 8)
    assert tuple(ts["v"]["col"]["v"].shape) == (4, 1)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def _carried_state(jcfg, kind="adamw", lr=1e-3):
    jocfg = jopt.OptimizerConfig(kind=kind, lr=lr, warmup_steps=1)
    jstate, _ = JTS.init_train_state(jax.random.PRNGKey(0), jcfg, jocfg)
    np_state = jax.tree.map(np.asarray, jstate)
    cfg = port_cfg(jcfg)
    state = {"params": bridge.lm_params_from_jax(np_state["params"], cfg),
             "opt": bridge.opt_state_from_jax(np_state["opt"]),
             "step": torch.tensor(0, dtype=torch.int32)}
    return jocfg, jstate, opt.OptimizerConfig(kind=kind, lr=lr,
                                              warmup_steps=1), state


@pytest.mark.parametrize("micro", [1, 4])
def test_three_train_steps_match_jax(micro):
    """Three AdamW steps of qwen3-0.6b's small config in f32 from the
    carried state (4 microbatches: grads accumulated in f32, the mean
    loss): losses within 1e-5, parameters and states as stated above."""
    jcfg = small_config("qwen3-0.6b", dtype="float32")
    cfg = port_cfg(jcfg)
    jocfg, jstate, ocfg, state = _carried_state(jcfg)
    jstep = jax.jit(JTS.make_train_step(jcfg, jocfg, microbatches=micro))
    step = TS.make_train_step(cfg, ocfg, microbatches=micro)
    for i in range(3):
        host = jsyn.host_batch(i, JSHAPE, jcfg)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in host.items()})
        state, m = step(state, syn.device_batch(i, SHAPE, cfg, "cpu"))
        _leaf_close(m["loss"], jm["loss"], 1e-5 / float(jm["loss"]), "loss")
        _leaf_close(m["grad_norm"], jm["grad_norm"], REL, "grad_norm")
        assert int(m["step"]) == int(jm["step"]) == i + 1
    _trees_close(state["params"], jstate["params"])
    _trees_close(state["opt"], jstate["opt"])


def test_microbatched_equals_single_batch_grads():
    """4 microbatches over the same global batch == one big batch (loss
    and resulting params), up to f32 accumulation noise."""
    cfg = port_cfg(small_config("qwen3-0.6b", dtype="float32"))
    ocfg = opt.OptimizerConfig(kind="adamw", lr=1e-3, warmup_steps=1)
    batch = syn.device_batch(0, SHAPE, cfg, "cpu")
    outs = {}
    for micro in (1, 4):
        state = TS.init_train_state(cfg, ocfg, torch.Generator().manual_seed(0))
        new, metrics = TS.make_train_step(cfg, ocfg, micro)(state, batch)
        outs[micro] = (float(metrics["loss"]), new["params"])
    np.testing.assert_allclose(outs[1][0], outs[4][0], rtol=1e-5)
    for a, b in zip(tree.leaves(outs[1][1]), tree.leaves(outs[4][1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4)


def test_loss_decreases_on_learnable_data():
    cfg = port_cfg(small_config("qwen3-0.6b", dtype="float32"))
    ocfg = opt.OptimizerConfig(kind="adamw", lr=1e-3, warmup_steps=1)
    state = TS.init_train_state(cfg, ocfg, torch.Generator().manual_seed(0))
    step = TS.make_train_step(cfg, ocfg)
    losses = []
    for i in range(30):
        state, metrics = step(state, syn.device_batch(i, SHAPE, cfg, "cpu"))
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5])


# ---------------------------------------------------------------------------
# trainer (the reference's restart, preemption and straggler tests)
# ---------------------------------------------------------------------------


def _setup():
    """The loop's tests run an f32 model: the trainer is what they hold,
    and eager bf16 matmuls are slow on the CPU."""
    cfg = port_cfg(small_config("qwen3-0.6b", dtype="float32"))
    ocfg = opt.OptimizerConfig(kind="adamw", lr=1e-3, warmup_steps=1)
    state = TS.init_train_state(cfg, ocfg, torch.Generator().manual_seed(0))
    return cfg, state, TS.make_train_step(cfg, ocfg)


def test_trainer_checkpoint_restart(tmp_path):
    """A fresh Trainer over the same directory resumes from the saved
    step, and its state equals the uninterrupted run's, bitwise."""
    cfg, state, step = _setup()
    tcfg = TrainLoopConfig(total_steps=6, ckpt_dir=str(tmp_path),
                           ckpt_every=3, log_every=100)
    logs = []
    r1 = Trainer(step, state, syn.iterate(SHAPE, cfg, "cpu"), tcfg,
                 log_fn=logs.append).run()
    assert r1["steps_run"] == 6
    _, state2, _ = _setup()
    tcfg2 = dataclasses.replace(tcfg, total_steps=8)
    t2 = Trainer(step, state2, syn.iterate(SHAPE, cfg, "cpu", start_step=6),
                 tcfg2, log_fn=logs.append)
    r2 = t2.run()
    assert r2["start_step"] == 6 and r2["steps_run"] == 2
    assert int(t2.state["step"]) == 8
    assert ckpt.all_steps(str(tmp_path)) == [3, 6]
    straight = Trainer(step, _setup()[1], syn.iterate(SHAPE, cfg, "cpu"),
                       dataclasses.replace(tcfg, total_steps=8,
                                           ckpt_dir=None),
                       log_fn=logs.append)
    straight.run()
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(t2.state), tree.leaves(straight.state)))


def test_trainer_preemption_checkpoints_and_exits(tmp_path):
    cfg, state, step = _setup()
    tcfg = TrainLoopConfig(total_steps=100, ckpt_dir=str(tmp_path),
                           ckpt_every=1000, log_every=1)
    count = [0]

    def log_fn(msg):
        count[0] += 1

    t = Trainer(step, state, syn.iterate(SHAPE, cfg, "cpu"), tcfg,
                log_fn=log_fn)
    orig_step = t.train_step

    def stepping(state, batch):
        if count[0] >= 3:
            t.request_stop()
        return orig_step(state, batch)

    t.train_step = stepping
    r = t.run()
    assert r["steps_run"] < 100
    assert ckpt.latest_step(str(tmp_path)) == r["steps_run"]


def test_trainer_straggler_watchdog():
    """A step made slower than twice the median of the steps before it is
    counted (the injected delay exceeds four times the slowest step so
    far, so a loaded host cannot hide it)."""
    cfg, state, step = _setup()
    tcfg = TrainLoopConfig(total_steps=12, straggler_factor=2.0,
                           log_every=1000)
    t = Trainer(step, state, syn.iterate(SHAPE, cfg, "cpu"), tcfg,
                log_fn=lambda *_: None)
    import time as _time
    orig = t.train_step
    calls = [0]

    def slow_step(state, batch):
        calls[0] += 1
        if calls[0] == 10:   # inject a straggler step
            _time.sleep(1.0 + 4 * max(t.step_times))
        return orig(state, batch)

    t.train_step = slow_step
    assert t.run()["straggler_events"] >= 1


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _launch(tmp, steps, where, every=2):
    return launch_train.main(
        ["--arch", "qwen3-0.6b", "--device", "cpu", "--steps", str(steps),
         "--batch", "4", "--seq", "16", "--microbatches", "2",
         "--scale", "0.05", "--ckpt-dir", str(tmp / where),
         "--ckpt-every", str(every), "--seed", "3"])


def test_launch_train_on_cpu_runs_and_resumes(tmp_path, capsys):
    """``--device cpu``: 2 steps with a checkpoint every 2, then a rerun
    to 3 resumes at 2; its step-3 checkpoint equals a straight 3-step
    run's, bitwise. SIGTERM's handler is left as it was."""
    before = signal.getsignal(signal.SIGTERM)
    assert _launch(tmp_path, 2, "resumed") == 0
    assert _launch(tmp_path, 3, "resumed", every=3) == 0
    assert "restored checkpoint at step 2" in capsys.readouterr().out
    assert _launch(tmp_path, 3, "straight", every=3) == 0
    assert signal.getsignal(signal.SIGTERM) is before
    with np.load(tmp_path / "resumed" / "step_00000003.npz") as a, \
            np.load(tmp_path / "straight" / "step_00000003.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "params/layers/attn/wq" in a.files and "opt/m/emb/tok" in \
            a.files
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_launch_train_refuses_a_mesh_and_a_missing_card():
    with pytest.raises(SystemExit):
        launch_train.parse_args(["--arch", "qwen3-0.6b", "--mesh", "2,2"])
    with pytest.raises(SystemExit):
        launch_train.parse_args(["--arch", "qwen3-0.6b", "--devices", "4"])
    args = launch_train.parse_args(["--arch", "qwen3-0.6b", "--mesh", "1,1",
                                    "--steps", "1"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            launch_train.train(args)
