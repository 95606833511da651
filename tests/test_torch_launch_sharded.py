"""The port's training launcher on a process grid (the reference's
``tests/test_launchers.py`` train cases): ``repro_torch.launch.train
--device cpu --devices 4 --mesh 2,2`` spawns 4 gloo ranks, checkpoints
and resumes, runs the MoE arch, and rescales 2,2 -> 1,2 from the same
checkpoint. A resumed run's checkpoint equals a straight run's, bitwise.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO, SRC

pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401


def _run(args, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--device", "cpu"] + args, capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=timeout)
    assert p.returncode == 0, f"{p.stdout}\n{p.stderr}"
    return p.stdout


def test_sharded_launcher_runs_and_resumes(tmp_path):
    """4 steps on 2 x 2 with a checkpoint every 2; a rerun to 6 restores
    step 4 and runs 2; its step-6 checkpoint is a straight 6-step run's."""
    common = ["--arch", "qwen3-0.6b", "--devices", "4", "--mesh", "2,2",
              "--batch", "8", "--seq", "32", "--microbatches", "2",
              "--scale", "0.05", "--ckpt-every", "2"]
    ck, straight = str(tmp_path / "ck"), str(tmp_path / "straight")
    out1 = _run(common + ["--ckpt-dir", ck, "--steps", "4"])
    assert "[launch] done: 4 steps" in out1
    assert "mesh={'data': 2, 'model': 2}" in out1
    assert out1.count("[launch] done") == 1        # rank 0 alone logs
    out2 = _run(common + ["--ckpt-dir", ck, "--steps", "6"])
    assert "restored checkpoint at step 4" in out2
    assert "[launch] done: 2 steps" in out2
    _run(common + ["--ckpt-dir", straight, "--steps", "6"])
    with np.load(os.path.join(ck, "step_00000006.npz")) as a, \
            np.load(os.path.join(straight, "step_00000006.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "params/layers/attn/wq" in a.files
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_sharded_launcher_moe_arch():
    out = _run(["--arch", "kimi-k2-1t-a32b", "--devices", "4", "--mesh",
                "2,2", "--steps", "2", "--batch", "4", "--seq", "16",
                "--scale", "0.02"])
    assert "[launch] done: 2 steps" in out


def test_sharded_launcher_elastic_rescale(tmp_path):
    """A checkpoint of a 2 x 2 run resumes on a 1 x 2 grid of 2 ranks:
    the checkpoint holds global arrays, each rank re-blocks them."""
    base = ["--arch", "qwen3-0.6b", "--batch", "8", "--seq", "32",
            "--scale", "0.05", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "2"]
    _run(base + ["--devices", "4", "--mesh", "2,2", "--steps", "2"])
    out = _run(base + ["--devices", "2", "--mesh", "1,2", "--steps", "4"])
    assert "restored checkpoint at step 2" in out
    assert "[launch] done: 2 steps" in out
