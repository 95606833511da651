"""The port's cost analysis against the JAX package's: the model-FLOP
formulas, the ring formulas of the collectives and the roofline's terms
equal the reference's exactly; the op counter holds the programs of
``tests/test_analysis.py`` to exact counts; and a reduced qwen3 train
step's matrix-product FLOPs lie within 5% of the ``dot`` FLOPs that
``repro.analysis.hlo_cost`` counts in the reference's compiled step."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import small_config  # noqa: E402
from repro.analysis import hlo as JH  # noqa: E402
from repro.analysis import hlo_cost as JHC  # noqa: E402
from repro.analysis import roofline as JRL  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_ising_config as jget_ising  # noqa: E402
from repro.configs import list_configs, list_ising_configs  # noqa: E402
from repro.configs.base import LM_SHAPES as JSHAPES  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.analysis import collectives as C  # noqa: E402
from repro_torch.analysis import op_cost as OC  # noqa: E402
from repro_torch.analysis import roofline as RL  # noqa: E402
from repro_torch.configs import get_config, get_ising_config  # noqa: E402
from repro_torch.configs.base import LM_SHAPES, ModelConfig, ShapeConfig  # noqa: E402,E501
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

MATMUL_REL = 0.05     # the stated tolerance of the train-step comparison


@pytest.mark.parametrize("arch", list_configs())
def test_lm_model_flops_equal_the_reference(arch):
    for name, shape in LM_SHAPES.items():
        assert RL.lm_model_flops(get_config(arch), shape) == \
            JRL.lm_model_flops(jget_config(arch), JSHAPES[name]), name


def test_ising_model_flops_equal_the_reference():
    names = list_ising_configs()
    assert names
    for name in names:
        i, j = get_ising_config(name), jget_ising(name)
        for n_dev in (1, 4, 256, 512):
            assert RL.ising_model_flops(
                i.height_blocks, i.width_blocks, i.block_size, n_dev, 3) == \
                JRL.ising_model_flops(j.height_blocks, j.width_blocks,
                                      j.block_size, n_dev, 3)


@pytest.mark.parametrize("kind", C.COLLECTIVE_KINDS)
def test_ring_formulas_equal_the_reference(kind):
    assert C.COLLECTIVE_KINDS == JH.COLLECTIVE_KINDS
    for n in (1, 2, 4, 16):
        for result, operand in ((1000, 1000), (4000, 1000), (1000, 4000)):
            got = C.Collective(kind, result, operand,
                               tuple(range(n))).wire_bytes
            assert got == JH.Collective(kind, result, operand, n).wire_bytes
    colls = [C.Collective(kind, 4096, 1024, (0, 1, 2, 3)),
             C.Collective("all-reduce", 512, 512, tuple(range(16)))]
    s = C.collective_summary(colls)
    assert s["count"] == 2
    assert s["wire_bytes_per_device"] == sum(c.wire_bytes for c in colls)


def test_roofline_terms_equal_the_reference():
    """The same three terms give the same dominant term, step time and
    useful-FLOP ratio in both packages (each against its own peak for
    MFU)."""
    for terms in ((1.0, 2.0, 0.5), (3.0, 2.0, 0.5), (0.1, 0.2, 0.7)):
        kw = dict(compute_s=terms[0], memory_s=terms[1],
                  collective_s=terms[2], flops_per_device=1e15,
                  hbm_bytes_per_device=2e12, wire_bytes_per_device=1e10,
                  model_flops=3e16, n_devices=16)
        got, want = RL.Roofline(**kw), JRL.Roofline(**kw)
        assert got.dominant == want.dominant
        assert got.step_time_s == want.step_time_s
        assert got.useful_flop_ratio == want.useful_flop_ratio
        assert got.mfu == pytest.approx(
            kw["model_flops"] / (got.step_time_s * 16 * RL.BF16_FLOPS))
        assert set(got.to_dict()) == set(want.to_dict())


def test_roofline_prices_each_type_and_ring():
    """bf16 products at the tensor-core peak, f32 ones and everything else
    at the f32 rate; a ring within one node of 8 ranks on NVLink, one
    that leaves it on NDR."""
    cost = OC.Cost(flops=3e12, bytes=6.7e12,
                   matmul_flops={"bfloat16": 1e12, "float32": 1e12},
                   wire_bytes=9e11,
                   wire_by_ring={tuple(range(8, 16)): 4.5e11,
                                 tuple(range(16)): 4.5e11})
    r = RL.from_cost(cost, 256)
    assert r.compute_s == pytest.approx(1e12 / 989e12 + 2e12 / 67e12)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(1.0 + 9.0)
    assert r.dominant == "collective"


@pytest.mark.parametrize("ranks, bw", [
    ((0, 1), RL.NVLINK_BW), (tuple(range(8)), RL.NVLINK_BW),
    ((17, 19, 21), RL.NVLINK_BW), ((7, 8), RL.NDR_BW),
    ((0, 256), RL.NDR_BW), ((0, 16), RL.NDR_BW)])
def test_link_follows_the_ring_ranks_not_its_size(ranks, bw):
    """Node membership comes from the ranks: a 2-rank ring 256 apart (the
    'pod' axis of 2 x 16 x 16) leaves the node."""
    assert RL.link_bw(ranks) == bw


def test_matmul_flops_exact():
    m, k, n = 128, 256, 64
    _, c = OC.count(lambda x, y: x @ y, torch.zeros(m, k), torch.zeros(k, n))
    assert c.flops == 2 * m * k * n
    assert c.matmul_flops == {"float32": 2 * m * k * n}


def test_loop_iterations_counted_each():
    """Ten products in a Python loop count exactly ten times one (the
    reference's trip-count rule, here by running the loop)."""
    a = torch.zeros(128, 128, device="meta")

    def scanned(x):
        for _ in range(10):
            x = x @ x
        return x

    f1 = OC.count(lambda x: x @ x, a)[1].flops
    f10 = OC.count(scanned, a)[1].flops
    assert f10 == 10 * f1 == 10 * 2 * 128 ** 3


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_elementwise_bytes_as_predicted(device):
    """v * 2 + 1 over 4 MB: two eager passes, each reading and writing
    4 MB (16 MB; the reference's fused XLA program counts about 8), two
    FLOPs an element, and the peak: the argument, the intermediate and
    the output."""
    x = torch.zeros(1 << 20, device=device)
    out, c = OC.count(lambda v: v * 2.0 + 1.0, x)
    assert c.bytes == 4 * (1 << 22)
    assert c.flops == 2 * (1 << 20)
    mem = c.memory(out)
    assert mem["argument_gb"] == mem["output_gb"] == (1 << 22) / 1e9
    assert mem["peak_gb"] == 3 * (1 << 22) / 1e9
    assert mem["alias_gb"] == 0.0


def test_views_free_in_place_aliased():
    """Views cost nothing, an in-place update reads and writes its tensor
    once, and an output that is an argument counts as aliased."""
    x = torch.zeros(64, 64)

    def f(v):
        w = v.view(-1)[:100].unsqueeze(0).t()
        v.add_(1.0)
        return v, w

    out, c = OC.count(f, x)
    assert c.per_op["add_"] == [1, 4096.0, 2 * 4096 * 4]
    assert c.bytes == 2 * 4096 * 4
    mem = c.memory(out)
    assert mem["alias_gb"] == mem["output_gb"] == mem["argument_gb"]
    assert mem["peak_gb"] == mem["argument_gb"]


def test_meta_count_equals_cpu_count():
    """The same program counts the same on ``meta`` as on CPU tensors
    (the memo of meta outputs included), backward and remat."""
    def prog(w, x):
        y = torch.utils.checkpoint.checkpoint(
            lambda a: torch.tanh(a @ w).sum(-1), x, use_reentrant=False)
        return torch.autograd.grad(y.sum() + (x * 3).sum(), (w,))

    counts = []
    for device in ("cpu", "meta"):
        w = torch.zeros(32, 16, device=device, requires_grad=True)
        x = torch.zeros(8, 32, device=device)
        counts.append(OC.count(prog, w, x)[1])
    assert counts[0].per_op == counts[1].per_op
    assert counts[0].flops == counts[1].flops
    assert counts[0].bytes == counts[1].bytes
    assert counts[0].peak_bytes == counts[1].peak_bytes
    # remat: the forward's product runs again in the backward
    assert counts[1].per_op["mm"][0] == 3


def _port_cfg(jcfg):
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


class _DotsOnly(JHC.CostModel):
    """The reference's cost model with every FLOP but a ``dot``'s dropped
    (loop trips, fusions and calls still multiply and descend)."""

    def _op_flops(self, comp, op):
        if op.opcode != "dot":
            return JHC.Cost()
        return super()._op_flops(comp, op)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matmul_flops_match_hlo_cost_dots(remat):
    """qwen3-0.6b reduced (2 layers, d_model 64, f32), seq 32, batch 4 in
    2 microbatches, AdamW: the port's step counted op by op against the
    reference's jitted step, ``dot`` FLOPs from its compiled HLO with
    while loops multiplied by their trips. The tolerance is 5%. Reached:
    without remat the port counts 0.04% fewer (the reference writes the
    flash backward's row sums D = rowsum(dO * O) as a small dot, the port
    as a multiply and a sum); with remat 1.10% more: the compiled
    reference holds one [B*KV, S*G, T] score product a layer and
    microbatch fewer than the eager program runs (XLA merges the
    recompute's product with an identical one; eager PyTorch merges
    nothing)."""
    jcfg = small_config("qwen3-0.6b", dtype="float32", remat=remat)
    cfg = _port_cfg(jcfg)
    ocfg_j = jopt.OptimizerConfig(kind=jcfg.optimizer)
    ocfg = opt.OptimizerConfig(kind=cfg.optimizer)
    shape = ShapeConfig("t", 32, 4, "train")
    state, _ = JTS.init_train_state(jax.random.PRNGKey(0), jcfg, ocfg_j)
    batch = {"tokens": jnp.zeros((4, 32), jnp.int32),
             "labels": jnp.zeros((4, 32), jnp.int32)}
    hlo = jax.jit(JTS.make_train_step(jcfg, ocfg_j, 2)).lower(
        state, batch).compile().as_text()
    want = _DotsOnly(hlo).total().flops
    tstate = {"params": bridge.lm_params_from_jax(
                  jax.tree.map(np.asarray, state["params"]), cfg),
              "opt": bridge.opt_state_from_jax(
                  jax.tree.map(np.asarray, state["opt"])),
              "step": torch.tensor(0, dtype=torch.int32)}
    tbatch = syn.device_batch(0, shape, cfg, "cpu")
    _, c = OC.count(TS.make_train_step(cfg, ocfg, 2), tstate, tbatch)
    got = sum(c.matmul_flops.values())
    assert want > 0
    assert abs(got - want) <= MATMUL_REL * want, (got, want)
    # the gap is the one explained above, exactly, in each of the 2 x 2
    # (layer, microbatch) attention calls: B 2, KV 2, S = T 32, G 2, hd 16
    score = 2 * (2 * 2) * (32 * 2) * 32 * 16
    rowsum = 2 * (2 * 32 * 2 * 2) * 16
    assert got - want == 4 * ((score if remat else 0) - rowsum)
