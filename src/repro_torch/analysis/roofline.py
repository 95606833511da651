"""Three-term roofline of one rank's step on one NVIDIA H100 SXM: the port
of ``repro.analysis.roofline``, whose constants are a TPU's.

    compute    = sum over ops of FLOPs / the peak of the op's type
    memory     = bytes / HBM bandwidth
    collective = sum over collectives of wire bytes / the link of its ring

The counts are one rank's (:mod:`repro_torch.analysis.op_cost` counts the
rank's program op by op). Matrix products are priced at the peak of their
operands' type: bf16 on the tensor cores, f32 outside them (the port's
f32 products run in full f32, as PyTorch's default
``allow_tf32 = False`` keeps them; ``cutlass_80_simt_sgemm`` on the card).
Every other operation is priced at the f32 rate of the CUDA cores. A ring
whose ranks all lie in one node (one block of :data:`NODE_GPUS`
consecutive ranks) runs over NVLink; any other leaves the node and runs
at one NDR InfiniBand port a GPU.
"""
from __future__ import annotations

import dataclasses

# H100 SXM, NVIDIA's data sheet (dense rates, no sparsity, at 700 W)
BF16_FLOPS = 989e12        # bf16 / fp16 tensor-core FLOP/s
F32_FLOPS = 67e12          # f32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12           # HBM3 bytes/s
# NVLink 4: 900 GB/s to the other cards of the node, 450 GB/s each way
# (H100 SXM data sheet); a DGX H100 node holds 8 of them
NVLINK_BW = 450e9
NODE_GPUS = 8
# one 400 Gb/s NDR InfiniBand port a GPU (ConnectX-7, the DGX H100 data
# sheet): 50e9 bytes/s each way
NDR_BW = 50e9
PEAK_FLOPS = BF16_FLOPS    # the peak MFU is taken against

# matrix products by their operands' type
MATMUL_PEAK = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS,
               "float32": F32_FLOPS}


def matmul_peak(dtype: str) -> float:
    """FLOP/s of a matrix product of ``dtype`` operands (f32's for any
    type the tensor cores are not given here)."""
    return MATMUL_PEAK.get(dtype, F32_FLOPS)


def link_bw(ranks) -> float:
    """Bytes/s each way of one rank's link in the ring of ``ranks``:
    NVLink when they all lie in one node, else NDR."""
    return NVLINK_BW if len({r // NODE_GPUS for r in ranks}) <= 1 else NDR_BW


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    hbm_bytes_per_device: float
    wire_bytes_per_device: float
    model_flops: float = 0.0        # useful (analytic) global FLOPs
    n_devices: int = 1
    coll_by_kind: dict = dataclasses.field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (catches remat/redundancy waste)."""
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        t = self.step_time_s
        if not t:
            return 0.0
        return self.model_flops / (t * self.n_devices * PEAK_FLOPS)

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "model_flops": self.model_flops,
            "useful_flop_ratio": self.useful_flop_ratio,
            "mfu": self.mfu, "n_devices": self.n_devices,
            "coll_by_kind": self.coll_by_kind,
        }


def compute_seconds(cost) -> float:
    """Each matrix product's FLOPs over its type's peak, the rest over
    the f32 rate."""
    mm = sum(cost.matmul_flops.values())
    return (sum(f / matmul_peak(dt) for dt, f in cost.matmul_flops.items())
            + (cost.flops - mm) / F32_FLOPS)


def from_cost(cost, n_devices: int, model_flops: float = 0.0) -> Roofline:
    """The three terms from one rank's :class:`op_cost.Cost`."""
    return Roofline(
        compute_s=compute_seconds(cost),
        memory_s=cost.bytes / HBM_BW,
        collective_s=sum(b / link_bw(ranks)
                         for ranks, b in cost.wire_by_ring.items()),
        flops_per_device=cost.flops,
        hbm_bytes_per_device=cost.bytes,
        wire_bytes_per_device=cost.wire_bytes,
        model_flops=model_flops,
        n_devices=n_devices,
        coll_by_kind=dict(cost.coll_by_kind),
    )


# --- analytic "useful work" (the reference's formulas) ---------------------


def lm_model_flops(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (inference) + attention term; N = active params."""
    n_active = cfg.active_param_count()
    d_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    base = mult * n_active * d_tokens

    # attention score/value FLOPs (not in N·D): per token pair 4*H*hd MACs,
    # x3 for backward on train
    attn = 0.0
    h, hd = cfg.n_heads, cfg.head_dim
    for kind in cfg.pattern:
        if kind not in ("a", "l"):
            continue
        if shape.kind == "decode":
            ctx = min(cfg.window, shape.seq_len) if kind == "l" else shape.seq_len
            attn += 4.0 * h * hd * ctx * shape.global_batch
        else:
            s = shape.seq_len
            eff = min(cfg.window, s) if kind == "l" and cfg.window else s
            pairs = s * eff - (eff * (eff - 1)) // 2 if eff < s else s * (s + 1) // 2
            f = 4.0 * h * hd * pairs * shape.global_batch
            attn += f * (3.0 if shape.kind == "train" else 1.0)
    return base + attn


def ising_model_flops(height_blocks: int, width_blocks: int, block: int,
                      n_devices: int, sweeps: int = 1) -> float:
    """Useful ops per sweep: ~10 per spin (4 nn adds, 1 mul, compare, flip,
    RNG amortized)."""
    spins = 4.0 * height_blocks * width_blocks * block * block * n_devices
    return 10.0 * spins * sweeps
