"""Config dataclasses shared by the model zoo, launcher and dry-run (the
port's copy of ``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # transformer variants
    qk_norm: bool = False
    attn_bias: bool = False
    activation: str = "swiglu"  # swiglu | squared_relu | geglu | gelu
    rope_theta: float = 1_000_000.0
    rope_style: str = "rope"    # rope | mrope | none
    mrope_sections: Tuple[int, ...] = ()
    logit_softcap: float = 0.0

    # layer pattern: one char per layer type, cycled over n_layers
    #   a = global attention, l = local (sliding-window) attention,
    #   r = RG-LRU recurrent block, s = Mamba2 SSD block
    layer_pattern: str = "a"
    window: int = 0             # sliding-window size for 'l' layers

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0           # per-expert hidden; 0 -> d_ff
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # "gspmd": auto-partitioned dispatch (paper-era baseline — GSPMD
    # replicates the [T*k, d] buffers; see EXPERIMENTS.md §Perf kimi).
    # "ep": explicit expert-parallel shard_map — local dispatch, one
    # psum per layer. ~1000x less wire on the 16x16 mesh.
    moe_impl: str = "ep"

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # audio (decoder over EnCodec tokens)
    n_codebooks: int = 0

    # numerics / compilation
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 128   # pad vocab so it tiles and shards evenly
    scan_layers: bool = True        # stack params + lax.scan (homogeneous only)
    remat: bool = True

    # decode-path variants (baseline vs optimized; see EXPERIMENTS.md §Perf)
    cache_layout: str = "btkh"      # "btkh" [B,T,KV,hd] | "bkth" [B,KV,T,hd]
    decode_carry_cache: bool = False  # cache in scan carry w/ in-place dus

    # distribution
    fsdp: bool = False              # shard params over the data axis too
    # Shard the batch over the model axis as well (§Perf musicgen): for
    # archs whose head count doesn't divide the model axis, attention
    # otherwise runs fully REPLICATED across it. Weights flow FSDP-style
    # (gathered per layer) instead. Incompatible with moe_impl="ep"
    # (EP needs tokens replicated along the model axis).
    batch_over_model: bool = False
    optimizer: str = "adamw"        # adamw | adafactor

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def pattern(self) -> str:
        p = self.layer_pattern
        return (p * (self.n_layers // len(p) + 1))[: self.n_layers]

    @property
    def homogeneous(self) -> bool:
        return len(set(self.pattern)) == 1 and not (
            self.family == "moe" and False)

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer attends over the full unbounded context."""
        return "a" not in self.pattern

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, hd = self.d_model, self.head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        per_layer = 0
        for kind in self.pattern:
            if kind in ("a", "l"):
                per_layer += d * hd * (n_q + 2 * n_kv) + n_q * hd * d
            elif kind == "r":
                per_layer += 2 * d * d + d * d + 3 * d  # proj/gates approx
            elif kind == "s":
                d_in = self.ssm_expand * d
                nh = d_in // self.ssm_head_dim
                per_layer += d * (2 * d_in + 2 * self.ssm_state + nh) + d_in * d
            if self.n_experts:
                ff = self.moe_d_ff
                n_mats = 3 if self.activation in ("swiglu", "geglu") else 2
                per_layer += (self.n_experts + self.n_shared_experts) * n_mats * d * ff
                per_layer += d * self.n_experts  # router
            elif kind != "s":
                n_mats = 3 if self.activation in ("swiglu", "geglu") else 2
                per_layer += n_mats * d * self.d_ff
        total = per_layer + 2 * self.padded_vocab * d  # in + out embeddings
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        ff = self.moe_d_ff
        n_mats = 3 if self.activation in ("swiglu", "geglu") else 2
        dense_like = dataclasses.replace(self, n_experts=0, experts_per_token=0)
        base = dense_like.param_count() - self.n_layers * n_mats * d * self.d_ff
        active_moe = self.n_layers * (
            (self.experts_per_token + self.n_shared_experts) * n_mats * d * ff)
        return base + active_moe


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode
    microbatches: int = 1       # gradient-accumulation steps (train only)


@dataclasses.dataclass(frozen=True)
class IsingConfig:
    name: str
    height_blocks: int          # lattice = (2*height_blocks*bs) rows
    width_blocks: int
    block_size: int = 128
    beta: float = 0.4406868     # T = T_c
    dtype: str = "bfloat16"
    sweeps_per_step: int = 1


# --- canonical LM shape set (assigned) -------------------------------------

TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

LM_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
