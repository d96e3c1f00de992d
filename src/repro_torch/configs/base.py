"""Config system: architecture + run configuration dataclasses.

Every assigned architecture gets one module in this package defining
``CONFIG`` (the exact full-size config, used only via the AOT dry-run) and
``smoke_config()`` (a reduced same-family variant for CPU smoke tests).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Any, Sequence

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0           # 0 => dense FFN
    num_experts_per_tok: int = 0   # top-k
    # capacity factor for expert-parallel dispatch (dense one-hot dispatch
    # is exact; capacity only bounds the per-expert buffer in dispatch mode)
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 => d_model // 16


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64


@dataclass(frozen=True)
class ArchConfig:
    """Architecture hyper-parameters.

    ``family`` selects the block assembly:
      dense | moe | hybrid (mamba+attn interleave) | ssm (rwkv6) |
      encdec (whisper) | vlm (decoder + patch-embedding stub) | cnn
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 => d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    act: str = "swiglu"                # swiglu | gelu
    rope_theta: float = 10000.0
    max_seq_len: int = 131072
    sliding_window: int = 0            # 0 => full attention
    moe: MoEConfig = field(default_factory=MoEConfig)
    moe_layer_period: int = 1          # every k-th layer is MoE (jamba: 2)
    mamba: MambaConfig = field(default_factory=MambaConfig)
    rwkv: RWKVConfig = field(default_factory=RWKVConfig)
    attn_layer_period: int = 0         # hybrid: 1 attn per this many layers
    attn_layer_offset: int = 0
    # enc-dec / vlm stubs
    encoder_layers: int = 0
    encoder_seq_len: int = 0           # whisper: 1500 frames
    num_patches: int = 0               # vlm: vision patch embeddings
    # provenance
    source: str = ""

    def __post_init__(self):
        # keep field order stable for dataclasses.replace users
        pass

    # embedding/head tables are padded so the vocab dim divides any mesh
    # axis combination (Megatron-style); labels never reference pad rows.
    vocab_pad_multiple: int = 512

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.moe.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if long_500k decode is native (sub-quadratic) for this family."""
        return self.family in ("ssm", "hybrid")

    def with_sliding_window(self, window: int) -> "ArchConfig":
        return dataclasses.replace(self, sliding_window=window)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline term)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Run config (training/serving hyper-params + distribution strategy)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RunConfig:
    arch: str = "qwen1.5-0.5b"
    shape: str = "train_4k"
    strategy: str = "dp_full"      # dp_full | split_concurrent | split_sequential
    optimizer: str = "adagrad"     # paper's modified adagrad by default
    learning_rate: float = 1e-2
    adagrad_beta: float = 1.0      # the paper's β (inside the sqrt)
    weight_decay: float = 0.0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    head_sync_period: int = 4      # split_concurrent: stale head refresh K
    grad_accum: int = 1            # microbatches per step (gradient accumulation)
    # decode activation layout: "batch_sharded" | "replicated_batch" | "auto"
    # (auto -> replicated_batch + 2D KV sharding when the per-model-shard
    # weight bytes exceed ~2 GiB, i.e. when per-step FSDP weight gathers
    # would dominate; see EXPERIMENTS.md §Perf, jamba decode iterations)
    decode_layout: str = "auto"
    # fused vocab-chunked head+loss (full logits never materialise);
    # 0 = off.  Applies to dp_full/fsdp_tp/split_sequential train paths.
    loss_chunks: int = 0
    seed: int = 0
    steps: int = 10
    log_every: int = 1
    # sashimi ticket scheduler
    ticket_timeout_s: float = 300.0   # paper: five minutes
    ticket_redistribute_min_s: float = 10.0  # paper: at least 10 seconds
    microbatch_per_ticket: int = 1
    multi_pod: bool = False


ARCH_IDS: Sequence[str] = (
    "dbrx-132b",
    "qwen1.5-0.5b",
    "qwen3-moe-30b-a3b",
    "qwen3-4b",
    "command-r-35b",
    "whisper-small",
    "jamba-1.5-large-398b",
    "internvl2-26b",
    "rwkv6-1.6b",
    "minitron-4b",
)

_MODULE_FOR_ARCH = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_arch_config(name: str) -> ArchConfig:
    """Load the full-size config for an assigned architecture id."""
    if name not in _MODULE_FOR_ARCH:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULE_FOR_ARCH)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR_ARCH[name]}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    """Load the reduced smoke-test config (2 layers, d_model<=512, <=4 experts)."""
    if name not in _MODULE_FOR_ARCH:
        raise KeyError(f"unknown arch {name!r}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR_ARCH[name]}")
    return mod.smoke_config()


def all_arch_configs() -> dict[str, ArchConfig]:
    return {a: get_arch_config(a) for a in ARCH_IDS}
