"""Architecture configuration (counterpart of ``repro/configs/base.py``).

Every architecture is a frozen ``ArchConfig`` and every input shape of the
reference a ``ShapeConfig``. The fields are the
reference's, name for name, so a config compares field by field with its
JAX twin; the registry maps ``--arch <id>`` to its config and ``reduced()``
derives the small CPU variant of the same family.

The port runs every architecture of the reference: the dense family (GQA
and MLA attention), the MoE family (grok-1, deepseek-v2), the hybrid
Zamba2 family, the xLSTM family, the InternVL2 vision stub and the HuBERT
audio encoder.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


# ---------------------------------------------------------------------------
# Shape configs (the reference's input-shape set; LM shapes are seq_len x
# batch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention flavour ---
    attention: str = "gqa"  # gqa | mla
    # full-sequence path on the CPU: "xla" = dense softmax / blockwise
    # online softmax, "pallas" = the flash kernel's plain version through
    # its autograd.Function. On the card every GQA attention takes the
    # kernel (models/attention.py).
    attention_impl: str = "xla"
    qkv_bias: bool = False
    rope_theta: float = 10000.0

    # --- MLA ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_impl: str = "gshard"
    moe_sharding: str = "ep"
    capacity_factor: float = 1.25
    first_dense_layers: int = 0

    # --- SSM / recurrent ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    slstm_every: int = 0

    # --- hybrid ---
    attn_every: int = 0
    num_shared_attn_sets: int = 0

    # --- encoder-only / modality ---
    is_encoder_only: bool = False
    modality: str = "text"
    frontend_dim: int = 0
    num_image_tokens: int = 0

    # --- activation / misc ---
    mlp_activation: str = "silu"  # silu | gelu | relu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- SmartFreeze / progressive training ---
    num_freeze_blocks: int = 4

    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # kept for field-for-field equality with the reference; one device
    # shards nothing
    batch_axes: tuple = ("pod", "data")
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_heads_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind string, length num_layers."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                every = self.slstm_every
                kinds.append("slstm" if every and i % every == every - 1
                             else "mlstm")
            elif self.family == "hybrid":
                every = self.attn_every
                kinds.append("shared_attn" if every and i % every == every - 1
                             else "mamba2")
            elif self.is_moe:
                kinds.append("attn_mlp" if i < self.first_dense_layers
                             else "attn_moe")
            else:
                kinds.append("attn_mlp")
        return tuple(kinds)

    def segments(self) -> Tuple[Tuple[str, int], ...]:
        """Contiguous homogeneous (kind, count) runs."""
        segs = []
        for k in self.layer_kinds():
            if segs and segs[-1][0] == k:
                segs[-1][1] += 1
            else:
                segs.append([k, 1])
        return tuple((k, n) for k, n in segs)

    def block_boundaries(self) -> Tuple[int, ...]:
        """(b_0=0, ..., b_T=num_layers): freeze block t spans
        [boundaries[t], boundaries[t+1])."""
        base, rem = divmod(self.num_layers, self.num_freeze_blocks)
        bounds = [0]
        for i in range(self.num_freeze_blocks):
            bounds.append(bounds[-1] + base + (1 if i < rem else 0))
        return tuple(bounds)

    def param_count(self) -> int:
        """Analytic parameter count (the LM memory model's, from the
        params built on the meta device)."""
        from repro_torch.core.memory_model import arch_param_count

        return arch_param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.core.memory_model import arch_active_param_count

        return arch_active_param_count(self)

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family config for CPU tests."""
        small = dict(
            num_layers=max(4, min(self.num_layers, 4)),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads else 4,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
        )
        if self.attention == "mla":
            small.update(q_lora_rank=32 if self.q_lora_rank else 0,
                         kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                         v_head_dim=16)
        if self.is_moe:
            small.update(num_experts=4, experts_per_token=2, moe_d_ff=64,
                         num_shared_experts=min(self.num_shared_experts, 1),
                         first_dense_layers=min(self.first_dense_layers, 1))
        if self.ssm_state:
            small.update(ssm_state=16, ssm_head_dim=16)
        if self.attn_every:
            small.update(attn_every=2)
        if self.slstm_every:
            small.update(slstm_every=4)
        if self.modality == "vision_stub":
            small.update(frontend_dim=32, num_image_tokens=8)
        if self.modality == "audio_stub":
            small.update(frontend_dim=32)
        small.update(num_freeze_blocks=min(self.num_freeze_blocks, 2),
                     name=self.name + "-reduced")
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    _load_all()
    return _REGISTRY[name]


def names() -> list:
    _load_all()
    return sorted(_REGISTRY)


_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from repro_torch.configs import (  # noqa: F401  (registration)
        deepseek_coder_33b, deepseek_v2_236b, grok1_314b, hubert_xlarge,
        internvl2_2b, llama3_8b, minicpm3_4b, qwen2_72b, resnet_cifar,
        vgg_cifar, xlstm_350m, zamba2_7b)
