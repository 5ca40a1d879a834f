"""Grok-1 314B [hf:xai-org/grok-1] (the reference's
``repro/configs/grok1_314b.py``, field for field): 64 layers, d_model
6144, 48 q heads over 8 kv heads of 128 (GQA group 6), a MoE FFN of 8
experts of 32768, top-2, gelu."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072, head_dim=128,
    num_experts=8, num_shared_experts=0, experts_per_token=2,
    moe_d_ff=32768, moe_sharding="tp",
    mlp_activation="gelu", num_freeze_blocks=8,
))
