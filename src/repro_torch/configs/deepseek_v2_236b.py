"""DeepSeek-V2 236B [arXiv:2405.04434; hf] (the reference's
``repro/configs/deepseek_v2_236b.py``, field for field): MLA attention
(128 heads, q through a 1536-rank LoRA, k/v through a 512-rank latent),
a MoE FFN of 160 routed experts of 1536, top-6, and 2 shared experts;
the first layer is dense."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288, vocab_size=102400, head_dim=128,
    attention="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    num_experts=160, num_shared_experts=2, experts_per_token=6,
    moe_d_ff=1536, moe_sharding="ep", first_dense_layers=1,
    num_freeze_blocks=6,
))
