"""Zamba2-7B [arXiv:2411.15242]: Mamba2 backbone + shared attention blocks
(the reference's ``repro/configs/zamba2_7b.py``, field for field).

81 layers with every 6th a shared-attention block (2 alternating tied
weight sets), the rest Mamba2 (state 64). The HF checkpoint's
concat-with-embedding input and per-occurrence LoRA on the shared blocks
are simplified away, as in the reference."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    ssm_state=64, ssm_expand=2, attn_every=6, num_shared_attn_sets=2,
    subquadratic=True, num_freeze_blocks=6,
))
