"""Qwen2-72B [arXiv:2407.10671; hf]: GQA kv=8 with QKV bias."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1000000.0, num_freeze_blocks=8,
))
