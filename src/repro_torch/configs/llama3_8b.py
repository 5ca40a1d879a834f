"""Llama-3-8B [arXiv:2407.21783]: GQA kv=8, 128k vocab, rope theta 500k."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    rope_theta=500000.0, num_freeze_blocks=4,
))
