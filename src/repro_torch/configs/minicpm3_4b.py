"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: dense MLA, 62 layers, d_model 2560,
40 heads (the reference's ``repro/configs/minicpm3_4b.py``, field for
field): q through a 768-rank LoRA, k/v through a 256-rank latent, q.k
width 64 + 32 (rope), v width 64."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=6400, vocab_size=73448, head_dim=64,
    attention="mla", q_lora_rank=768, kv_lora_rank=256,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
    num_freeze_blocks=6,
))
