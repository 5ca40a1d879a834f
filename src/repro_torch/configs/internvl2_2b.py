"""InternVL2-2B [arXiv:2404.16821]: an InternViT frontend stub (batches
carry precomputed patch embeddings, 1,024-dim, 256 a sequence) in front of
the InternLM2-1.8B backbone, GQA with 8 kv heads (the reference's
``repro/configs/internvl2_2b.py``, field for field)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553, head_dim=128,
    modality="vision_stub", frontend_dim=1024, num_image_tokens=256,
    num_freeze_blocks=4,
))
