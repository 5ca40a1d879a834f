"""HuBERT-XLarge [arXiv:2106.07447]: an encoder-only (bidirectional)
transformer behind a conv feature extractor stub (batches carry 512-dim
frame features), predicting masked clusters over 504 units (the
reference's ``repro/configs/hubert_xlarge.py``, field for field)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504, head_dim=80,
    is_encoder_only=True, modality="audio_stub", frontend_dim=512,
    norm="layernorm", mlp_activation="gelu", num_freeze_blocks=4,
))
