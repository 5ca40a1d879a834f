"""xLSTM-350M [arXiv:2405.04517]: sLSTM + mLSTM blocks, 24 layers, d_model
1024, 4 heads (the reference's ``repro/configs/xlstm_350m.py``, field for
field).

The xLSTM[7:1] ratio is read as every 8th layer an sLSTM block, the rest
mLSTM, as in the reference."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    ssm_state=64, ssm_expand=2, slstm_every=8,
    subquadratic=True, num_freeze_blocks=4,
))
