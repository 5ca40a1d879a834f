from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                         clip_by_global_norm, global_norm,
                                         momentum, sgd)
from repro_torch.optim.schedules import constant, cosine, warmup_cosine

__all__ = ["Optimizer", "adamw", "apply_updates", "clip_by_global_norm",
           "constant", "cosine", "global_norm", "momentum", "sgd",
           "warmup_cosine"]
