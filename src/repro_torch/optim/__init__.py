from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                         clip_by_global_norm, global_norm,
                                         momentum, sgd)

__all__ = ["Optimizer", "apply_updates", "clip_by_global_norm",
           "global_norm", "momentum", "sgd"]
