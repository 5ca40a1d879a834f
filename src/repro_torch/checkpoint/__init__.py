from repro_torch.checkpoint.ckpt import (CheckpointCorruptError,
                                         CheckpointManager, latest_step,
                                         restore_checkpoint, save_checkpoint)

__all__ = ["CheckpointCorruptError", "CheckpointManager", "latest_step",
           "restore_checkpoint", "save_checkpoint"]
