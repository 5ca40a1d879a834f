from repro_torch.configs.base import (DECODE_32K, LONG_500K, PREFILL_32K,
                                     SHAPES, TRAIN_4K, ArchConfig,
                                     ShapeConfig, get, names, register)

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "TRAIN_4K", "PREFILL_32K",
           "DECODE_32K", "LONG_500K", "get", "names", "register"]
