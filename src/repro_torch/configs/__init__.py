from repro_torch.configs.base import ArchConfig, get, names, register

__all__ = ["ArchConfig", "get", "names", "register"]
