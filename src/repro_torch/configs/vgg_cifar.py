"""Paper-repro CNNs (VGG11_bn/VGG16_bn on CIFAR) — see models/cnn.py."""
from repro_torch.models.cnn import VGG11, VGG16  # noqa: F401
