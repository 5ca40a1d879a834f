"""Paper-repro CNNs (ResNet10/18 on CIFAR) — see models/cnn.py."""
from repro_torch.models.cnn import RESNET10, RESNET18  # noqa: F401
