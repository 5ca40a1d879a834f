from repro_torch.models.cnn import (CNN, CNN_REGISTRY, RESNET10, RESNET18,
                                    VGG11, VGG16, CNNConfig, build_cnn,
                                    softmax_xent)

__all__ = ["CNN", "CNN_REGISTRY", "CNNConfig", "RESNET10", "RESNET18",
           "VGG11", "VGG16", "build_cnn", "softmax_xent"]
