"""The vision model zoo: the CNNs built from the port's conv, pooling,
BatchNorm, ReLU / ReLU6, Linear and Dropout layers, and the Vision
Transformer on its LayerNorm, Linear and flash attention.

Counterpart of `paddle_tpu/vision/models/__init__.py`: ResNet (with the
ResNeXt and wide variants), LeNet, VGG, AlexNet, MobileNetV1,
MobileNetV2 and ViT (`vit_b_16`, `vit_s_16`, `vit_tiny_patch4`).
SqueezeNet, MobileNetV3, DenseNet, ShuffleNetV2, GoogLeNet and
InceptionV3 are not ported yet (ROADMAP queue 1 item 11).

Every constructor takes `device` (None: the CUDA device, raising
without one; "cpu" for the host) and draws its random weights from a
`torch.Generator` on that device seeded with `seed`, or from the
`generator` given (Dropout draws its masks from it too).  The two
packages' random streams differ, so parity loads the same numpy weights
into both (`models.load_numpy_state_dict`, BatchNorm's running
statistics included).  `pretrained=True` raises, as the reference's
does: there are no weights to download.
"""
from .alexnet import AlexNet, alexnet
from .lenet import LeNet
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .mobilenetv2 import MobileNetV2, mobilenet_v2
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnext50_32x4d,
                     resnext101_32x8d, wide_resnet50_2, wide_resnet101_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .vit import VisionTransformer, vit_b_16, vit_s_16, vit_tiny_patch4

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
           "resnext101_32x8d", "wide_resnet50_2", "wide_resnet101_2",
           "LeNet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19", "AlexNet",
           "alexnet", "MobileNetV1", "mobilenet_v1", "MobileNetV2",
           "mobilenet_v2", "VisionTransformer", "vit_b_16", "vit_s_16",
           "vit_tiny_patch4"]
