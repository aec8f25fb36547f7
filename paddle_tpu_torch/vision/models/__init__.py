"""The vision models (the JAX package's `vision/models`): LeNet, ResNet,
VGG and MobileNet V1 / V2."""
from .lenet import LeNet
from .mobilenet import (MobileNetV1, MobileNetV2, mobilenet_v1,
                        mobilenet_v2)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152)
from .vgg import VGG, make_layers, vgg11, vgg13, vgg16, vgg19

__all__ = ["BasicBlock", "BottleneckBlock", "LeNet", "MobileNetV1",
           "MobileNetV2", "ResNet", "VGG", "make_layers", "mobilenet_v1",
           "mobilenet_v2", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "vgg11", "vgg13", "vgg16", "vgg19"]
