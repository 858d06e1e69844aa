"""Model zoo of the port's vision package (LeNet and the ResNet family so
far)."""

from .lenet import LeNet  # noqa: F401
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152)

__all__ = ["LeNet", "BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152"]
