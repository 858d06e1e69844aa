"""Model zoo of the port's vision package (LeNet and the ResNet family so
far: ResNet, ResNeXt and Wide ResNet)."""

from .lenet import LeNet  # noqa: F401
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)

__all__ = ["LeNet", "BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "wide_resnet50_2", "wide_resnet101_2"]
