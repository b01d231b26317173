"""Xception (counterpart of ``singa_tpu/models/xceptionnet.py``):
depthwise-separable conv blocks (a depthwise conv, ``group`` = channels,
then a 1×1), 299² input.  A block's widths depend on its input, so its
layers are made at the first call (``initialize``)."""

from __future__ import annotations

from torch import nn

from .. import layer
from .common import Classifier

__all__ = ["SeparableConv2d", "XceptionBlock", "Xception", "create_model"]


class SeparableConv2d(layer.Layer):
    def __init__(self, out_channels, kernel_size, stride=1, padding=0):
        super().__init__()
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.depthwise = None
        self.pointwise = layer.Conv2d(out_channels, 1, bias=False)

    def initialize(self, x):
        in_channels = x.shape[1]
        self.depthwise = layer.Conv2d(
            in_channels, self.kernel_size, stride=self.stride,
            padding=self.padding, group=in_channels, bias=False)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class XceptionBlock(layer.Layer):
    """``grow_first=True`` grows the channels at the first separable conv,
    ``False`` at the last; the skip branch is a strided 1×1 conv and BN
    whenever the channels or the stride change."""

    def __init__(self, out_filters, reps, stride=1, start_with_relu=True,
                 grow_first=True):
        super().__init__()
        self.stride = stride
        self.start_with_relu = start_with_relu
        self.grow_first = grow_first
        self.out_filters = out_filters
        self.reps = reps
        self.skip = None
        self.skipbn = None
        self.pool = layer.MaxPool2d(3, stride, padding=1) \
            if stride != 1 else None
        self.add = layer.Add()

    def initialize(self, x):
        in_filters = x.shape[1]
        if self.stride != 1 or in_filters != self.out_filters:
            self.skip = layer.Conv2d(self.out_filters, 1, stride=self.stride,
                                     bias=False)
            self.skipbn = layer.BatchNorm2d()
        if self.grow_first:
            widths = [self.out_filters] * self.reps
        else:
            widths = [in_filters] * (self.reps - 1) + [self.out_filters]
        self.sepconvs = nn.ModuleList(SeparableConv2d(w, 3, 1, 1)
                                      for w in widths)
        self.bns = nn.ModuleList(layer.BatchNorm2d()
                                 for _ in range(self.reps))
        self.relus = nn.ModuleList(layer.ReLU() for _ in range(self.reps))

    def forward(self, x):
        y = x
        for i in range(self.reps):
            if i > 0 or self.start_with_relu:
                y = self.relus[i](y)
            y = self.sepconvs[i](y)
            y = self.bns[i](y)
        if self.pool is not None:
            y = self.pool(y)
        skip = self.skipbn(self.skip(x)) if self.skip is not None else x
        return self.add(y, skip)


class Xception(Classifier):
    def __init__(self, num_classes=1000, num_channels=3):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 299
        self.dimension = 4
        self.conv1 = layer.Conv2d(32, 3, stride=2, padding=0, bias=False)
        self.bn1 = layer.BatchNorm2d()
        self.relu1 = layer.ReLU()
        self.conv2 = layer.Conv2d(64, 3, padding=0, bias=False)
        self.bn2 = layer.BatchNorm2d()
        self.relu2 = layer.ReLU()

        self.block1 = XceptionBlock(128, 2, 2, start_with_relu=False)
        self.block2 = XceptionBlock(256, 2, 2)
        self.block3 = XceptionBlock(728, 2, 2)
        self.middle = nn.ModuleList(XceptionBlock(728, 3, 1)
                                    for _ in range(8))
        self.block12 = XceptionBlock(1024, 2, 2, grow_first=False)

        self.conv3 = SeparableConv2d(1536, 3, 1, 1)
        self.bn3 = layer.BatchNorm2d()
        self.relu3 = layer.ReLU()
        self.conv4 = SeparableConv2d(2048, 3, 1, 1)
        self.bn4 = layer.BatchNorm2d()
        self.relu4 = layer.ReLU()
        self.globalpool = layer.GlobalAvgPool2d()
        self.fc = layer.Linear(num_classes)

    def forward(self, x):
        y = self.relu1(self.bn1(self.conv1(x)))
        y = self.relu2(self.bn2(self.conv2(y)))
        y = self.block1(y)
        y = self.block2(y)
        y = self.block3(y)
        for blk in self.middle:
            y = blk(y)
        y = self.block12(y)
        y = self.relu3(self.bn3(self.conv3(y)))
        y = self.relu4(self.bn4(self.conv4(y)))
        y = self.globalpool(y)
        return self.fc(y)


def create_model(**kw):
    return Xception(**kw)
