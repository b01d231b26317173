"""MobileNetV2 (counterpart of ``singa_tpu/models/mobilenet.py``):
inverted residual blocks of a 1×1 expansion, a 3×3 depthwise conv
(``group`` = channels) and a 1×1 projection, ReLU6, 224² input."""

from __future__ import annotations

from torch import nn

from .. import layer
from .common import Classifier

__all__ = ["ConvBNReLU", "InvertedResidual", "MobileNetV2",
           "mobilenet_v2", "create_model"]


class ConvBNReLU(layer.Layer):
    def __init__(self, out_channels, kernel_size=3, stride=1, group=1):
        super().__init__()
        padding = (kernel_size - 1) // 2
        self.conv = layer.Conv2d(out_channels, kernel_size, stride=stride,
                                 padding=padding, group=group, bias=False)
        self.bn = layer.BatchNorm2d()
        self.relu = layer.ReLU6()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class InvertedResidual(layer.Layer):
    """1×1 expand → 3×3 depthwise → 1×1 project, with the residual add
    when the stride is 1 and the channels match."""

    def __init__(self, in_channels, out_channels, stride, expand_ratio):
        super().__init__()
        hidden = int(round(in_channels * expand_ratio))
        self.use_res = stride == 1 and in_channels == out_channels
        blocks = []
        if expand_ratio != 1:
            blocks.append(ConvBNReLU(hidden, kernel_size=1))
        blocks.append(ConvBNReLU(hidden, kernel_size=3, stride=stride,
                                 group=hidden))  # depthwise
        self.blocks = nn.ModuleList(blocks)
        self.project = layer.Conv2d(out_channels, 1, bias=False)
        self.project_bn = layer.BatchNorm2d()
        self.add = layer.Add()

    def forward(self, x):
        y = x
        for b in self.blocks:
            y = b(y)
        y = self.project_bn(self.project(y))
        if self.use_res:
            y = self.add(y, x)
        return y


# (expand_ratio t, out_channels c, repeats n, first stride s)
_V2_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


class MobileNetV2(Classifier):
    def __init__(self, num_classes=1000, num_channels=3, width_mult=1.0,
                 dropout=0.2):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 224

        def c(ch):
            # torchvision's _make_divisible: the nearest multiple of 8,
            # never more than 10% below
            v = ch * width_mult
            new_v = max(8, int(v + 4) // 8 * 8)
            if new_v < 0.9 * v:
                new_v += 8
            return new_v

        self.stem = ConvBNReLU(c(32), kernel_size=3, stride=2)
        features = []
        in_ch = c(32)
        for t, ch, n, s in _V2_CFG:
            for i in range(n):
                features.append(InvertedResidual(
                    in_ch, c(ch), s if i == 0 else 1, t))
                in_ch = c(ch)
        self.features = nn.ModuleList(features)
        self.head = ConvBNReLU(c(1280) if width_mult > 1.0 else 1280,
                               kernel_size=1)
        self.pool = layer.GlobalAvgPool2d()
        self.dropout = layer.Dropout(dropout)
        self.fc = layer.Linear(num_classes)

    def forward(self, x):
        y = self.stem(x)
        for b in self.features:
            y = b(y)
        y = self.pool(self.head(y))
        return self.fc(self.dropout(y))


def mobilenet_v2(**kw):
    return MobileNetV2(**kw)


_FACTORY = {"mobilenet_v2": mobilenet_v2}


def create_model(name="mobilenet_v2", **kw):
    return _FACTORY[name](**kw)
