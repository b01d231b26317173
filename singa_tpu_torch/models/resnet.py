"""ResNet family (counterpart of ``singa_tpu/models/resnet.py``):
``BasicBlock``, ``Bottleneck``, ``Downsample``, ``ResNet`` and
``resnet18`` … ``resnet152``, NCHW.

Each stage's blocks are an ``nn.ModuleList``, so states come out under
the JAX package's names (``ResNet.layer10.conv1.W``,
``ResNet.layer10.bn1.running_mean``) and carry across with
``Model.set_states``.  The conv2_x bottleneck kernel
(``ops/bottleneck.py``) is not called here, as the JAX ResNet does not
call its megakernel.
"""

from __future__ import annotations

import itertools

from torch import nn

from .. import layer
from .common import Classifier

__all__ = ["BasicBlock", "Bottleneck", "Downsample", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "create_model"]


class BasicBlock(layer.Layer):
    expansion = 1

    def __init__(self, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = layer.Conv2d(planes, 3, stride=stride, padding=1,
                                  bias=False)
        self.bn1 = layer.BatchNorm2d()
        self.conv2 = layer.Conv2d(planes, 3, stride=1, padding=1, bias=False)
        self.bn2 = layer.BatchNorm2d()
        self.relu1 = layer.ReLU()
        self.relu2 = layer.ReLU()
        self.add = layer.Add()
        self.downsample = downsample

    def forward(self, x):
        residual = x
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            residual = self.downsample(x)
        return self.relu2(self.add(out, residual))


class Bottleneck(layer.Layer):
    expansion = 4

    def __init__(self, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = layer.Conv2d(planes, 1, bias=False)
        self.bn1 = layer.BatchNorm2d()
        self.conv2 = layer.Conv2d(planes, 3, stride=stride, padding=1,
                                  bias=False)
        self.bn2 = layer.BatchNorm2d()
        self.conv3 = layer.Conv2d(planes * self.expansion, 1, bias=False)
        self.bn3 = layer.BatchNorm2d()
        self.relu1 = layer.ReLU()
        self.relu2 = layer.ReLU()
        self.relu3 = layer.ReLU()
        self.add = layer.Add()
        self.downsample = downsample

    def forward(self, x):
        residual = x
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.relu2(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            residual = self.downsample(x)
        return self.relu3(self.add(out, residual))


class Downsample(layer.Layer):
    def __init__(self, planes, stride):
        super().__init__()
        self.conv = layer.Conv2d(planes, 1, stride=stride, bias=False)
        self.bn = layer.BatchNorm2d()

    def forward(self, x):
        return self.bn(self.conv(x))


class ResNet(Classifier):
    def __init__(self, block, layers, num_classes=1000, num_channels=3):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 224
        self.dimension = 4
        self.conv1 = layer.Conv2d(64, 7, stride=2, padding=3, bias=False)
        self.bn1 = layer.BatchNorm2d()
        self.relu = layer.ReLU()
        self.maxpool = layer.MaxPool2d(kernel_size=3, stride=2, padding=1)
        self.inplanes = 64
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        self.avgpool = layer.GlobalAvgPool2d()
        self.fc = layer.Linear(num_classes)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Downsample(planes * block.expansion, stride)
        blocks_list = [block(planes, stride, downsample)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            blocks_list.append(block(planes))
        return nn.ModuleList(blocks_list)

    def stem(self, x):
        """conv1 · bn1 · ReLU · max pool: the activation ``layer1``
        takes."""
        return self.maxpool(self.relu(self.bn1(self.conv1(x))))

    def forward(self, x):
        y = self.stem(x)
        for blk in itertools.chain(self.layer1, self.layer2, self.layer3,
                                   self.layer4):
            y = blk(y)
        y = self.avgpool(y)
        return self.fc(y)


def resnet18(**kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], **kw)


def resnet34(**kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], **kw)


def resnet50(**kw):
    return ResNet(Bottleneck, [3, 4, 6, 3], **kw)


def resnet101(**kw):
    return ResNet(Bottleneck, [3, 4, 23, 3], **kw)


def resnet152(**kw):
    return ResNet(Bottleneck, [3, 8, 36, 3], **kw)


_FACTORY = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
}


def create_model(name="resnet50", **kw):
    return _FACTORY[name](**kw)
