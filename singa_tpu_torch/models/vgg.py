"""VGG family (counterpart of ``singa_tpu/models/vgg.py``): ``vgg11`` …
``vgg19``, optionally with batch norm after every conv.  The first
``Linear`` takes its input width at the first forward, so one net runs
at any input size; states exist only after ``compile``."""

from __future__ import annotations

from torch import nn

from .. import layer
from .common import Classifier

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "create_model"]

_CFGS = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(Classifier):
    def __init__(self, cfg, num_classes=1000, num_channels=3,
                 batch_norm=False, dropout=0.5, hidden=4096):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 224
        features = []
        for v in cfg:
            if v == "M":
                features.append(layer.MaxPool2d(2, stride=2))
            else:
                features.append(layer.Conv2d(v, 3, padding=1,
                                             bias=not batch_norm))
                if batch_norm:
                    features.append(layer.BatchNorm2d())
                features.append(layer.ReLU())
        self.features = nn.ModuleList(features)
        self.flatten = layer.Flatten()
        self.fc1 = layer.Linear(hidden)
        self.relu1 = layer.ReLU()
        self.drop1 = layer.Dropout(dropout)
        self.fc2 = layer.Linear(hidden)
        self.relu2 = layer.ReLU()
        self.drop2 = layer.Dropout(dropout)
        self.fc3 = layer.Linear(num_classes)

    def forward(self, x):
        y = x
        for f in self.features:
            y = f(y)
        y = self.flatten(y)
        y = self.drop1(self.relu1(self.fc1(y)))
        y = self.drop2(self.relu2(self.fc2(y)))
        return self.fc3(y)


def _make(name):
    def factory(batch_norm=False, **kw):
        return VGG(_CFGS[name], batch_norm=batch_norm, **kw)
    factory.__name__ = name
    return factory


vgg11 = _make("vgg11")
vgg13 = _make("vgg13")
vgg16 = _make("vgg16")
vgg19 = _make("vgg19")

_FACTORY = {"vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16,
            "vgg19": vgg19}


def create_model(name="vgg16", **kw):
    return _FACTORY[name](**kw)
