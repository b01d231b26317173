"""The LeNet-style CNN for MNIST (counterpart of
``singa_tpu/models/cnn.py``): two 5×5 conv + max-pool stages and two
``Linear`` layers, 28² single-channel input."""

from __future__ import annotations

from .. import layer
from .common import Classifier

__all__ = ["CNN", "create_model"]


class CNN(Classifier):
    def __init__(self, num_classes=10, num_channels=1):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 28
        self.dimension = 4
        self.conv1 = layer.Conv2d(20, 5, padding=0, activation="RELU")
        self.conv2 = layer.Conv2d(50, 5, padding=0, activation="RELU")
        self.pooling1 = layer.MaxPool2d(2, 2, padding=0)
        self.pooling2 = layer.MaxPool2d(2, 2, padding=0)
        self.relu = layer.ReLU()
        self.linear1 = layer.Linear(500)
        self.linear2 = layer.Linear(num_classes)
        self.flatten = layer.Flatten()

    def forward(self, x):
        y = self.conv1(x)
        y = self.pooling1(y)
        y = self.conv2(y)
        y = self.pooling2(y)
        y = self.flatten(y)
        y = self.linear1(y)
        y = self.relu(y)
        return self.linear2(y)


def create_model(**kwargs):
    return CNN(**kwargs)
