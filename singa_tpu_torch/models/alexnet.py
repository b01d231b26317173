"""AlexNet (counterpart of ``singa_tpu/models/alexnet.py``): five convs,
three max-pools and three ``Linear`` layers with dropout, 224² input."""

from __future__ import annotations

from .. import layer
from .common import Classifier

__all__ = ["AlexNet", "create_model"]


class AlexNet(Classifier):
    def __init__(self, num_classes=1000, num_channels=3):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 224
        self.dimension = 4
        self.conv1 = layer.Conv2d(64, 11, stride=4, padding=2)
        self.conv2 = layer.Conv2d(192, 5, padding=2)
        self.conv3 = layer.Conv2d(384, 3, padding=1)
        self.conv4 = layer.Conv2d(256, 3, padding=1)
        self.conv5 = layer.Conv2d(256, 3, padding=1)
        self.pool1 = layer.MaxPool2d(3, 2)
        self.pool2 = layer.MaxPool2d(3, 2)
        self.pool5 = layer.MaxPool2d(3, 2)
        self.relu1 = layer.ReLU()
        self.relu2 = layer.ReLU()
        self.relu3 = layer.ReLU()
        self.relu4 = layer.ReLU()
        self.relu5 = layer.ReLU()
        self.relu6 = layer.ReLU()
        self.relu7 = layer.ReLU()
        self.flatten = layer.Flatten()
        self.drop1 = layer.Dropout(0.5)
        self.drop2 = layer.Dropout(0.5)
        self.fc1 = layer.Linear(4096)
        self.fc2 = layer.Linear(4096)
        self.fc3 = layer.Linear(num_classes)

    def forward(self, x):
        y = self.pool1(self.relu1(self.conv1(x)))
        y = self.pool2(self.relu2(self.conv2(y)))
        y = self.relu3(self.conv3(y))
        y = self.relu4(self.conv4(y))
        y = self.pool5(self.relu5(self.conv5(y)))
        y = self.flatten(y)
        y = self.drop1(self.relu6(self.fc1(y)))
        y = self.drop2(self.relu7(self.fc2(y)))
        return self.fc3(y)


def create_model(**kw):
    return AlexNet(**kw)
