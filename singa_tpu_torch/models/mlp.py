"""MLP (counterpart of ``singa_tpu/models/mlp.py``): two ``Linear``
layers with a ReLU between, trained with softmax cross-entropy; the
model of ``examples/mlp/train.py``."""

from __future__ import annotations

from .. import layer, model
from .common import apply_dist_option

__all__ = ["MLP", "create_model"]


class MLP(model.Model):
    def __init__(self, data_size=10, perceptron_size=100, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.dimension = 2
        self.linear1 = layer.Linear(perceptron_size)
        self.relu1 = layer.ReLU()
        self.linear2 = layer.Linear(num_classes)
        self.softmax_cross_entropy = layer.SoftMaxCrossEntropy()

    def forward(self, inputs):
        y = self.linear1(inputs)
        y = self.relu1(y)
        return self.linear2(y)

    def train_one_batch(self, x, y, dist_option="plain", spars=None):
        out = self.forward(x)
        loss = self.softmax_cross_entropy(out, y)
        apply_dist_option(self.optimizer, loss, dist_option, spars)
        return out, loss


def create_model(**kwargs):
    return MLP(**kwargs)
