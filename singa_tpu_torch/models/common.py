"""Shared classifier scaffolding for the model zoo (counterpart of
``singa_tpu/models/common.py``): ``Classifier`` trains with
softmax-cross-entropy, and ``apply_dist_option`` keeps the reference's
five-way ``dist_option`` switch over ``DistOpt``'s sync modes
(``parallel/dist_opt.py``)."""

from __future__ import annotations

from .. import layer, model

__all__ = ["Classifier", "apply_dist_option"]


def apply_dist_option(optimizer, loss, dist_option="plain", spars=None):
    """The reference's five-way switch: ``"plain"`` calls ``optimizer``;
    ``"fp16"``, ``"partialUpdate"``, ``"sparseTopK"`` and
    ``"sparseThreshold"`` call the ``DistOpt`` method of that sync mode
    (``spars`` for the sparse ones); anything else raises
    ``ValueError``."""
    if dist_option == "plain":
        optimizer(loss)
    elif dist_option == "fp16":
        optimizer.backward_and_update_half(loss)
    elif dist_option == "partialUpdate":
        optimizer.backward_and_partial_update(loss)
    elif dist_option == "sparseTopK":
        optimizer.backward_and_sparse_update(loss, topK=True, spars=spars)
    elif dist_option == "sparseThreshold":
        optimizer.backward_and_sparse_update(loss, topK=False, spars=spars)
    else:
        raise ValueError(f"unknown dist_option {dist_option!r}")


class Classifier(model.Model):
    """Model with softmax-cross-entropy training and the reference's five
    ``dist_option`` sync modes."""

    def __init__(self):
        super().__init__()
        self.softmax_cross_entropy = layer.SoftMaxCrossEntropy()

    def loss(self, out, ty):
        return self.softmax_cross_entropy(out, ty)

    def train_one_batch(self, x, y, dist_option="plain", spars=None):
        out = self.forward(x)
        loss = self.loss(out, y)
        apply_dist_option(self.optimizer, loss, dist_option, spars)
        return out, loss
