"""Shared classifier scaffolding for the model zoo (counterpart of
``singa_tpu/models/common.py``): ``Classifier`` trains with
softmax-cross-entropy, and ``apply_dist_option`` keeps the reference's
five-way ``dist_option`` switch.  Only ``"plain"`` runs in the port; the
other four need ``DistOpt``, which is not ported yet."""

from __future__ import annotations

from .. import layer, model

__all__ = ["Classifier", "apply_dist_option"]

_DIST_MODES = ("fp16", "partialUpdate", "sparseTopK", "sparseThreshold")


def apply_dist_option(optimizer, loss, dist_option="plain", spars=None):
    """``"plain"``: one backward and update through ``optimizer``.  The
    DistOpt modes raise ``NotImplementedError``; anything else raises
    ``ValueError``."""
    if dist_option == "plain":
        optimizer(loss)
    elif dist_option in _DIST_MODES:
        raise NotImplementedError(
            f"dist_option {dist_option!r} needs DistOpt, which the port "
            f"does not have yet (ROADMAP Queue A)")
    else:
        raise ValueError(f"unknown dist_option {dist_option!r}")


class Classifier(model.Model):
    """Model with softmax-cross-entropy training."""

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
