"""char-RNN language model (counterpart of
``singa_tpu/models/char_rnn.py``): one-hot characters, a multi-layer
recurrent net (LSTM by default; any mode of ``ops/rnn.py``), and a
per-step linear layer over the vocabulary, trained with
softmax-cross-entropy.  ``bench.py``'s ``bench_charrnn`` configures it as
batch 64 x 100 steps, vocab 100, hidden 256, 2 layers, SGD(0.1)."""

from __future__ import annotations

import numpy as np

from .. import autograd, layer, model
from .common import apply_dist_option

__all__ = ["CharRNN", "one_hot", "create_model"]


class CharRNN(model.Model):
    def __init__(self, vocab_size, hidden_size=256, num_layers=2,
                 seq_length=100, cell="lstm"):
        super().__init__()
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.seq_length = seq_length
        cls = {"lstm": layer.LSTM, "gru": layer.GRU,
               "vanilla_tanh": lambda *a, **k: layer.RNN(
                   *a, nonlinearity="tanh", **k),
               "vanilla_relu": lambda *a, **k: layer.RNN(
                   *a, nonlinearity="relu", **k)}[cell]
        self.lstm = cls(hidden_size, num_layers=num_layers,
                        batch_first=True)
        self.dense = layer.Linear(vocab_size)
        self.softmax_cross_entropy = layer.SoftMaxCrossEntropy()

    def forward(self, x, hx=None, cx=None):
        """x: (B, T, vocab) one-hot.  Returns (B·T, vocab) logits."""
        y, _ = self.lstm(x, hx, cx)
        return self.dense(autograd.reshape(y, (-1, self.hidden_size)))

    def train_one_batch(self, x, y, dist_option="plain", spars=None):
        out = self.forward(x)
        loss = self.softmax_cross_entropy(out, autograd.reshape(y, (-1,)))
        apply_dist_option(self.optimizer, loss, dist_option, spars)
        return out, loss


def one_hot(idx_batch, vocab_size):
    """(B, T) int -> (B, T, V) float32 one-hot (numpy)."""
    b, t = idx_batch.shape
    out = np.zeros((b, t, vocab_size), np.float32)
    out[np.arange(b)[:, None], np.arange(t)[None, :], idx_batch] = 1.0
    return out


def create_model(**kw):
    return CharRNN(**kw)
