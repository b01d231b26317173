"""``Model`` API (counterpart of ``singa_tpu/model.py:121-336``):
``compile(inputs, is_train, use_graph, sequential)``, a user-overridden
``train_one_batch``, ``set_optimizer``, ``train``/``eval``, and
``get_states``/``set_states`` under the JAX package's state names.

Every step runs eagerly.  ``use_graph=True`` is accepted and recorded,
but no graph is captured yet: capturing the step as a CUDA graph (the
counterpart of the JAX package's ``jax.jit`` step) is later work.
"""

from __future__ import annotations

import torch

from . import layer

__all__ = ["Model"]


class Model(layer.Layer):
    """Subclass and override ``forward`` and ``train_one_batch``."""

    def __init__(self):
        super().__init__()
        self._optimizer = None
        self.graph_mode = False
        self.sequential = False
        self.device = None

    def compile(self, inputs, is_train=True, use_graph=False,
                sequential=False):
        """Create the parameters with one forward over ``inputs`` (no
        gradient, no dropout), name them, and set the mode.  The device is
        that of ``inputs[0]``.  ``use_graph`` is recorded; the step still
        runs eagerly (see the module docstring)."""
        assert isinstance(inputs, (list, tuple)), "inputs must be a list"
        prev = self.training
        self.train(False)
        try:
            with torch.no_grad():
                self.forward(*inputs)
        finally:
            self.train(prev)
        self._initialized = True
        self.set_name(self.name)
        names = list(self.get_states())
        assert len(names) == len(set(names)), (
            f"duplicate param/state names after compile: {names}")
        self.train(is_train)
        self.graph_mode = bool(use_graph)
        self.sequential = bool(sequential)
        if inputs:
            from .device import device_of

            self.device = device_of(inputs[0])
            self.device.EnableGraph(use_graph)

    def forward(self, *input):
        raise NotImplementedError

    def train_one_batch(self, *input, **kwargs):
        raise NotImplementedError

    def __call__(self, *input, **kwargs):
        """Training mode: one ``train_one_batch``; eval mode: ``forward``."""
        if not self._initialized:
            with torch.no_grad():
                self.initialize(*input)
            self._initialized = True
        if self.training:
            return self.train_one_batch(*input, **kwargs)
        return self.forward(*input, **kwargs)

    def set_optimizer(self, optimizer):
        self._optimizer = optimizer

    @property
    def optimizer(self):
        return self._optimizer

    def set_states(self, states: dict):
        """Load parameters by the JAX package's names and layouts.

        This is the carry-across function: ``states`` is what
        ``singa_tpu``'s ``Model.get_states()`` returns (as numpy arrays),
        unchanged, so both packages can compute from the same weights.
        Every name must match: an unknown or missing name raises."""
        super().set_states(states)
