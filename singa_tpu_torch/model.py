"""``Model`` API (counterpart of ``singa_tpu/model.py:121-336``):
``compile(inputs, is_train, use_graph, sequential)``, a user-overridden
``train_one_batch``, ``set_optimizer``, ``train``/``eval``,
``train_n_batches`` and ``get_states``/``set_states`` under the JAX
package's state names.

Graph mode (``compile(..., use_graph=True)``) runs the training step
through :class:`_GraphRunner`, the counterpart of the JAX package's
``_GraphRunner`` (``singa_tpu/model.py:529``), with a CUDA graph where the
JAX package has ``jax.jit`` (``graphs.py``).  Steps are keyed as the JAX
package keys its executables: the shape, dtype and device of each tensor
argument, the value of each other argument, the amp compute dtype and
the training flag.  For each key the first call runs eagerly, as a real
step (it builds the kernels, creates the optimizer's state and lets
cuBLAS and cuDNN choose their algorithms: the reference, too, "executes
its first graph iteration eagerly while recording"); the second copies
its inputs into static buffers and captures the step, which is then done
by one replay; every later call copies its inputs and replays.  So each
call is exactly one optimizer step, as in eager mode.  Outputs come back
as fresh tensors (detached copies of the graph's static outputs), as the
JAX step returns new arrays.  ``graph.cache_miss`` counts first calls,
``graph.cache_hit`` the others, ``train.steps`` every step.  On the CPU
the same runner runs the step eagerly through the same keys, buffers and
counts.  ``set_optimizer`` drops every captured step.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from . import amp, graphs, layer
from .observe.registry import registry as _obs_registry

__all__ = ["Model"]


def _detached_copy(t):
    return t.detach().clone() if isinstance(t, torch.Tensor) else t


class _Entry:
    """One step signature: static input buffers and, from the second
    call on, the prepared step."""

    def __init__(self):
        self.args = self.kwargs = None
        self.step = None

    def load(self, args, kwargs):
        """Copy this call's tensors into the static buffers (made at the
        first load)."""
        if self.args is None:
            self.args, self.kwargs = pytree.tree_map(_detached_copy,
                                                     (args, kwargs))
            return
        for dst, src in zip(pytree.tree_leaves((self.args, self.kwargs)),
                            pytree.tree_leaves((args, kwargs))):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)


class _GraphRunner:
    """Prepares and replays ``train_one_batch`` (module docstring)."""

    def __init__(self, model):
        self.model = model
        self._entries = {}
        self._pool = None
        reg = _obs_registry()
        self._m_hit = reg.counter(
            "graph.cache_hit", help="graph-step replays")
        self._m_miss = reg.counter(
            "graph.cache_miss", help="graph-step first calls (new signature)")
        self._m_steps = reg.counter(
            "train.steps", help="optimizer steps dispatched via graph mode")

    def clear(self):
        self._entries.clear()

    def _key(self, args, kwargs):
        def sig(v):
            if isinstance(v, torch.Tensor):
                return ("T", tuple(v.shape), str(v.dtype), str(v.device))
            return ("V", v)

        return (tuple(sig(a) for a in args),
                tuple(sorted((k, sig(v)) for k, v in kwargs.items())),
                (str(amp._compute_dtype), self.model.training))

    def step(self, args, kwargs):
        """One optimizer step through the entry of this signature."""
        m = self.model
        dev = m.device.torch_device
        self._m_steps.inc()
        key = self._key(args, kwargs)
        entry = self._entries.get(key)
        if entry is None:
            self._m_miss.inc()
            self._entries[key] = _Entry()
            out = graphs.warm(lambda: m.train_one_batch(*args, **kwargs),
                              dev)
            return pytree.tree_map(_detached_copy, out)
        self._m_hit.inc()
        entry.load(args, kwargs)
        if entry.step is None:
            if dev.type == "cuda" and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            entry.step = graphs.Step(
                lambda: m.train_one_batch(*entry.args, **entry.kwargs), dev,
                pool=self._pool, generators=(m.device.generator,)
                if dev.type == "cuda" else ())
        return pytree.tree_map(_detached_copy, entry.step())


class Model(layer.Layer):
    """Subclass and override ``forward`` and ``train_one_batch``."""

    def __init__(self):
        super().__init__()
        self._optimizer = None
        self.graph_mode = False
        self.sequential = False
        self.device = None
        self._graph_runner = None

    def compile(self, inputs, is_train=True, use_graph=False,
                sequential=False):
        """Create the parameters with one forward over ``inputs`` (no
        gradient, no dropout), name them, and set the mode.  The device is
        that of ``inputs[0]``; ``use_graph`` routes training steps through
        the graph runner (module docstring)."""
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
        self._graph_runner = _GraphRunner(self) if self.graph_mode else None

    def forward(self, *input):
        raise NotImplementedError

    def train_one_batch(self, *input, **kwargs):
        raise NotImplementedError

    def __call__(self, *input, **kwargs):
        """Training mode: one ``train_one_batch`` (through the graph
        runner in graph mode); eval mode: ``forward``."""
        if not self._initialized:
            with torch.no_grad():
                self.initialize(*input)
            self._initialized = True
        if self.training:
            if self._graph_runner is not None:
                return self._graph_runner.step(input, kwargs)
            return self.train_one_batch(*input, **kwargs)
        return self.forward(*input, **kwargs)

    def train_n_batches(self, *args, n_steps=None, **kwargs):
        """K training steps in one call (``singa_tpu/model.py:200-240``),
        each a replay of the captured step.  Stacked mode (default): every
        tensor argument carries a leading steps axis K and step k takes
        slice k.  Repeat mode (``n_steps=K``): the same per-step batch
        feeds all K steps.  Other arguments are shared by every step.
        Returns ``train_one_batch``'s outputs with a leading K axis on
        every tensor.  Requires graph mode and training mode."""
        if self._graph_runner is None:
            raise ValueError(
                "train_n_batches requires compile(..., use_graph=True) "
                "— the multi-step dispatch only exists for the captured "
                "graph step")
        if not self.training:
            raise ValueError(
                "train_n_batches requires training mode (call "
                "model.train() first); the model is in eval mode")
        ts = [a for a in (*args, *kwargs.values())
              if isinstance(a, torch.Tensor)]
        if not ts:
            raise ValueError("train_n_batches needs at least one Tensor "
                             "input (the leading dim is the step count)")
        run = self._graph_runner.step
        if n_steps is not None:
            if int(n_steps) < 1:
                raise ValueError(f"n_steps must be >= 1, got {n_steps}")
            outs = [run(args, kwargs) for _ in range(int(n_steps))]
        else:
            if any(t.dim() == 0 for t in ts):
                raise ValueError(
                    "a 0-d Tensor argument cannot carry a steps axis; "
                    "pass it as a plain Python scalar or use repeat mode "
                    "(n_steps=K)")
            k = ts[0].shape[0]
            for t in ts:
                if t.shape[0] != k:
                    raise ValueError(
                        f"all Tensor inputs must share the leading steps "
                        f"dim: got {t.shape[0]} vs {k}")
            if k < 1:
                raise ValueError(f"steps dim must be >= 1, got {k}")

            def at(i):
                return pytree.tree_map(
                    lambda a: a[i] if isinstance(a, torch.Tensor) else a,
                    (args, kwargs))

            outs = [run(*at(i)) for i in range(k)]
        return pytree.tree_map(
            lambda *xs: torch.stack(xs)
            if isinstance(xs[0], torch.Tensor) else xs[0], *outs)

    def set_optimizer(self, optimizer):
        """Set the optimizer; captured steps hold the old one's updates,
        so they are dropped."""
        self._optimizer = optimizer
        if self._graph_runner is not None:
            self._graph_runner.clear()

    @property
    def optimizer(self):
        return self._optimizer

    def set_states(self, states: dict):
        """Load parameters by the JAX package's names and layouts.

        This is the carry-across function: ``states`` is what
        ``singa_tpu``'s ``Model.get_states()`` returns (as numpy arrays),
        unchanged, so both packages can compute from the same weights.
        Every name must match: an unknown or missing name raises.  The
        tensors are overwritten in place, so captured steps keep reading
        them."""
        super().set_states(states)
