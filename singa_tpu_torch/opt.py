"""Optimizers (counterpart of ``singa_tpu/opt.py:84-375``), written to
SINGA's formulas rather than taken from ``torch.optim``.

``Optimizer.__call__(loss)`` consumes the ``autograd.backward`` generator
and applies one update per ``(param, grad)`` pair in float32, then
advances the step counter.  Optimizer state is keyed
``"{param name}:momentum"``, ``":m"``, ``":v"`` as in the JAX package, so
states compare name for name.  Updates rewrite the parameter in place.

The step counter is a float32 scalar tensor on the parameters' device,
as in the JAX package (``singa_tpu/opt.py:109``), and Adam's bias
correction is computed from it on the device: a training step captured
in a CUDA graph (``model.Model.compile(use_graph=True)``) then advances
it and corrects by it on every replay.  State (the counter and every
``_state`` buffer) is created by a step's first, eager run and rewritten
in place afterwards, so a captured graph never holds a stale tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from . import autograd
from .layer import param_name
from .observe import trace as _trace
from .observe.registry import registry as _obs_registry

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "Constant"]


class Constant:
    """Constant schedule (SINGA's ``opt.Constant``)."""

    def __init__(self, init_value):
        self.init_value = float(init_value)

    def __call__(self, step):
        return self.init_value


def _as_scheduler(v):
    if isinstance(v, Constant):
        return v
    if isinstance(v, (int, float)):
        return Constant(v)
    raise NotImplementedError(
        f"schedule {type(v).__name__}: only constant hyperparameters are "
        f"ported so far")


class Optimizer:
    """``apply(name, param, grad)`` updates one parameter;
    ``__call__(loss)`` runs backward and applies every update; ``step()``
    advances the counter the schedules read."""

    def __init__(self, lr, clip_norm=None):
        self.lr = _as_scheduler(lr)
        if clip_norm is not None and clip_norm <= 0:
            raise ValueError(f"clip_norm must be > 0, got {clip_norm}")
        self.clip_norm = None if clip_norm is None else float(clip_norm)
        self.step_counter = torch.zeros((), dtype=torch.float32)
        self._m_updates = _obs_registry().counter(
            "opt.updates", help="optimizer update passes (one per step)",
            optimizer=type(self).__name__)
        self._states = {}  # name -> float32 tensor
        self._name_of = {}  # id(param) -> name

    # -- naming / state ----------------------------------------------------
    def _param_name(self, param) -> str:
        pid = id(param)
        if pid not in self._name_of:
            n = param_name(param) or f"param_{len(self._name_of)}"
            if n in self._name_of.values():
                n = f"{n}_{pid:x}"
            self._name_of[pid] = n
        return self._name_of[pid]

    def _state(self, key, like) -> torch.Tensor:
        t = self._states.get(key)
        if t is None:
            t = self._states[key] = torch.zeros(
                like.shape, dtype=torch.float32, device=like.device)
        elif t.device != like.device:
            t = self._states[key] = t.to(like.device)
        return t

    def _counter(self, device) -> torch.Tensor:
        """The step counter, moved to ``device`` at the first step."""
        if self.step_counter.device != device:
            self.step_counter = self.step_counter.to(device)
        return self.step_counter

    def get_states(self) -> dict:
        """``{name: numpy array}``, step counter under
        ``"__step_counter__"``."""
        out = {k: v.detach().cpu().numpy() for k, v in self._states.items()}
        out["__step_counter__"] = np.asarray(float(self.step_counter),
                                             np.float32)
        return out

    def set_states(self, states: dict):
        """Load states by name; tensors that exist are overwritten in
        place (a captured step keeps reading them)."""
        for k, v in states.items():
            src = torch.as_tensor(np.asarray(v), dtype=torch.float32)
            if k == "__step_counter__":
                self.step_counter.copy_(src.reshape(()))
            elif k in self._states:
                self._states[k].copy_(src)
            else:
                self._states[k] = src

    # -- gradient clipping -------------------------------------------------
    def _clip_pairs(self, pairs):
        """Scale every grad by ``min(1, clip_norm/||g||_global)``."""
        sq = sum(g.float().square().sum() for _, g in pairs)
        scale = torch.clamp(self.clip_norm / torch.clamp(sq.sqrt(),
                                                         min=1e-12), max=1.0)
        return [(p, (g.float() * scale).to(g.dtype)) for p, g in pairs]

    # -- the SINGA API -----------------------------------------------------
    def __call__(self, loss):
        self.backward_and_update(loss)

    def backward_and_update(self, loss):
        with _trace.span("opt/update", cat="train",
                         optimizer=type(self).__name__) as sp:
            pairs = list(autograd.backward(loss))
            if self.clip_norm is not None:
                pairs = self._clip_pairs(pairs)
            with torch.no_grad():
                if pairs:
                    self._counter(pairs[0][0].device)
                for p, g in pairs:
                    self.apply(self._param_name(p), p, g)
                self.step()
            sp.set(params=len(pairs))
        self._m_updates.inc()

    def step(self):
        self.step_counter.add_(1.0)

    def apply(self, param_name, param, grad):
        raise NotImplementedError

    @staticmethod
    def _assign(param, new_value):
        param.copy_(new_value.to(param.dtype))


class SGD(Optimizer):
    """SINGA's SGD: ``g += wd·p``; with momentum
    ``buf = mom·buf + (1 − damp)·g`` and the step uses ``buf`` (or
    ``g + mom·buf`` under nesterov); ``p -= lr·step``."""

    def __init__(self, lr=0.1, momentum=0.0, dampening=0.0, weight_decay=0.0,
                 nesterov=False, clip_norm=None):
        super().__init__(lr, clip_norm=clip_norm)
        self.momentum = _as_scheduler(momentum)
        self.dampening = _as_scheduler(dampening)
        self.weight_decay = _as_scheduler(weight_decay)
        self.nesterov = bool(nesterov)
        if nesterov and self.momentum.init_value == 0.0:
            raise ValueError("nesterov requires momentum > 0")

    def apply(self, param_name, param, grad):
        step = self.step_counter
        lr = self.lr(step)
        mom = self.momentum(step)
        damp = self.dampening(step)
        wd = self.weight_decay(step)
        g = grad.float()
        p = param.float()
        if wd:
            g = g + wd * p
        if self.momentum.init_value != 0.0:
            buf = self._state(f"{param_name}:momentum", param)
            buf.mul_(mom).add_(g, alpha=1.0 - damp)
            g = g + mom * buf if self.nesterov else buf
        self._assign(param, p - lr * g)


class Adam(Optimizer):
    """SINGA's Adam with bias correction; coupled weight decay
    (``g += wd·p``)."""

    def __init__(self, lr=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
                 weight_decay=0.0, clip_norm=None):
        super().__init__(lr, clip_norm=clip_norm)
        self.beta_1 = float(beta_1)
        self.beta_2 = float(beta_2)
        self.epsilon = float(epsilon)
        self.weight_decay = _as_scheduler(weight_decay)

    def _direction(self, param_name, param, g, t):
        """Bias-corrected ``m̂/(√v̂ + ε)``, shared with AdamW."""
        m = self._state(f"{param_name}:m", param)
        v = self._state(f"{param_name}:v", param)
        m.mul_(self.beta_1).add_(g, alpha=1 - self.beta_1)
        v.mul_(self.beta_2).add_(g * g, alpha=1 - self.beta_2)
        m_hat = m / (1 - self.beta_1 ** t)
        v_hat = v / (1 - self.beta_2 ** t)
        return m_hat / (v_hat.sqrt() + self.epsilon)

    def apply(self, param_name, param, grad):
        step = self.step_counter
        lr = self.lr(step)
        wd = self.weight_decay(step)
        g = grad.float()
        p = param.float()
        if wd:
            g = g + wd * p
        self._assign(param, p - lr * self._direction(param_name, param, g,
                                                     step + 1.0))


class AdamW(Adam):
    """Adam with decoupled weight decay: ``p -= lr·(direction + wd·p)``."""

    def apply(self, param_name, param, grad):
        step = self.step_counter
        lr = self.lr(step)
        wd = self.weight_decay(step)
        g = grad.float()
        p = param.float()
        self._assign(param, p - lr * (self._direction(param_name, param, g,
                                                      step + 1.0) + wd * p))
