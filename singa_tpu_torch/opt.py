"""Optimizers and schedules (counterpart of ``singa_tpu/opt.py``),
written to SINGA's formulas rather than taken from ``torch.optim``.

``Optimizer.__call__(loss)`` consumes the ``autograd.backward`` generator
and applies one update per ``(param, grad)`` pair in float32, then
advances the step counter.  Optimizer state is keyed
``"{param name}:{slot}"`` as in the JAX package (``:momentum`` for SGD,
``:m``/``:v`` for Adam and AdamW, ``:sq`` for RMSProp, ``:accum`` for
AdaGrad, ``:m`` for Lion), so states compare and load name for name.
Updates rewrite the parameter in place.

The step counter is a float32 scalar tensor on the parameters' device,
as in the JAX package (``singa_tpu/opt.py:109``).  Every schedule but a
constant is computed on the device from it, once a step for every
parameter (``Optimizer.hyper``), as are Adam's bias corrections: a training step captured in a CUDA graph
(``model.Model.compile(use_graph=True)``) then follows the schedule on
every replay, where a Python float would be frozen into the graph.  A
``Constant`` returns a Python float, which launches nothing.  State (the
counter and every ``_state`` buffer) is created by a step's first, eager
run and rewritten in place afterwards, so a captured graph never holds a
stale tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from . import autograd
from .layer import param_name
from .observe import trace as _trace
from .observe.registry import registry as _obs_registry

__all__ = ["DecayScheduler", "Constant", "ExponentialDecay", "StepDecay",
           "Optimizer", "SGD", "RMSProp", "AdaGrad", "Adam", "AdamW",
           "Lion"]


# ------------------------------------------------------------- schedules


class DecayScheduler:
    """A hyperparameter as a function of the step counter."""

    def __init__(self, init_value):
        self.init_value = float(init_value)

    def __call__(self, step):
        raise NotImplementedError


class Constant(DecayScheduler):
    """Constant schedule: the value as a Python float."""

    def __call__(self, step):
        return self.init_value


def _as_step(step):
    """The step as a float32 tensor (the counter itself, on its device)."""
    if isinstance(step, torch.Tensor):
        return step.float()
    return torch.tensor(float(step), dtype=torch.float32)


class ExponentialDecay(DecayScheduler):
    """``init · decay_rate ^ (step / decay_steps)``, the exponent floored
    when ``staircase``; a float32 tensor on the step's device."""

    def __init__(self, init_value, decay_steps, decay_rate, staircase=False):
        super().__init__(init_value)
        self.decay_steps = int(decay_steps)
        self.decay_rate = float(decay_rate)
        self.staircase = bool(staircase)

    def __call__(self, step):
        p = _as_step(step) / self.decay_steps
        if self.staircase:
            p = torch.floor(p)
        return self.init_value * torch.pow(self.decay_rate, p)


class StepDecay(DecayScheduler):
    """``init · gamma ^ floor(step / step_size)``; a float32 tensor on the
    step's device."""

    def __init__(self, init_value, step_size, gamma=0.1):
        super().__init__(init_value)
        self.step_size = int(step_size)
        self.gamma = float(gamma)

    def __call__(self, step):
        k = torch.floor(_as_step(step) / self.step_size)
        return self.init_value * torch.pow(self.gamma, k)


def _as_scheduler(v):
    return v if isinstance(v, DecayScheduler) else Constant(v)


def _is_zero(sched):
    """A constant 0: the term it scales is left out, as the JAX package
    leaves out SGD's momentum."""
    return isinstance(sched, Constant) and sched.init_value == 0.0


class Optimizer:
    """``apply(name, param, grad)`` updates one parameter;
    ``__call__(loss)`` runs backward and applies every update; ``step()``
    advances the counter the schedules read.  ``state_slots``: the
    suffixes of this optimizer's state names; ``scheduled``: the
    hyperparameters that may be schedules."""

    state_slots = ()
    scheduled = ("lr",)

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

    def state_tensors(self) -> dict:
        """Every persistent state tensor by name, the step counter under
        ``"__step_counter__"`` (what ``Model.save_states`` writes)."""
        d = dict(self._states)
        d["__step_counter__"] = self.step_counter
        return d

    def get_states(self) -> dict:
        """``{name: numpy array}``, step counter under
        ``"__step_counter__"``."""
        out = {k: v.detach().cpu().numpy() for k, v in self._states.items()}
        out["__step_counter__"] = np.asarray(float(self.step_counter),
                                             np.float32)
        return out

    def set_states(self, states: dict):
        """Load states (arrays or tensors) by name; tensors that exist are
        overwritten in place (a captured step keeps reading them), the
        others are kept until the first step moves them to their
        parameter's device."""
        for k, v in states.items():
            src = v if isinstance(v, torch.Tensor) else \
                torch.from_numpy(np.array(v))
            src = src.to(torch.float32)
            if k == "__step_counter__":
                self.step_counter.copy_(src.reshape(()))
            elif k in self._states:
                self._states[k].copy_(src)
            else:
                self._states[k] = src.clone()

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
                hp = self.hyper()
                for p, g in pairs:
                    self.apply(self._param_name(p), p, g, hp)
                self.step()
            sp.set(params=len(pairs))
        self._m_updates.inc()

    def step(self):
        self.step_counter.add_(1.0)

    def hyper(self) -> dict:
        """Each of ``scheduled`` at the current step (a Python float for a
        constant, else a tensor on the counter's device), evaluated once
        a step for every parameter's update."""
        return {n: getattr(self, n)(self.step_counter)
                for n in self.scheduled}

    def apply(self, param_name, param, grad, hp=None):
        """Update one parameter; ``hp`` is ``hyper()`` (computed here
        when not given)."""
        raise NotImplementedError

    @staticmethod
    def _assign(param, new_value):
        param.copy_(new_value.to(param.dtype))


class SGD(Optimizer):
    """SINGA's SGD: ``g += wd·p``; with momentum
    ``buf = mom·buf + (1 − damp)·g`` and the step uses ``buf`` (or
    ``g + mom·buf`` under nesterov); ``p -= lr·step``.  Any of the four
    hyperparameters may be a schedule."""

    def __init__(self, lr=0.1, momentum=0.0, dampening=0.0, weight_decay=0.0,
                 nesterov=False, clip_norm=None):
        super().__init__(lr, clip_norm=clip_norm)
        self.momentum = _as_scheduler(momentum)
        self.dampening = _as_scheduler(dampening)
        self.weight_decay = _as_scheduler(weight_decay)
        self.nesterov = bool(nesterov)
        if nesterov and _is_zero(self.momentum):
            raise ValueError("nesterov requires momentum > 0")

    scheduled = ("lr", "momentum", "dampening", "weight_decay")

    @property
    def state_slots(self):
        return () if _is_zero(self.momentum) else ("momentum",)

    def apply(self, param_name, param, grad, hp=None):
        hp = self.hyper() if hp is None else hp
        lr, mom, wd = hp["lr"], hp["momentum"], hp["weight_decay"]
        damp = hp["dampening"]
        g = grad.float()
        p = param.float()
        if not _is_zero(self.weight_decay):
            g = g + wd * p
        if not _is_zero(self.momentum):
            buf = self._state(f"{param_name}:momentum", param)
            if isinstance(damp, torch.Tensor):
                buf.mul_(mom).add_((1.0 - damp) * g)
            else:
                buf.mul_(mom).add_(g, alpha=1.0 - damp)
            g = g + mom * buf if self.nesterov else buf
        self._assign(param, p - lr * g)


class RMSProp(Optimizer):
    """SINGA's RMSProp: ``sq = rho·sq + (1 − rho)·g²``,
    ``p -= lr·g/√(sq + ε)``; coupled weight decay."""

    state_slots = ("sq",)
    scheduled = ("lr", "weight_decay")

    def __init__(self, lr=0.1, rho=0.9, epsilon=1e-8, weight_decay=0.0,
                 clip_norm=None):
        super().__init__(lr, clip_norm=clip_norm)
        self.rho = float(rho)
        self.epsilon = float(epsilon)
        self.weight_decay = _as_scheduler(weight_decay)

    def apply(self, param_name, param, grad, hp=None):
        hp = self.hyper() if hp is None else hp
        lr, wd = hp["lr"], hp["weight_decay"]
        g = grad.float()
        p = param.float()
        if not _is_zero(self.weight_decay):
            g = g + wd * p
        v = self._state(f"{param_name}:sq", param)
        v.mul_(self.rho).add_(g * g, alpha=1 - self.rho)
        self._assign(param, p - lr * g / torch.sqrt(v + self.epsilon))


class AdaGrad(Optimizer):
    """SINGA's AdaGrad: ``accum += g²``, ``p -= lr·g/√(accum + ε)``;
    coupled weight decay."""

    state_slots = ("accum",)
    scheduled = ("lr", "weight_decay")

    def __init__(self, lr=0.1, epsilon=1e-8, weight_decay=0.0,
                 clip_norm=None):
        super().__init__(lr, clip_norm=clip_norm)
        self.epsilon = float(epsilon)
        self.weight_decay = _as_scheduler(weight_decay)

    def apply(self, param_name, param, grad, hp=None):
        hp = self.hyper() if hp is None else hp
        lr, wd = hp["lr"], hp["weight_decay"]
        g = grad.float()
        p = param.float()
        if not _is_zero(self.weight_decay):
            g = g + wd * p
        h = self._state(f"{param_name}:accum", param)
        h.add_(g * g)
        self._assign(param, p - lr * g / torch.sqrt(h + self.epsilon))


class Adam(Optimizer):
    """SINGA's Adam with bias correction; coupled weight decay
    (``g += wd·p``)."""

    state_slots = ("m", "v")
    scheduled = ("lr", "weight_decay")

    def __init__(self, lr=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
                 weight_decay=0.0, clip_norm=None):
        super().__init__(lr, clip_norm=clip_norm)
        self.beta_1 = float(beta_1)
        self.beta_2 = float(beta_2)
        self.epsilon = float(epsilon)
        self.weight_decay = _as_scheduler(weight_decay)

    def hyper(self) -> dict:
        """Also the bias corrections ``1 − β^t`` at ``t`` = step + 1."""
        hp = super().hyper()
        t = self.step_counter + 1.0
        hp["c1"], hp["c2"] = 1 - self.beta_1 ** t, 1 - self.beta_2 ** t
        return hp

    def _direction(self, param_name, param, g, hp):
        """Bias-corrected ``m̂/(√v̂ + ε)``, shared with AdamW."""
        m = self._state(f"{param_name}:m", param)
        v = self._state(f"{param_name}:v", param)
        m.mul_(self.beta_1).add_(g, alpha=1 - self.beta_1)
        v.mul_(self.beta_2).add_(g * g, alpha=1 - self.beta_2)
        return (m / hp["c1"]) / ((v / hp["c2"]).sqrt() + self.epsilon)

    def apply(self, param_name, param, grad, hp=None):
        hp = self.hyper() if hp is None else hp
        lr, wd = hp["lr"], hp["weight_decay"]
        g = grad.float()
        p = param.float()
        if not _is_zero(self.weight_decay):
            g = g + wd * p
        self._assign(param, p - lr * self._direction(param_name, param, g,
                                                     hp))


class AdamW(Adam):
    """Adam with decoupled weight decay: ``p -= lr·(direction + wd·p)``."""

    def apply(self, param_name, param, grad, hp=None):
        hp = self.hyper() if hp is None else hp
        lr, wd = hp["lr"], hp["weight_decay"]
        g = grad.float()
        p = param.float()
        self._assign(param, p - lr * (self._direction(param_name, param, g,
                                                      hp) + wd * p))


class Lion(Optimizer):
    """Lion: ``p -= lr·(sign(β1·m + (1 − β1)·g) + wd·p)``, then
    ``m = β2·m + (1 − β2)·g``; one state a parameter, decoupled decay."""

    state_slots = ("m",)
    scheduled = ("lr", "weight_decay")

    def __init__(self, lr=1e-4, beta_1=0.9, beta_2=0.99, weight_decay=0.0,
                 clip_norm=None):
        super().__init__(lr, clip_norm=clip_norm)
        self.beta_1 = float(beta_1)
        self.beta_2 = float(beta_2)
        self.weight_decay = _as_scheduler(weight_decay)

    def apply(self, param_name, param, grad, hp=None):
        hp = self.hyper() if hp is None else hp
        lr, wd = hp["lr"], hp["weight_decay"]
        g = grad.float()
        p = param.float()
        m = self._state(f"{param_name}:m", param)
        update = torch.sign(self.beta_1 * m + (1 - self.beta_1) * g)
        if not _is_zero(self.weight_decay):
            update = update + wd * p
        self._assign(param, p - lr * update)
        m.mul_(self.beta_2).add_(g, alpha=1 - self.beta_2)


# DistOpt lives with the communicator; re-exported here, as the reference
# imports it (``from singa import opt; opt.DistOpt(sgd)``)
def __getattr__(name):
    if name == "DistOpt":
        from .parallel.dist_opt import DistOpt

        return DistOpt
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
