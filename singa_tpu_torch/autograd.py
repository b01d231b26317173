"""Autograd ops (counterpart of ``singa_tpu/autograd.py``).

Torch autograd takes the place of SINGA's tape: each op is a plain
function on ``torch.Tensor`` with the JAX package's semantics (dtype
rules under amp included), differentiable through torch autograd; where
the reference's gradient differs from torch's, the op is a
``torch.autograd.Function`` with the reference's VJP
(``_SoftMaxCrossEntropy``).  ``backward(loss)`` keeps SINGA's generator
contract, yielding ``(param, grad)`` for every leaf tensor that requires
a gradient, and ``gradients(y)`` collects it into a dict.

``training`` is SINGA's tape switch.  ``set_training(False)`` turns
torch's grad mode off in the calling thread, so ops record nothing (the
reference records no tape then), and the functional ``dropout`` is the
identity unless told otherwise; ``set_training(True)`` turns both on.
Layers and models read their own ``Module.training``, which
``Model.train``/``eval`` set, not this flag.

``exporting`` is SINGA's export flag (``set_exporting``, or the
:class:`ExportRecord` that ``sonnx.to_onnx`` opens).  While it is on,
every op that the JAX package's tape records under a name appends an
:class:`Operation` to the open record: the op's name (``Matmul``,
``AddBias``, ``Conv2d``, ``TPAttention``, ``RNN[l0d1]``...), its
``params`` under the JAX op's keys, its input tensors as the JAX tape's
``src`` edges and its outputs, so ``sonnx``'s walk reads the record as
the JAX walk reads the tape.  Torch autograd stays the gradient engine:
there is no tape while training, and outside export an op pays one test
of the flag.  ``_op(fn, *xs, _name=..., **params)`` applies
``fn(*xs, **params)`` as such a recorded op, for scripts as for the
package.

The record also follows lineage: while it is open, a
``TorchFunctionMode`` marks every tensor that a torch function computed
from an export input, a parameter or a recorded output, naming the
function.  A marked tensor that no op recorded is a value the export
cannot write as a graph (``sonnx`` raises, naming the function), where an
unmarked leaf (a position-id ``arange``) is a constant it may bake.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.overrides import TorchFunctionMode, resolve_name
from torch.utils import _pytree as pytree

from . import amp

__all__ = [
    "set_training", "set_exporting", "Operation", "Dummy",
    "infer_dependency", "ExportRecord", "backward", "gradients",
    "checkpoint_op",
    "relu", "leakyrelu", "elu", "selu", "gelu", "repeat_kv", "sigmoid",
    "tanh", "softplus", "softsign", "relu6", "swish", "hardsigmoid",
    "abs", "exp", "log", "sqrt", "square", "sign", "sin", "cos",
    "negative", "reciprocal", "clip", "add", "sub", "mul", "div", "pow",
    "mul_scalar", "minimum", "maximum", "matmul", "add_bias", "gemm",
    "reshape", "flatten", "transpose", "cat", "concat", "split", "squeeze",
    "unsqueeze", "gather", "mean", "reduce_mean", "reduce_sum", "sum",
    "softmax", "log_softmax", "cross_entropy", "softmax_cross_entropy",
    "mse_loss", "binary_cross_entropy", "nll_loss", "dropout", "identity",
    "erf", "cast", "equal", "greater", "less", "where_op", "layer_norm",
    "embedding",
]

#: SINGA's tape switch (module docstring)
training = False


def set_training(flag: bool):
    """Set ``training`` and torch's grad mode in this thread."""
    global training
    training = bool(flag)
    torch.set_grad_enabled(training)


# ------------------------------------------------------------ export record

#: SINGA's export flag (module docstring)
exporting = False
#: the record of the export in progress (``exporting`` is True iff set)
_record = None


def set_exporting(flag: bool):
    """Turn the export flag on (opening a fresh :class:`ExportRecord`,
    without lineage marks) or off (dropping the open record)."""
    global exporting, _record
    _record = ExportRecord(track_lineage=False) if flag else None
    exporting = _record is not None


class Operation:
    """One recorded op (module docstring).  ``src`` holds ``(src_op,
    id(x), x, stores_grad)`` per tensor input, as the JAX tape does:
    ``src_op`` is the recorded op that made x, a :class:`Dummy` for a leaf
    that requires grad, or None.  ``y_id2idx`` maps ``id(y)`` of each
    output to its index; ``outputs`` holds the outputs themselves, so no
    id is reused while the record lives."""

    op_count = 0

    def __init__(self, name=None):
        if name is None:
            name = f"{type(self).__name__}#{Operation.op_count}"
            Operation.op_count += 1
        self.name = name
        self.params = {}
        self.src = []
        self.y_id2idx = {}
        self.outputs = ()
        self.requires_grad = False

    def _record(self, xs, ys):
        """Append this op to the open record with inputs ``xs`` and outputs
        ``ys`` (a tensor or a tuple); returns the outputs, each a fresh
        tensor object (an output that is an input, or that another op
        already made, is replaced by a view of itself)."""
        rec = _record
        single = not isinstance(ys, tuple)
        outs = tuple(rec.fresh(y, xs) for y in ((ys,) if single else ys))
        ts = [x for x in xs if isinstance(x, torch.Tensor)]
        self.src = [(rec.creator(x), id(x), x, x.requires_grad and x.is_leaf)
                    for x in ts]
        self.requires_grad = any(x.requires_grad for x in ts)
        self.y_id2idx = {id(y): i for i, y in enumerate(outs)}
        self.outputs = outs
        rec.add(self)
        return outs[0] if single else outs


class Dummy(Operation):
    """Creator of a leaf tensor that requires grad (a parameter), as the
    JAX tape's ``Dummy``."""

    def __init__(self, tensor, name=None):
        super().__init__(name)
        self.y_id2idx = {id(tensor): 0}
        self.outputs = (tensor,)
        self.tensor = tensor
        self.requires_grad = tensor.requires_grad


def infer_dependency(op) -> dict:
    """For each recorded op reachable from ``op``, how many consumers
    read it (the JAX package's ``infer_dependency``)."""
    counts = {op: 0}
    queue = deque([op])
    while queue:
        cur = queue.popleft()
        for src_op, _, _, _ in cur.src:
            if src_op is None:
                continue
            if src_op not in counts:
                counts[src_op] = 0
                queue.append(src_op)
            counts[src_op] += 1
    return counts


#: torch functions whose tensor result depends on an input's shape, dtype
#: or device only, never on its values
_SHAPE_ONLY = frozenset(
    f"torch.{n}" for n in ("zeros_like", "ones_like", "empty_like",
                           "full_like", "rand_like", "randn_like",
                           "randint_like")) | frozenset(
    f"torch.Tensor.{n}" for n in ("new_zeros", "new_ones", "new_empty",
                                  "new_full"))


class _Lineage(TorchFunctionMode):
    """Marks the tensors computed from marked ones (module docstring)."""

    def __init__(self, rec):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        derived = self.rec.derived
        if not any(id(a) in derived for a in pytree.tree_leaves(
                (args, kwargs)) if isinstance(a, torch.Tensor)):
            return out
        try:
            name = resolve_name(func) or repr(func)
        except Exception:  # some slot wrappers have no resolvable name
            name = repr(func)
        if name in _SHAPE_ONLY:
            return out
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and id(t) not in derived:
                derived[id(t)] = (t, name)
        last = name.rpartition(".")[2]
        if (last.endswith("_") and not last.endswith("__")) \
                or last == "__setitem__":
            # written in place: its values are now this function's
            derived[id(args[0])] = (args[0], name)
        return out


class ExportRecord:
    """The record of one export (module docstring): ``ops`` in the order
    they ran, ``producer`` from ``id(output)`` to its op, and, with
    ``track_lineage``, ``derived`` from ``id(tensor)`` to ``(tensor,
    torch function)`` for the tensors computed from ``roots``.  Used as a
    context manager it sets the export flag and, with lineage, pushes the
    marking mode; it holds every tensor it names until it is dropped."""

    def __init__(self, roots=(), track_lineage=True):
        self.ops = []
        self.producer = {}
        self.dummies = {}
        self.track_lineage = bool(track_lineage)
        self.derived = {id(t): (t, "input") for t in roots}
        self._mode = None
        self._prev = None

    def add(self, op):
        self.ops.append(op)
        for y in op.outputs:
            self.producer[id(y)] = op
            self.derived.setdefault(id(y), (y, op.name))

    def creator(self, x):
        op = self.producer.get(id(x))
        if op is not None:
            return op
        if x.requires_grad and x.is_leaf:
            d = self.dummies.get(id(x))
            if d is None:
                d = self.dummies[id(x)] = Dummy(x)
            return d
        return None

    def fresh(self, y, xs):
        if isinstance(y, torch.Tensor) and (
                id(y) in self.producer or any(y is x for x in xs)):
            return y.view_as(y)
        return y

    def lineage_of(self, t):
        """The torch function that computed ``t`` from a root, or None if
        ``t`` derives from none."""
        hit = self.derived.get(id(t))
        return None if hit is None else hit[1]

    def __enter__(self):
        global exporting, _record
        self._prev = (exporting, _record)
        _record, exporting = self, True
        if self.track_lineage:
            self._mode = _Lineage(self)
            self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        global exporting, _record
        if self._mode is not None:
            self._mode.__exit__(*exc)
            self._mode = None
        exporting, _record = self._prev
        return False


class _Func(Operation):
    """An op ``fn(*xs, **params)`` recorded under ``name`` while
    exporting (the JAX package's ``_Func``; torch autograd differentiates
    ``fn``)."""

    fn = None

    def __init__(self, fn=None, name=None, **params):
        super().__init__(name)
        if fn is not None:
            self.fn = fn
        self.params = params

    def __call__(self, *xs):
        ys = self.fn(*xs, **self.params)
        return self._record(xs, ys) if exporting else ys


def _op(fn, *xs, _name=None, **params):
    """``fn(*xs, **params)``, recorded under ``_name`` while exporting."""
    if not exporting:
        return fn(*xs, **params)
    return _Func(fn=fn, name=_name, **params)(*xs)


# ---------------------------------------------------------------- backward


def _leaves(loss: torch.Tensor) -> list:
    """Leaf tensors requiring grad that ``loss`` depends on, in the order
    the JAX package's backward yields them: a breadth-first walk from the
    loss that visits a node once every edge into it was walked, and takes
    a leaf as soon as its last edge is.  ``DistOpt``'s round-robin mode
    gives the i-th of them its turn, so the order is part of the
    contract."""
    root = loss.grad_fn
    deps, stack, seen = {}, [root], {root}
    while stack:
        for nxt, _ in stack.pop().next_functions:
            if nxt is None:
                continue
            deps[nxt] = deps.get(nxt, 0) + 1
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    out, ready = [], deque([root])
    while ready:
        for nxt, _ in ready.popleft().next_functions:
            if nxt is None:
                continue
            deps[nxt] -= 1
            if deps[nxt] == 0:
                var = getattr(nxt, "variable", None)  # AccumulateGrad
                if var is not None:
                    out.append(var)
                else:
                    ready.append(nxt)
    return out


def backward(loss: torch.Tensor, dy=None):
    """Yield ``(param, grad)`` for every leaf that requires grad and that
    ``loss`` depends on (SINGA's ``autograd.backward`` generator).  The
    gradients are computed in one ``torch.autograd.grad`` pass and then
    yielded; ``param.grad`` is left untouched."""
    if loss.grad_fn is None:
        return
    leaves = _leaves(loss)
    if dy is None:
        dy = torch.ones_like(loss)
    grads = torch.autograd.grad(loss, leaves, dy, allow_unused=True)
    for p, g in zip(leaves, grads):
        if g is not None:
            yield p, g


def gradients(y, dy=None):
    """Run backward and return ``{param: grad}``."""
    return {p: g for p, g in backward(y, dy)}


def checkpoint_op(fn, *xs, _name=None, **params):
    """``fn(*xs, **params)`` recomputed in backward instead of keeping its
    intermediates (``torch.utils.checkpoint``): memory traded for
    FLOPs.  Recorded under ``_name`` while exporting."""
    if exporting:
        return _op(fn, *xs, _name=_name, **params)
    return torch.utils.checkpoint.checkpoint(
        lambda *a: fn(*a, **params), *xs, use_reentrant=False)


# ------------------------------------------------------------ activations


def relu(x):
    return _op(F.relu, x, _name="ReLU")


def _leaky(x, a):
    return F.leaky_relu(x, a)


def leakyrelu(x, a=0.01):
    return _op(_leaky, x, _name="LeakyRelu", a=a)


def _elu(x, alpha):
    return F.elu(x, alpha)


def elu(x, alpha=1.0):
    return _op(_elu, x, _name="Elu", alpha=alpha)


def selu(x):
    return _op(F.selu, x, _name="SeLU")


def _gelu(x, approximate):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def gelu(x, approximate=True):
    """GELU; the tanh approximation by default, as ``jax.nn.gelu``."""
    return _op(_gelu, x, _name="Gelu", approximate=approximate)


def _repeat_kv(x, repeats):
    return torch.repeat_interleave(x, repeats, dim=1)


def repeat_kv(x, repeats):
    """GQA K/V broadcast: repeat (B, H_kv, S, D) heads ``repeats`` times
    along axis 1, element-interleaved (K/V head i serves query heads
    ``[i·repeats, (i+1)·repeats)``).  Recorded as ``RepeatKV``, which
    ``sonnx`` exports as Reshape/Tile/Reshape."""
    return _op(_repeat_kv, x, _name="RepeatKV", repeats=repeats)


def sigmoid(x):
    return _op(torch.sigmoid, x, _name="Sigmoid")


def tanh(x):
    return _op(torch.tanh, x, _name="Tanh")


def softplus(x):
    return _op(F.softplus, x, _name="SoftPlus")


def softsign(x):
    return _op(F.softsign, x, _name="SoftSign")


def relu6(x):
    return _op(F.relu6, x, _name="ReLU6")


def swish(x):
    return _op(F.silu, x, _name="Swish")


def _hardsigmoid(x, alpha, gamma):
    return torch.clamp(alpha * x + gamma, 0, 1)


def hardsigmoid(x, alpha=0.2, gamma=0.5):
    """``clip(alpha·x + gamma, 0, 1)`` (ONNX's HardSigmoid)."""
    return _op(_hardsigmoid, x, _name="HardSigmoid", alpha=alpha,
               gamma=gamma)


# ------------------------------------------------------------ elementwise


def abs(x):  # noqa: A001
    return _op(torch.abs, x, _name="Abs")


def exp(x):
    return _op(torch.exp, x, _name="Exp")


def log(x):
    return _op(torch.log, x, _name="Log")


def sqrt(x):
    return _op(torch.sqrt, x, _name="Sqrt")


def square(x):
    return _op(torch.square, x, _name="Square")


def sign(x):
    return _op(torch.sign, x, _name="Sign")


def sin(x):
    return _op(torch.sin, x, _name="Sin")


def cos(x):
    return _op(torch.cos, x, _name="Cos")


def negative(x):
    return _op(torch.neg, x, _name="Negative")


def reciprocal(x):
    return _op(torch.reciprocal, x, _name="Reciprocal")


def _clip(x, min, max):  # noqa: A002
    return torch.clamp(x, min, max)


def clip(x, min=None, max=None):  # noqa: A002
    return _op(_clip, x, _name="Clip", min=min, max=max)


def _add(a, b):
    return a + b


def _sub(a, b):
    return a - b


def _mul(a, b):
    return a * b


def _div(a, b):
    return a / b


def add(a, b):
    return _op(_add, a, b, _name="Add")


def sub(a, b):
    return _op(_sub, a, b, _name="Sub")


def mul(a, b):
    return _op(_mul, a, b, _name="Mul")


def div(a, b):
    return _op(_div, a, b, _name="Div")


def pow(a, b):  # noqa: A001
    return _op(torch.pow, a, b, _name="Pow")


def _mul_scalar(a, s):
    return a * s


def mul_scalar(a, s):
    """``a · s`` for a Python scalar ``s`` (recorded as ``MulScalar``, the
    scalar a parameter)."""
    return _op(_mul_scalar, a, _name="MulScalar", s=float(s))


def minimum(a, b):
    return _op(torch.minimum, a, b, _name="Min")


def maximum(a, b):
    return _op(torch.maximum, a, b, _name="Max")


def erf(x):
    return _op(torch.erf, x, _name="Erf")


def _torch_dtype(to):
    if isinstance(to, torch.dtype):
        return to
    if str(to) in ("bfloat16", "bf16"):
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(to))).dtype


def _cast(x, dt):
    return x.to(_torch_dtype(dt))


def cast(x, to):
    """``x`` as dtype ``to`` (a torch dtype, or a numpy dtype or name)."""
    return _op(_cast, x, _name="Cast", dt=to)


def _equal(a, b):
    return (a == b).float()


def _greater(a, b):
    return (a > b).float()


def _less(a, b):
    return (a < b).float()


def equal(a, b):
    return _op(_equal, a, b, _name="Equal")


def greater(a, b):
    return _op(_greater, a, b, _name="Greater")


def less(a, b):
    return _op(_less, a, b, _name="Less")


def _where(c, a, b):
    return torch.where(c != 0, a, b)


def where_op(cond, a, b):
    return _op(_where, cond, a, b, _name="Where")


def _identity(x):
    return x.view_as(x)


def identity(x):
    return _op(_identity, x, _name="Identity")


# ---------------------------------------------------- linear algebra, shape


def _matmul(a, b):
    return torch.matmul(*amp.cast_in(a, b))


def matmul(a, b):
    """``a @ b`` with the amp cast of both inputs (``autograd.py:446``)."""
    return _op(_matmul, a, b, _name="Matmul")


def _add_bias(x, b):
    return x + b.to(x.dtype)


def _add_bias_cols(x, b):
    return x + b.to(x.dtype)[:, None]


def add_bias(x, b, axis=0):
    """Bias add; the bias is cast to x's dtype so bf16 activations stay
    bf16 under amp (``autograd.py:453-459``)."""
    return _op(_add_bias if axis == 0 else _add_bias_cols, x, b,
               _name="AddBias")


def _gemm(A, B, *C, alpha, beta, transA, transB):
    a, b = amp.cast_in(A, B)
    a = a.T if transA else a
    b = b.T if transB else b
    y = alpha * torch.matmul(a, b)
    if C:
        y = y + beta * amp.cast_in(C[0])
    return y


def gemm(A, B, C=None, alpha=1.0, beta=1.0, transA=False, transB=False):
    """ONNX Gemm: ``alpha·op(A)·op(B) + beta·C``, the amp cast on every
    input."""
    xs = (A, B) if C is None else (A, B, C)
    return _op(_gemm, *xs, _name="Gemm", alpha=alpha, beta=beta,
               transA=transA, transB=transB)


def _reshape(x, shape):
    return x.reshape(shape)


def reshape(x, shape):
    return _op(_reshape, x, _name="Reshape",
               shape=tuple(int(s) for s in shape))


def _transpose(x, perm):
    if perm is None:
        perm = tuple(range(x.dim() - 1, -1, -1))
    return x.permute(*perm)


def transpose(x, shape=None):
    """Permute axes (SINGA names the permutation ``shape``; None reverses
    them)."""
    return _op(_transpose, x, _name="Transpose",
               perm=None if shape is None else tuple(shape))


def _flatten(x, axis):
    lead = 1
    for s in x.shape[:axis]:
        lead *= int(s)
    return x.reshape(lead, -1)


def flatten(x, axis=1):
    """Collapse the dims from ``axis`` on: ``(prod(shape[:axis]), -1)``."""
    return _op(_flatten, x, _name="Flatten", axis=axis)


def _cat(*xs, axis):
    return torch.cat(xs, dim=axis)


def cat(xs, axis=0):
    return _op(_cat, *xs, _name="Concat", axis=axis)


concat = cat


def _split(x, axis, parts):
    return tuple(torch.split(x, list(parts), dim=axis))


def split(x, axis, parts):
    """Sizes ``parts`` along ``axis`` -> a tuple of tensors."""
    return _op(_split, x, _name="Split", axis=axis,
               parts=tuple(int(p) for p in parts))


def _squeeze(x, ax):
    if ax is None:
        return torch.squeeze(x)
    return x.squeeze(ax)


def squeeze(x, axis=None):
    return _op(_squeeze, x, _name="Squeeze",
               ax=tuple(axis) if isinstance(axis, (list, tuple)) else axis)


def _unsqueeze(x, ax):
    n = x.dim() + len(ax)
    for a in sorted(a % n for a in ax):
        x = x.unsqueeze(a)
    return x


def unsqueeze(x, axis):
    """New size-1 axes at the positions ``axis`` of the output (one int or
    several), as ``jnp.expand_dims``."""
    return _op(_unsqueeze, x, _name="Unsqueeze",
               ax=tuple(axis) if isinstance(axis, (list, tuple))
               else (axis,))


def _gather(x, axis, idx):
    axis = axis % x.dim()
    idx = np.where(idx < 0, idx + x.shape[axis], idx)
    flat = torch.from_numpy(idx.reshape(-1)).to(x.device)
    y = torch.index_select(x, axis, flat)
    return y.reshape(tuple(x.shape[:axis]) + idx.shape
                     + tuple(x.shape[axis + 1:]))


def gather(x, axis, indices):
    """``jnp.take(x, indices, axis)`` for host indices (negative ones
    count from the end)."""
    return _op(_gather, x, _name="Gather", axis=axis,
               idx=np.asarray(indices, dtype=np.int64))


# -------------------------------------------------------------- reductions


def _sum_list(*vs):
    out = vs[0]
    for v in vs[1:]:
        out = out + v
    return out


def _mean_list(*vs):
    return _sum_list(*vs) / float(len(vs))


def sum(*xs):  # noqa: A001
    """Elementwise sum of several tensors (SINGA's ``autograd.sum``)."""
    return _op(_sum_list, *xs, _name="Sum")


def mean(*xs):
    """Elementwise mean of several tensors (SINGA's ``Mean``)."""
    return _op(_mean_list, *xs, _name="Mean")


def _reduce_mean(x, ax, keepdims):
    return torch.mean(x, dim=tuple(range(x.dim())) if ax is None else ax,
                      keepdim=keepdims)


def _reduce_sum(x, ax, keepdims):
    return torch.sum(x, dim=tuple(range(x.dim())) if ax is None else ax,
                     keepdim=keepdims)


def reduce_mean(x, axes=None, keepdims=False):
    """Mean over ``axes`` (all axes when None), in x's dtype."""
    return _op(_reduce_mean, x, _name="ReduceMean",
               ax=None if axes is None else tuple(axes),
               keepdims=bool(keepdims))


def reduce_sum(x, axes=None, keepdims=False):
    """Sum over ``axes`` (all axes when None), in x's dtype."""
    return _op(_reduce_sum, x, _name="ReduceSum",
               ax=None if axes is None else tuple(axes),
               keepdims=bool(keepdims))


def _softmax(x, axis):
    return torch.softmax(x, dim=axis)


def _log_softmax(x, axis):
    return torch.log_softmax(x, dim=axis)


def softmax(x, axis=1):
    """Softmax over ``axis`` (SINGA's default: 1, for 2-D logits)."""
    return _op(_softmax, x, _name="SoftMax", axis=axis)


def log_softmax(x, axis=1):
    return _op(_log_softmax, x, _name="LogSoftMax", axis=axis)


# ------------------------------------------------------------------ losses


def _to_one_hot(t, logits_shape):
    """``t`` as float32 one-hot rows over the last axis of
    ``logits_shape``, or ``t`` itself (as float32) if it already has that
    shape.  A label outside ``[0, V)`` gives a zero row, as
    ``jax.nn.one_hot``; made by comparison, so no op syncs the device."""
    if t.dim() == len(logits_shape) and tuple(t.shape) == tuple(logits_shape):
        return t.float()
    classes = torch.arange(logits_shape[-1], device=t.device)
    return (t.long()[..., None] == classes).float()


def _cross_entropy(p, t):
    t1h = _to_one_hot(t.detach(), p.shape)
    return -(t1h * torch.log(p + 1e-10)).sum() / p.shape[0]


def cross_entropy(p, t):
    """SINGA's CrossEntropy over probabilities ``p`` (after a softmax)
    and one-hot or integer targets: ``-Σ t·log(p + 1e-10) / N``.  The
    target takes no gradient."""
    return _op(_cross_entropy, p, t, _name="_CrossEntropy")


def _mse(x, t):
    return torch.mean(torch.square(x - t))


def mse_loss(x, t):
    return _op(_mse, x, t, _name="MSE")


def _bce(p, t):
    eps = 1e-7
    return -torch.mean(t * torch.log(p + eps)
                       + (1 - t) * torch.log(1 - p + eps))


def binary_cross_entropy(p, t):
    return _op(_bce, p, t, _name="BCE")


def _nll(logp, t):
    t1h = _to_one_hot(t.detach(), logp.shape)
    return -(t1h * logp).sum() / logp.shape[0]


def nll_loss(logp, t):
    """``-Σ onehot(t)·logp / N``."""
    return _op(_nll, logp, t, _name="NLL")


class _SoftMaxCrossEntropy(torch.autograd.Function):
    """Mean over rows of CE(softmax(x), t) in float32, with the JAX
    package's hand-written VJP ``dx = dy·(p − onehot)/N``
    (``autograd.py:593-608``).  A label of −1 (or any label outside
    ``[0, V)``) gives a zero one-hot row: no loss, and — as in the
    reference's VJP — a gradient of ``p/N`` on that row.  Invalid rows
    are masked rather than selected, so no op has a data-dependent shape
    and the step can be captured in a CUDA graph."""

    @staticmethod
    def forward(ctx, x, t):
        logp = torch.log_softmax(x.float(), dim=-1)
        lab = t.reshape(-1).long()
        valid = (lab >= 0) & (lab < x.shape[-1])
        cols = lab.clamp(0, x.shape[-1] - 1)[:, None]
        picked = logp.gather(1, cols)[:, 0]
        ctx.save_for_backward(logp, cols, valid)
        ctx.x_dtype = x.dtype
        return -torch.where(valid, picked, 0.0).sum() / x.shape[0]

    @staticmethod
    def backward(ctx, dy):
        logp, cols, valid = ctx.saved_tensors
        scale = dy / logp.shape[0]
        dx = logp.exp() * scale
        dx.scatter_add_(1, cols, (-scale * valid.float())[:, None])
        return dx.to(ctx.x_dtype), None


def softmax_cross_entropy(x, t):
    """Fused softmax + cross-entropy over (N, V) logits and (N,) integer
    labels, float32 regardless of amp."""
    return _op(_SoftMaxCrossEntropy.apply, x, t,
               _name="_SoftMaxCrossEntropy")


# ------------------------------------------------------------------- other


def _dropout(x, ratio, training, generator):
    if not training or ratio == 0.0:
        return x
    if generator is None:
        from .device import device_of

        generator = device_of(x).generator
    keep = 1.0 - float(ratio)
    mask = torch.empty(x.shape, device=x.device).bernoulli_(
        keep, generator=generator).bool()
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


class _Dropout(_Func):
    """The recorded form of ``dropout``: named ``_Dropout#<n>`` with the
    ``ratio`` attribute, as the JAX op class."""

    fn = staticmethod(_dropout)

    def __init__(self, ratio, training, generator):
        super().__init__(training=training, generator=generator)
        self.ratio = float(ratio)
        self.params["ratio"] = self.ratio

    def __call__(self, x):
        p = self.params
        return self._record((x,), _dropout(x, p["ratio"], p["training"],
                                           p["generator"]))


def dropout(x, ratio=0.5, training=None, generator=None):
    """Inverted dropout: keep with probability ``1 − ratio`` and scale by
    ``1/(1 − ratio)``; the identity when not training (``training``:
    default, the module flag).  The mask is drawn from ``generator``
    (default: the generator of the device x lies on, which a captured
    training step registers with its CUDA graph, so each replay draws a
    fresh mask).  While exporting, a ratio above 0 is recorded as
    ``_Dropout`` (the JAX package calls its dropout only then)."""
    if training is None:
        training = globals()["training"]
    if exporting and ratio > 0:
        return _Dropout(ratio, training, generator)(x)
    return _dropout(x, ratio, training, generator)


def _layer_norm(x, scale, bias, axis, eps):
    if axis in (-1, x.dim() - 1):
        y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(),
                         bias.float(), eps)
    else:
        xf = x.float()
        m = xf.mean(axis, keepdim=True)
        v = torch.square(xf - m).mean(axis, keepdim=True)
        y = (xf - m) * torch.rsqrt(v + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def layer_norm(x, scale, bias, axis=-1, eps=1e-12):
    """LayerNorm over ``axis`` (the last by default) with float32
    statistics; the result takes x's dtype (``autograd.py:707-719``)."""
    return _op(_layer_norm, x, scale, bias, _name="LayerNorm", axis=axis,
               eps=eps)


def _embedding(ids, W):
    return F.embedding(ids.long(), W)


def embedding(ids, W):
    """Row gather ``W[ids]``; W's gradient is a scatter-add."""
    return _op(_embedding, ids, W, _name="Embedding")
