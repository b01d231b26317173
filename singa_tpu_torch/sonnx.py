"""ONNX import and export (counterpart of ``singa_tpu/sonnx.py``):
``SingaBackend.prepare`` / ``prepare`` turn an ONNX model into a
``SingaRep`` whose ``run`` executes the graph node by node through the
port's ``autograd`` ops, ``SONNXModel`` wraps an imported graph as a
trainable ``Model``, and ``to_onnx`` (``SingaFrontend``) exports a model
by recording one forward pass.  The protobuf layer is the vendored codec
``io/onnx_pb.py``; files move between this package and the JAX package
unchanged.

Import.  Handlers compute through ``autograd``, so torch differentiates
an imported graph and amp's dtype rules apply to it (an imported MatMul
or Gemm takes the amp cast as a native ``Linear`` does).  Float
initializers become parameters, the other initializers and every
``Constant`` node's value are made once at ``prepare``, and a
BatchNormalization's mean and variance are non-trainable state, as the
JAX package ends up holding them.  Values that a handler needs on the
host (Reshape's shape, Slice's bounds, a Dropout ratio...) are read from
the host copy that constants, non-float initializers and ``Shape``
outputs keep beside their device tensor, so a prepared graph can run
inside a CUDA-graph capture.  A host read of a computed device value
(NonZero, an If on a computed condition, a Loop whose trip count or exit
condition is computed) syncs the device in eager execution and raises a
``RuntimeError`` naming the node under a capture.  Index outputs
(ArgMax, ArgMin, TopK, NonZero) are int32 where ONNX says int64, as in
the JAX package; ids and other integer inputs keep their dtype.

Export.  ``to_onnx`` runs one forward pass of the model in training mode
(dropout active, batch norm pure: it leaves the running statistics as
they are), float32 compute, no gradient, inside an
``autograd.ExportRecord``, and walks the record from the outputs back:
ops the JAX package exports node for node map through ``_EXPORT_OPS``,
its fused ops (attention, embedding, BERT's mask and first token, GQA's
head repeat, the RNN scans...) through the decompositions of
``_EXPORT_DECOMPOSE``.  A tensor that is neither an input nor a
parameter nor an op's output is baked as a constant initializer if no
input or parameter flows into it (position ids); if one does, an
unrecorded torch function computed it and the export raises
``NotImplementedError`` naming that function rather than bake a value
that depends on the inputs.
"""

from __future__ import annotations

import contextvars
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import amp, autograd, model, tensor
from .autograd import _op
from .device import Device, get_default_device
from .io import onnx_pb
from .io.onnx_pb import (AttributeProto, GraphProto, ModelProto, NodeProto,
                         TensorProto, ValueInfoProto)
from .layer import _NAME_ATTR

__all__ = ["SingaRep", "SingaBackend", "prepare", "SONNXModel", "to_onnx",
           "SingaFrontend", "save", "load"]

#: attribute holding a tensor's host (numpy) copy
_HOST_ATTR = "_sonnx_host"

# ---------------------------------------------------------------------------
# Backend: ONNX -> autograd ops
# ---------------------------------------------------------------------------

#: the SingaRep executing ``run`` in this context: its device, its
#: training flag, its cache of host-made constants
_REP = contextvars.ContextVar("sonnx_rep", default=None)
#: the node being executed (named by host-read errors)
_NODE = contextvars.ContextVar("sonnx_node", default=None)


def _torch_device(device):
    if device is None:
        device = get_default_device()
    if isinstance(device, Device):
        return device.torch_device
    return torch.device(device)


def _rep_device():
    rep = _REP.get()
    return rep.torch_device if rep is not None \
        else get_default_device().torch_device


def _rep_training():
    rep = _REP.get()
    return bool(rep is not None and rep.training)


def _capturing(t):
    """Whether a CUDA graph is being captured on the stream that would
    read ``t``."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _node_desc():
    node = _NODE.get()
    if node is None:
        return "sonnx"
    return f"ONNX node {node.name or '<unnamed>'!r} ({node.op_type})"


def _np(t):
    """A handler's host view of ``t``: its host copy if it keeps one, else
    a copy of its values (a device sync for a CUDA tensor, and an error
    under a CUDA-graph capture, which cannot read device values)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    host = getattr(t, _HOST_ATTR, None)
    if host is not None:
        return host
    if _capturing(t):
        raise RuntimeError(
            f"{_node_desc()} needs a computed device value on the host, "
            f"which a CUDA-graph capture cannot read; run this graph "
            f"eagerly")
    return tensor.to_numpy(t)


def _host_tensor(arr, device):
    """``arr`` on ``device``, keeping ``arr`` as its host copy; float64
    becomes float32, as the JAX package stores it."""
    arr = np.asarray(arr)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    # (ascontiguousarray makes a 0-d array 1-d: keep the true shape)
    t = torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape)).to(
        device)
    setattr(t, _HOST_ATTR, arr)
    return t


def _const(arr):
    """A host-made value on the rep's device.  The running rep caches it
    by value, so a graph that makes the same constant on every run (a
    Shape, a Range...) copies it to the device once, before any capture,
    and a captured replay reads the cached tensor."""
    rep = _REP.get()
    if rep is None:
        return _host_tensor(arr, _rep_device())
    arr = np.asarray(arr)
    key = (arr.dtype.str, arr.shape, arr.tobytes())
    t = rep._cache.get(key)
    if t is None:
        t = rep._cache[key] = _host_tensor(arr, rep.torch_device)
    return t


class SingaRep:
    """Executable form of an imported graph (module docstring).
    ``run(inputs)`` walks the nodes in graph order; ``weights`` maps
    initializer names (and promoted BatchNormalization statistics) to
    their tensors."""

    def __init__(self, graph: GraphProto, weights: dict, device,
                 outputs=None):
        self.graph = graph
        self.device = device
        self.torch_device = _torch_device(device)
        self.weights = weights
        self.output_names = outputs or [v.name for v in graph.output]
        self.training = False
        self._cache = {}
        # Constant nodes evaluate once here, not per run: they are frozen
        # values (baked masks, scales, shapes), never trainable
        self._consts = {}
        token = _REP.set(self)
        try:
            for node in graph.node:
                if node.op_type == "Constant" and node.output:
                    self._consts[node.output[0]] = \
                        _ONNX_OPS["Constant"](node, [])
        finally:
            _REP.reset(token)
        # BatchNormalization mean/var are mutable training state (the
        # training branch updates them): promote them to non-trainable
        # weights, so get_states and checkpoints carry them
        for node in graph.node:
            if node.op_type == "BatchNormalization":
                for name in list(node.input)[3:5]:
                    if name in self._consts:
                        t = self._consts.pop(name)
                        t = t.detach().clone()  # not the cached constant
                        setattr(t, _NAME_ATTR, name)
                        self.weights[name] = t

    def params(self):
        return self.weights

    def run(self, inputs, training=None):
        """Outputs of the graph on ``inputs`` (a list in the order of the
        graph's non-initializer inputs, or a dict by name; tensors or
        arrays).  ``training`` (default: ``autograd.training``) selects
        dropout and batch statistics."""
        env = dict(self.weights)
        env.update(self._consts)
        graph_inputs = [v.name for v in self.graph.input
                        if v.name not in self.weights]

        def feed(v):
            return v if isinstance(v, torch.Tensor) \
                else _host_tensor(v, self.torch_device)

        if isinstance(inputs, dict):
            for k, v in inputs.items():
                env[k] = feed(v)
        else:
            if len(inputs) != len(graph_inputs):
                raise ValueError(
                    f"expected {len(graph_inputs)} inputs "
                    f"({graph_inputs}), got {len(inputs)}")
            for k, v in zip(graph_inputs, inputs):
                env[k] = feed(v)
        self.training = autograd.training if training is None \
            else bool(training)
        token = _REP.set(self)
        try:
            # skip hoisted constants and promoted BN statistics: the
            # promoted ones live in env as the live state
            _exec_nodes(self.graph.node, env,
                        skip_consts=set(self._consts) | set(self.weights))
        finally:
            _REP.reset(token)
        return [env[n] for n in self.output_names]


def _exec_nodes(nodes, env, skip_consts=()):
    """Walk ``nodes`` in graph order, updating ``env`` (name -> tensor).
    Control-flow bodies run against a child copy of the enclosing env
    (ONNX scoping: outer names visible, inner bindings do not leak)."""
    for node in nodes:
        if node.op_type == "Constant" and node.output \
                and node.output[0] in skip_consts:
            continue
        token = _NODE.set(node)
        try:
            if node.op_type in _CONTROL_FLOW_OPS:
                outs = _exec_control_flow(node, env)
            else:
                handler = _ONNX_OPS.get(node.op_type)
                if handler is None:
                    raise NotImplementedError(
                        f"ONNX op {node.op_type!r} is not supported by "
                        f"sonnx")
                args = [env[i] if i else None for i in node.input]
                outs = handler(node, args)
        finally:
            _NODE.reset(token)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        for name, out in zip(node.output, outs):
            if name:
                env[name] = out


def _run_subgraph(graph, env, bound_inputs):
    """Run a subgraph against a child env; its outputs in order.  Its own
    initializers and formal inputs shadow outer names."""
    child = dict(env)
    for init in graph.initializer:
        child[init.name] = _const(init.to_numpy())
    for vi, t in zip(graph.input, bound_inputs):
        child[vi.name] = t
    _exec_nodes(graph.node, child)
    return [child[v.name] for v in graph.output]


def _concrete_bool(t):
    """Python bool of a 0-d condition (a host read: module docstring)."""
    return bool(np.asarray(_np(t)).reshape(()))


def _exec_control_flow(node, env):
    """ONNX If, Loop and Scan.  If runs the branch its condition selects;
    Loop needs a max trip count and runs at most that many iterations
    while its condition holds, scan outputs stacked on a new leading
    axis; both read their condition (and Loop its count) on the host.
    Scan's trip count is the scan axis' length, a static shape."""
    attrs = node.attrs()
    if node.op_type == "Scan":
        return _exec_scan(node, env)
    if node.op_type == "If":
        cond = env[node.input[0]]
        then_g, else_g = attrs["then_branch"], attrs["else_branch"]
        return _run_subgraph(then_g if _concrete_bool(cond) else else_g,
                             env, [])

    body = attrs["body"]
    m_t = env.get(node.input[0]) if node.input[0] else None
    cond_t = env.get(node.input[1]) if len(node.input) > 1 \
        and node.input[1] else None
    carried = [env[i] for i in node.input[2:]]
    n_carried = len(carried)
    n_scan = len(body.output) - 1 - n_carried
    if m_t is None:
        raise NotImplementedError(
            "sonnx Loop requires a max trip count (while-style Loops "
            "with only a dynamic condition are not supported)")
    m = int(np.asarray(_np(m_t)).reshape(()))
    scans = [[] for _ in range(n_scan)]
    cond_cur = _const(np.asarray(True)) if cond_t is None else cond_t
    for it in range(m):
        if not _concrete_bool(cond_cur):
            break
        it_t = _const(np.asarray(it, np.int64))
        outs = _run_subgraph(body, env, [it_t, cond_cur] + carried)
        cond_cur = outs[0]
        carried = list(outs[1:1 + n_carried])
        for j in range(n_scan):
            scans[j].append(autograd.unsqueeze(outs[1 + n_carried + j], 0))
    if any(not s for s in scans):
        raise NotImplementedError(
            "sonnx Loop: zero-iteration scan outputs (empty tensors) "
            "are not supported")
    return carried + [autograd.cat(s, axis=0) for s in scans]


def _scan_slice(a, idx, ax):
    return a.select(ax, idx)


def _exec_scan(node, env):
    """ONNX Scan: M loop-carried states and N sequence inputs, trip count
    the scan axis' length; scan_input/output_axes and directions."""
    attrs = node.attrs()
    body = attrs["body"]
    n_scan_in = int(attrs["num_scan_inputs"])
    ins = [env[i] for i in node.input]
    n_state = len(ins) - n_scan_in
    states = list(ins[:n_state])
    xs = ins[n_state:]
    in_axes = list(attrs.get("scan_input_axes") or [0] * n_scan_in)
    in_dirs = list(attrs.get("scan_input_directions") or [0] * n_scan_in)
    trip = xs[0].shape[in_axes[0]]
    for x, ax in zip(xs, in_axes):
        if x.shape[ax] != trip:
            raise ValueError(
                f"sonnx Scan: scan inputs disagree on trip count "
                f"({x.shape[ax]} vs {trip})")
    if trip == 0:
        raise NotImplementedError(
            "sonnx Scan: zero-length scan axis (empty scan outputs) is "
            "not supported")
    scans = None
    for t in range(trip):
        slices = [_op(_scan_slice, x, _name="ScanSlice",
                      idx=trip - 1 - t if dr else t, ax=ax)
                  for x, ax, dr in zip(xs, in_axes, in_dirs)]
        outs = _run_subgraph(body, env, states + slices)
        states = list(outs[:n_state])
        youts = outs[n_state:]
        if scans is None:
            scans = [[] for _ in youts]
        for j, y in enumerate(youts):
            scans[j].append(y)
    scans = scans or []
    k = len(scans)
    out_axes = list(attrs.get("scan_output_axes") or [0] * k)
    out_dirs = list(attrs.get("scan_output_directions") or [0] * k)
    stacked = []
    for ys, ax, dr in zip(scans, out_axes, out_dirs):
        if dr:
            ys = ys[::-1]
        if ax < 0:  # negative axes count in the stacked rank
            ax += len(ys[0].shape) + 1
        stacked.append(autograd.cat([autograd.unsqueeze(y, ax) for y in ys],
                                    axis=ax))
    return states + stacked


def _bn_stat_inputs(graph):
    return {name for node in graph.node
            if node.op_type == "BatchNormalization"
            for name in list(node.input)[3:5]}


class SingaBackend:
    @staticmethod
    def prepare(onnx_model, device=None, **kw):
        """A ``SingaRep`` of ``onnx_model`` (a ``ModelProto``, a path or
        bytes) on ``device`` (default: the default device, the GPU)."""
        if isinstance(onnx_model, (str, bytes, bytearray)):
            onnx_model = onnx_pb.load_model(onnx_model)
        dev = _torch_device(device)
        g = onnx_model.graph
        bn_stats = _bn_stat_inputs(g)
        weights = {}
        for init in g.initializer:
            arr = init.to_numpy()
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            if np.issubdtype(arr.dtype, np.floating) \
                    and init.name not in bn_stats:
                t = nn.Parameter(torch.from_numpy(arr).to(dev))
            else:
                t = _host_tensor(arr, dev)
                if np.issubdtype(arr.dtype, np.floating):
                    delattr(t, _HOST_ATTR)  # BN state: it changes
            setattr(t, _NAME_ATTR, init.name)
            weights[init.name] = t
        return SingaRep(g, weights, device if device is not None
                        else get_default_device())


prepare = SingaBackend.prepare


class SONNXModel(model.Model):
    """An imported graph as a trainable ``Model``: subclass it and
    override ``train_one_batch``, or use it for its forward.  The
    imported weights are this module's parameters and buffers (under
    keys ``w0``, ``w1``..., since ONNX names may hold dots), so
    ``compile``, the optimizers, checkpoints and captured steps see them;
    ``get_params``/``get_states`` name them by their ONNX names."""

    def __init__(self, onnx_model, device=None):
        super().__init__()
        self.rep = SingaBackend.prepare(onnx_model, device)
        for i, t in enumerate(self.rep.weights.values()):
            if isinstance(t, nn.Parameter):
                self.register_parameter(f"w{i}", t)
            else:
                self.register_buffer(f"w{i}", t)
        self._initialized = True

    def set_name(self, name):
        self.name = name
        for k, t in self.rep.weights.items():
            setattr(t, _NAME_ATTR, k)

    def get_params(self):
        return {k: v for k, v in self.rep.weights.items()
                if isinstance(v, nn.Parameter)}

    def get_states(self):
        return dict(self.rep.weights)

    def set_states(self, states):
        """Copy ``states`` into the weights by ONNX name; an unknown or
        missing name raises, as does a shape mismatch."""
        own = self.rep.weights
        unknown = sorted(set(states) - set(own))
        missing = sorted(set(own) - set(states))
        if unknown or missing:
            raise KeyError(f"set_states: unknown names {unknown[:5]}, "
                           f"missing names {missing[:5]}")
        with torch.no_grad():
            for k, t in own.items():
                src = states[k]
                if not isinstance(src, torch.Tensor):
                    src = torch.from_numpy(np.array(src))
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(
                        f"set_states: {k} has shape {tuple(src.shape)}, "
                        f"the weight {tuple(t.shape)}")
                t.copy_(src.to(device=t.device, dtype=t.dtype))

    def forward(self, *x):
        outs = self.rep.run(list(x), training=self.training)
        return outs[0] if len(outs) == 1 else outs


# ---------------------------------------------------------------------------
# op handlers: each takes (node, args: list[Tensor | None]) -> Tensor(s)
# ---------------------------------------------------------------------------


def _static_ints(t):
    return [int(v) for v in np.asarray(_np(t)).reshape(-1)]


def _handle_binary(fn):
    def h(node, args):
        return _op(fn, args[0], args[1], _name=node.op_type)
    return h


def _handle_unary(fn):
    def h(node, args):
        return _op(fn, args[0], _name=node.op_type)
    return h


def _h_gemm(node, args):
    a = node.attrs()
    return autograd.gemm(args[0], args[1],
                         args[2] if len(args) > 2 else None,
                         alpha=a.get("alpha", 1.0), beta=a.get("beta", 1.0),
                         transA=bool(a.get("transA", 0)),
                         transB=bool(a.get("transB", 0)))


def _pairs(pads, n):
    return tuple((pads[i], pads[i + n]) for i in range(n))


def _h_conv(node, args):
    from .ops import conv as conv_ops

    a = node.attrs()
    kernel = a.get("kernel_shape", list(args[1].shape[2:]))
    n = len(kernel)
    return conv_ops.conv2d(args[0], args[1],
                           args[2] if len(args) > 2 else None,
                           stride=tuple(a.get("strides", [1] * n)),
                           padding=_pairs(a.get("pads", [0] * 2 * n), n),
                           dilation=tuple(a.get("dilations", [1] * n)),
                           group=a.get("group", 1),
                           pad_mode=a.get("auto_pad", "NOTSET"))


def _h_pool(is_max):
    def h(node, args):
        from .ops import pooling as pool_ops

        a = node.attrs()
        kernel = a["kernel_shape"]
        n = len(kernel)
        return pool_ops.pooling2d(args[0], kernel=tuple(kernel),
                                  stride=tuple(a.get("strides", [1] * n)),
                                  padding=_pairs(a.get("pads", [0] * 2 * n),
                                                 n),
                                  is_max=is_max,
                                  pad_mode=a.get("auto_pad", "NOTSET"))
    return h


def _h_batchnorm(node, args):
    from .ops import batchnorm as bn_ops

    a = node.attrs()
    x, scale, bias, mean, var = args[:5]
    return bn_ops.batchnorm2d(x, scale, bias, mean, var,
                              momentum=a.get("momentum", 0.9),
                              eps=a.get("epsilon", 1e-5),
                              training=_rep_training())


def _h_reshape(node, args):
    shape = _static_ints(args[1])
    data_shape = args[0].shape
    # ONNX semantics: 0 copies the input's dim
    shape = [data_shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return autograd.reshape(args[0], shape)


def _h_transpose(node, args):
    return autograd.transpose(args[0], node.attrs().get("perm"))


def _h_concat(node, args):
    return autograd.cat(args, axis=node.attrs().get("axis", 0))


def _h_softmax(node, args):
    return autograd.softmax(args[0], axis=node.attrs().get("axis", -1))


def _h_flatten(node, args):
    return autograd.flatten(args[0], axis=node.attrs().get("axis", 1))


def _h_squeeze(node, args):
    axes = node.attrs().get("axes")
    if axes is None and len(args) > 1 and args[1] is not None:
        axes = _static_ints(args[1])
    return autograd.squeeze(args[0], tuple(axes) if axes else None)


def _h_unsqueeze(node, args):
    axes = node.attrs().get("axes")
    if axes is None:
        axes = _static_ints(args[1])
    return autograd.unsqueeze(args[0], tuple(axes))


def _take(x, i, axis):
    """``jnp.take(x, i, axis)`` with a device index tensor (negative
    indices wrap)."""
    axis = axis % x.dim()
    i = i.long()
    i = torch.where(i < 0, i + x.shape[axis], i)
    y = torch.index_select(x, axis, i.reshape(-1))
    return y.reshape(tuple(x.shape[:axis]) + tuple(i.shape)
                     + tuple(x.shape[axis + 1:]))


def _h_gather(node, args):
    return _op(_take, args[0], args[1], _name="Gather",
               axis=node.attrs().get("axis", 0))


def _slice_axis(x, ax, s, e, st):
    sl = slice(s, None if e >= 2**31 - 1 else e, st)
    if st > 0:
        return x[(slice(None),) * ax + (sl,)]
    # torch slices take no negative step: gather the indices
    idx = np.arange(*sl.indices(x.shape[ax]), dtype=np.int64)
    return torch.index_select(x, ax, _const(idx).to(x.device))


def _slice(x, starts, ends, axes, steps):
    for s, e, ax, st in zip(starts, ends, axes, steps):
        x = _slice_axis(x, ax % x.dim(), s, e, st)
    return x


def _h_slice(node, args):
    a = node.attrs()
    if "starts" in a:  # opset < 10
        starts, ends = a["starts"], a["ends"]
        axes = a.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    else:
        starts = _static_ints(args[1])
        ends = _static_ints(args[2])
        axes = _static_ints(args[3]) if len(args) > 3 and args[3] is not None \
            else list(range(len(starts)))
        steps = _static_ints(args[4]) if len(args) > 4 and args[4] is not None \
            else [1] * len(starts)
    return _op(_slice, args[0], _name="Slice", starts=tuple(starts),
               ends=tuple(ends), axes=tuple(axes), steps=tuple(steps))


def _h_split(node, args):
    a = node.attrs()
    axis = a.get("axis", 0)
    parts = a.get("split")
    if parts is None and len(args) > 1 and args[1] is not None:
        parts = _static_ints(args[1])
    if parts is None:
        n = len(node.output)
        parts = [args[0].shape[axis] // n] * n
    return autograd.split(args[0], axis, parts)


def _h_cast(node, args):
    return autograd.cast(args[0], onnx_pb.DTYPE_TO_NP[node.attrs()["to"]])


def _h_clip(node, args):
    a = node.attrs()
    lo, hi = a.get("min"), a.get("max")
    if lo is None and len(args) > 1 and args[1] is not None:
        lo = float(np.asarray(_np(args[1])).reshape(()))
    if hi is None and len(args) > 2 and args[2] is not None:
        hi = float(np.asarray(_np(args[2])).reshape(()))
    return autograd.clip(args[0], lo, hi)


def _dims(x, ax):
    return tuple(range(x.dim())) if ax is None else tuple(ax)


def _reduce(fn):
    def f(x, ax, keepdims):
        return fn(x, _dims(x, ax), keepdims)
    return f


def _prod(x, dims, keepdim):
    for d in sorted((d % x.dim() for d in dims), reverse=True):
        x = torch.prod(x, d, keepdim=True)
    if not keepdim:
        x = x.squeeze(tuple(d % (x.dim()) for d in dims)) if dims else x
    return x


_REDUCERS = {
    "ReduceMean": lambda x, d, k: torch.mean(x, d, keepdim=k),
    "ReduceSum": lambda x, d, k: torch.sum(x, d, keepdim=k),
    "ReduceMax": lambda x, d, k: torch.amax(x, d, keepdim=k),
    "ReduceMin": lambda x, d, k: torch.amin(x, d, keepdim=k),
    "ReduceLogSum": lambda x, d, k: torch.log(torch.sum(x, d, keepdim=k)),
    "ReduceSumSquare": lambda x, d, k: torch.sum(x * x, d, keepdim=k),
    "ReduceProd": _prod,
    "ReduceL1": lambda x, d, k: torch.sum(torch.abs(x), d, keepdim=k),
    "ReduceL2": lambda x, d, k: torch.sqrt(torch.sum(x * x, d, keepdim=k)),
    "ReduceLogSumExp": lambda x, d, k: torch.logsumexp(x, d, keepdim=k),
}


def _h_reduce(node, args):
    a = node.attrs()
    axes = a.get("axes")
    if axes is None and len(args) > 1 and args[1] is not None:
        axes = _static_ints(args[1])
    # ax/keepdims ride op.params, so a re-export of the imported graph
    # (_dec_reduce_mean) writes the node back as it was
    return _op(_reduce(_REDUCERS[node.op_type]), args[0],
               _name=node.op_type, ax=tuple(axes) if axes else None,
               keepdims=bool(a.get("keepdims", 1)))


def _h_constant(node, args):
    return _const(node.attrs()["value"].to_numpy())


def _h_constant_of_shape(node, args):
    shape = _static_ints(args[0])
    value = node.attrs().get("value")
    fill = value.to_numpy().reshape(-1)[0] if value is not None else 0.0
    return _const(np.full(shape, fill))


def _h_shape(node, args):
    return _const(np.asarray(args[0].shape, np.int64))


def _expand(x, shape):
    return torch.broadcast_to(
        x, np.broadcast_shapes(tuple(x.shape), tuple(shape)))


def _h_expand(node, args):
    return _op(_expand, args[0], _name="Expand",
               shape=tuple(_static_ints(args[1])))


def _h_dropout(node, args):
    ratio = node.attrs().get("ratio", 0.5)
    if len(args) > 1 and args[1] is not None:
        ratio = float(np.asarray(_np(args[1])).reshape(()))
    return autograd.dropout(args[0], ratio, training=_rep_training())


def _h_layernorm(node, args):
    a = node.attrs()
    return autograd.layer_norm(args[0], args[1], args[2],
                               axis=a.get("axis", -1),
                               eps=a.get("epsilon", 1e-5))


def _h_where(node, args):
    return autograd.where_op(args[0], args[1], args[2])


def _onehot(idx, depth, off, on, axis):
    classes = torch.arange(depth, device=idx.device)
    oh = classes == idx.to(torch.int32)[..., None]
    out = torch.where(oh, on, off).to(torch.float32)
    return out if axis == -1 else torch.movedim(out, -1, axis)


def _h_onehot(node, args):
    depth = int(np.asarray(_np(args[1])).reshape(-1)[0])
    off_on = np.asarray(_np(args[2])).reshape(-1)
    return _op(_onehot, args[0], _name="OneHot", depth=depth,
               off=float(off_on[0]), on=float(off_on[1]),
               axis=node.attrs().get("axis", -1))


def _h_range(node, args):
    start, limit, delta = (float(np.asarray(_np(a)).reshape(-1)[0])
                           for a in args[:3])
    return _const(np.arange(start, limit, delta))


def _tile(x, reps):
    return torch.tile(x, reps)


def _h_tile(node, args):
    return _op(_tile, args[0], _name="Tile",
               reps=tuple(_static_ints(args[1])))


def _index_pad(x, pad_width, mode):
    """``np.pad``'s reflect / edge modes axis by axis, as index gathers."""
    for ax, (lo, hi) in enumerate(pad_width):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[ax]), (lo, hi), mode=mode)
            x = torch.index_select(x, ax, _const(idx.astype(np.int64))
                                   .to(x.device))
    return x


def _pad(x, pad_width, mode, value):
    crop = tuple(slice(-lo if lo < 0 else None, hi if hi < 0 else None)
                 for lo, hi in pad_width)
    if any(lo < 0 or hi < 0 for lo, hi in pad_width):
        x = x[crop]
    pos = tuple((max(lo, 0), max(hi, 0)) for lo, hi in pad_width)
    if mode == "constant":
        # F.pad lists the last dim first
        return F.pad(x, [p for lo_hi in reversed(pos) for p in lo_hi],
                     value=value)
    return _index_pad(x, pos, mode)


def _h_pad(node, args):
    a = node.attrs()
    pads = a.get("pads")
    if pads is None:
        pads = _static_ints(args[1])
    n = len(pads) // 2
    pad_width = tuple((pads[i], pads[i + n]) for i in range(n))
    mode = a.get("mode", "constant")
    if isinstance(mode, bytes):
        mode = mode.decode()
    if mode not in ("constant", "reflect", "edge"):
        raise NotImplementedError(f"ONNX Pad mode {mode!r} is not supported")
    # opset >= 11 carries the pad value as the third input; earlier opsets
    # as the 'value' attribute.  Negative pads crop that edge.
    value = a.get("value", 0.0)
    if mode == "constant" and len(args) > 2 and args[2] is not None:
        value = float(np.asarray(_np(args[2])).reshape(-1)[0])
    return _op(_pad, args[0], _name="Pad", pad_width=pad_width, mode=mode,
               value=value)


def _h_global_avg_pool(node, args):
    return autograd.reduce_mean(args[0], axes=(2, 3), keepdims=True)


def _global_max(x):
    return torch.amax(x, tuple(range(2, x.dim())), keepdim=True)


def _h_global_max_pool(node, args):
    return _op(_global_max, args[0], _name="GlobalMaxPool")


def _upsample_nearest(v, out_shape, scales):
    for ax in range(2, v.dim()):
        n_in, n_out = v.shape[ax], out_shape[ax]
        if n_in == n_out:
            continue
        pos = torch.arange(n_out, dtype=torch.float32, device=v.device)
        idx = torch.clamp(torch.floor(pos / scales[ax]).long(), 0, n_in - 1)
        v = torch.index_select(v, ax, idx)
    return v


def _upsample_linear(v, out_shape, scales):
    # separable lerp with asymmetric coordinates (src = dst / scale), the
    # Upsample-7/9 semantics
    for ax in range(2, v.dim()):
        n_in, n_out = v.shape[ax], out_shape[ax]
        if n_in == n_out:
            continue
        src = torch.arange(n_out, dtype=torch.float32,
                           device=v.device) / scales[ax]
        i0 = torch.clamp(torch.floor(src).long(), 0, n_in - 1)
        i1 = torch.clamp(i0 + 1, max=n_in - 1)
        shape = [1] * v.dim()
        shape[ax] = n_out
        w = (src - i0.float()).to(v.dtype).reshape(shape)
        v = torch.index_select(v, ax, i0) * (1 - w) \
            + torch.index_select(v, ax, i1) * w
    return v


def _h_upsample(node, args):
    """Legacy Upsample: scales as attribute (opset 7) or second input (9);
    nearest uses asymmetric/floor indexing."""
    a = node.attrs()
    mode = a.get("mode", "nearest")
    if isinstance(mode, bytes):
        mode = mode.decode()
    scales = a.get("scales")
    if scales is None:
        scales = [float(s) for s in np.asarray(_np(args[1])).reshape(-1)]
    x = args[0]
    out_shape = tuple(int(np.floor(d * s)) for d, s in zip(x.shape, scales))
    if out_shape[:2] != tuple(x.shape[:2]):
        raise NotImplementedError(
            "ONNX Upsample on batch/channel dims is not supported")
    if mode == "nearest":
        return _op(_upsample_nearest, x, _name="Upsample",
                   out_shape=out_shape, scales=tuple(scales))
    if mode in ("linear", "bilinear"):
        return _op(_upsample_linear, x, _name="Upsample",
                   out_shape=out_shape, scales=tuple(scales))
    raise NotImplementedError(f"ONNX Upsample mode {mode!r}")


def _h_conv_transpose(node, args):
    from .ops import conv as conv_ops

    a = node.attrs()
    kernel = a.get("kernel_shape", list(args[1].shape[2:]))
    n = len(kernel)
    if a.get("auto_pad", "NOTSET") not in ("NOTSET", b"NOTSET"):
        raise NotImplementedError(
            "ONNX ConvTranspose auto_pad modes are not supported "
            "(exporters emit explicit pads)")
    if a.get("output_shape") is not None:
        raise NotImplementedError(
            "ONNX ConvTranspose output_shape is not supported; use "
            "pads/output_padding")
    return conv_ops.conv_transpose2d(
        args[0], args[1], args[2] if len(args) > 2 else None,
        stride=tuple(a.get("strides", [1] * n)),
        padding=_pairs(a.get("pads", [0] * 2 * n), n),
        dilation=tuple(a.get("dilations", [1] * n)),
        group=a.get("group", 1),
        output_padding=tuple(a.get("output_padding", [0] * n)))


def _h_arg_extremum(fn, name):
    def f(x, axis, keepdims):
        # int32, as the JAX package (its runtime has no int64)
        return fn(x, dim=axis, keepdim=keepdims).to(torch.int32)

    def h(node, args):
        a = node.attrs()
        if a.get("select_last_index", 0):
            raise NotImplementedError(
                f"ONNX {name} select_last_index=1 is not supported")
        return _op(f, args[0], _name=name, axis=a.get("axis", 0),
                   keepdims=bool(a.get("keepdims", 1)))
    return h


def _topk(x, k, axis, largest):
    # a stable sort: equal values keep their index order, as lax.top_k
    y = torch.movedim(x, axis, -1)
    vals, idx = torch.sort(y if largest else -y, dim=-1, descending=True,
                           stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if not largest:
        vals = -vals
    return (torch.movedim(vals, -1, axis),
            torch.movedim(idx.to(torch.int32), -1, axis))


def _h_topk(node, args):
    a = node.attrs()
    if not a.get("sorted", 1):
        raise NotImplementedError("ONNX TopK sorted=0 is not supported")
    return _op(_topk, args[0], _name="TopK",
               k=int(np.asarray(_np(args[1])).reshape(-1)[0]),
               axis=a.get("axis", -1), largest=bool(a.get("largest", 1)))


def _einsum(*xs, eq):
    return torch.einsum(eq, *xs)


def _h_einsum(node, args):
    eq = node.attrs()["equation"]
    if isinstance(eq, bytes):
        eq = eq.decode()
    return _op(_einsum, *args, _name="Einsum", eq=eq)


# ---- ONNX RNN family -> ops/rnn.py's packed-weight stack ------------------
# Gate orders from ONNX's onto the packed buffer's (cuDNN's): LSTM iofc ->
# ifgo; GRU zrh -> rzn.
_ONNX_GATE_PERM = {"lstm": [0, 2, 3, 1], "gru": [1, 0, 2],
                   "vanilla_tanh": [0], "vanilla_relu": [0]}
_ONNX_DEFAULT_ACTS = {
    "lstm": ("sigmoid", "tanh", "tanh"),
    "gru": ("sigmoid", "tanh"),
    "vanilla_tanh": ("tanh",), "vanilla_relu": ("relu",)}


def _flip0(x):
    return torch.flip(x, (0,))


def _h_rnn(onnx_kind):
    def h(node, args):
        from .ops import rnn as rnn_ops

        a = node.attrs()
        H = int(a["hidden_size"])
        direction = a.get("direction", "forward")
        if isinstance(direction, bytes):
            direction = direction.decode()
        n_dirs = 2 if direction == "bidirectional" else 1
        if a.get("layout", 0):
            raise NotImplementedError(
                "ONNX RNN layout=1 is not supported (PyTorch/TF exporters "
                "emit layout=0)")
        if a.get("clip") is not None:
            raise NotImplementedError("ONNX RNN clip is not supported")
        if onnx_kind == "lstm":
            if len(args) > 7 and args[7] is not None:
                raise NotImplementedError(
                    "ONNX LSTM peephole weights (input P) are not "
                    "supported")
            if a.get("input_forget", 0):
                raise NotImplementedError(
                    "ONNX LSTM input_forget=1 is not supported")
        acts = a.get("activations")
        if acts is not None:
            acts = tuple((x.decode() if isinstance(x, bytes) else x).lower()
                         for x in acts)
        mode = onnx_kind
        if onnx_kind == "rnn":
            per_dir_acts = acts or ("tanh",) * n_dirs
            if len(set(per_dir_acts)) > 1:
                raise NotImplementedError(
                    "ONNX RNN with different activations per direction "
                    f"({per_dir_acts}) is not supported")
            first = per_dir_acts[0]
            if first not in ("tanh", "relu"):
                raise NotImplementedError(
                    f"ONNX RNN activation {first!r} is not supported")
            mode = "vanilla_relu" if first == "relu" else "vanilla_tanh"
        elif acts:
            want = _ONNX_DEFAULT_ACTS[mode] * n_dirs
            if acts != want[:len(acts)] or len(acts) < len(want):
                raise NotImplementedError(
                    f"ONNX {node.op_type} non-default activations {acts} "
                    f"are not supported")

        seq_lens = args[4] if len(args) > 4 else None
        T = args[0].shape[0]
        if seq_lens is not None:
            sl = np.asarray(_np(seq_lens)).reshape(-1)
            if not (sl == T).all():
                raise NotImplementedError(
                    "ONNX RNN per-row sequence_lens are not supported "
                    "(all rows must equal the padded length)")
        if mode == "gru" and not a.get("linear_before_reset", 0):
            return _gru_lbr0(node, args, H, direction)

        X, W, R = args[0], args[1], args[2]
        B = args[3] if len(args) > 3 else None
        h0 = args[5] if len(args) > 5 else None
        c0 = args[6] if len(args) > 6 else None
        T, bsz, inp = X.shape
        D = n_dirs
        # direction="reverse": flip time, run forward, flip back (Y_h/Y_c
        # of a reverse scan are the states after its last step, which the
        # flipped forward run yields directly)
        if direction == "reverse":
            X = _op(_flip0, X, _name="Flip")
        G = rnn_ops._GATES[mode]
        row_idx = np.concatenate(
            [np.arange(p * H, (p + 1) * H) for p in _ONNX_GATE_PERM[mode]])
        handle = rnn_ops.RNNHandle(inp, H, num_layers=1, mode=mode,
                                   bidirectional=direction == "bidirectional")

        def pack_dir(d):
            wd = autograd.gather(_slice0(W, d), 0, row_idx)
            rd = autograd.gather(_slice0(R, d), 0, row_idx)
            if B is not None:
                bd = _slice0(B, d)
                b_ih = autograd.gather(bd, 0, row_idx)
                b_hh = autograd.gather(bd, 0, row_idx + G * H)
            else:
                b_ih = b_hh = _const(np.zeros(G * H, np.float32))
            return [autograd.reshape(t, (-1,))
                    for t in (wd, rd, b_ih, b_hh)]

        pieces = []
        for d in range(D):
            pieces.extend(pack_dir(d))
        w_flat = autograd.cat(pieces, 0) if len(pieces) > 1 else pieces[0]
        zeros_h = _const(np.zeros((D, bsz, H), np.float32))
        hx = h0 if h0 is not None else zeros_h
        cx = c0 if c0 is not None else zeros_h
        y, hy, cy = rnn_ops.rnn_forward(X, hx, cx, w_flat, handle)
        # y: (T, B, D*H) -> ONNX Y (T, D, B, H)
        if direction == "reverse":
            y = _op(_flip0, y, _name="Flip")
        y = autograd.reshape(y, (T, bsz, D, H))
        Y = autograd.transpose(y, (0, 2, 1, 3))
        if mode == "lstm":
            return Y, hy, cy
        return Y, hy

    return h


def _slice0(t, i):
    """t[i] along axis 0 as a recorded op (keeps initializer gradients)."""
    return autograd.reshape(autograd.gather(t, 0, np.asarray([i])),
                            tuple(t.shape[1:]))


def _gru_lbr0_fn(x, w, r, *rest, has_b, has_h0, dirs, H):
    b = rest[0] if has_b else None
    h_init = rest[-1] if has_h0 else None
    bsz = x.shape[1]
    ys, hts = [], []
    for di, dname in enumerate(dirs):
        wz, wr, wn = torch.split(w[di], H, dim=0)
        rz, rr, rn = torch.split(r[di], H, dim=0)
        if b is not None:
            wbz, wbr, wbn, rbz, rbr, rbn = torch.split(b[di], H)
        else:
            wbz = wbr = wbn = rbz = rbr = rbn = x.new_zeros(H)
        h = h_init[di] if h_init is not None else x.new_zeros((bsz, H))
        steps = range(x.shape[0] - 1, -1, -1) if dname == "rev" \
            else range(x.shape[0])
        y = [None] * x.shape[0]
        for t in steps:
            xt = x[t]
            z = torch.sigmoid(xt @ wz.T + wbz + h @ rz.T + rbz)
            rg = torch.sigmoid(xt @ wr.T + wbr + h @ rr.T + rbr)
            n = torch.tanh(xt @ wn.T + wbn + (rg * h) @ rn.T + rbn)
            h = (1 - z) * n + z * h
            y[t] = h
        ys.append(torch.stack(y))
        hts.append(h)
    return torch.stack(ys, dim=1), torch.stack(hts, dim=0)


def _gru_lbr0(node, args, H, direction):
    """ONNX GRU with linear_before_reset=0 (the ONNX default): the reset
    gate applies before the recurrent product, a different cell from the
    packed stack's (lbr=1), so it runs as its own loop."""
    X, W, R = args[0], args[1], args[2]
    B = args[3] if len(args) > 3 else None
    h0 = args[5] if len(args) > 5 else None
    dirs = (("fwd", "rev") if direction == "bidirectional"
            else (("rev",) if direction == "reverse" else ("fwd",)))
    ins = [X, W, R] + ([B] if B is not None else []) \
        + ([h0] if h0 is not None else [])
    return _op(_gru_lbr0_fn, *ins, _name="GRU", has_b=B is not None,
               has_h0=h0 is not None, dirs=dirs, H=H)


def _resize_nearest(v, out_shape, scales, ctm):
    for ax in range(2, v.dim()):
        n_in, n_out = v.shape[ax], out_shape[ax]
        if n_in == n_out:
            continue
        pos = torch.arange(n_out, dtype=torch.float32, device=v.device)
        if ctm == "asymmetric":
            idx = torch.floor(pos / scales[ax])
        else:  # half_pixel + round_prefer_floor == ceil(v - 0.5)
            idx = torch.ceil((pos + 0.5) / scales[ax] - 0.5 - 0.5)
        v = torch.index_select(v, ax,
                               torch.clamp(idx.long(), 0, n_in - 1))
    return v


def _resize_linear(v, out_shape):
    # half-pixel centres, no antialias: F.interpolate's linear family
    # without align_corners
    mode = {3: "linear", 4: "bilinear", 5: "trilinear"}[v.dim()]
    return F.interpolate(v, size=tuple(out_shape[2:]), mode=mode,
                         align_corners=False)


def _h_resize(node, args):
    """ONNX Resize: nearest with (asymmetric, floor) or (half_pixel,
    round_prefer_floor), linear with half_pixel; scales or sizes; only
    the trailing spatial dims may change."""
    a = node.attrs()

    def s(key, default):
        v = a.get(key, default)
        return v.decode() if isinstance(v, bytes) else v

    mode = s("mode", "nearest")
    ctm = s("coordinate_transformation_mode", "half_pixel")
    nearest_mode = s("nearest_mode", "round_prefer_floor")
    x = args[0]
    # opset 11+: inputs are (X, roi, scales, sizes)
    scales = args[2] if len(args) > 2 and args[2] is not None else None
    sizes = args[3] if len(args) > 3 and args[3] is not None else None
    if sizes is not None:
        out_shape = tuple(int(v) for v in np.asarray(_np(sizes)).reshape(-1))
        scale_per_dim = [o / d for o, d in zip(out_shape, x.shape)]
    elif scales is not None:
        scale_per_dim = [float(v)
                         for v in np.asarray(_np(scales)).reshape(-1)]
        out_shape = tuple(int(np.floor(d * sc))
                          for d, sc in zip(x.shape, scale_per_dim))
    else:
        raise NotImplementedError("ONNX Resize needs scales or sizes")
    if out_shape[:2] != tuple(x.shape[:2]):
        raise NotImplementedError(
            "ONNX Resize on batch/channel dims is not supported")
    if mode == "nearest":
        if (ctm, nearest_mode) not in (("asymmetric", "floor"),
                                       ("half_pixel", "round_prefer_floor")):
            raise NotImplementedError(
                f"ONNX Resize nearest supports asymmetric+floor and "
                f"half_pixel+round_prefer_floor, got {ctm}+{nearest_mode}")
        return _op(_resize_nearest, x, _name="Resize", out_shape=out_shape,
                   scales=tuple(scale_per_dim), ctm=ctm)
    if mode == "linear":
        if ctm != "half_pixel":
            raise NotImplementedError(
                f"ONNX Resize linear supports half_pixel only, got {ctm}")
        if a.get("antialias", 0):
            raise NotImplementedError(
                "ONNX Resize antialias=1 is not supported")
        return _op(_resize_linear, x, _name="Resize", out_shape=out_shape)
    if mode == "cubic":
        raise NotImplementedError(
            "ONNX Resize mode=cubic is not supported (the JAX package's "
            "Keys a=-0.5 kernel differs from ONNX's default "
            "cubic_coeff_a=-0.75)")
    raise NotImplementedError(f"ONNX Resize mode {mode!r}")


def _instance_norm(x, s, b, eps):
    ax = tuple(range(2, x.dim()))
    mu = torch.mean(x, ax, keepdim=True)
    var = torch.mean(torch.square(x - mu), ax, keepdim=True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mu) / torch.sqrt(var + eps) * s.reshape(shape) \
        + b.reshape(shape)


def _h_instance_norm(node, args):
    return _op(_instance_norm, args[0], args[1], args[2],
               _name="InstanceNormalization",
               eps=node.attrs().get("epsilon", 1e-5))


def _prelu(x, slope):
    # ONNX PRelu broadcasts unidirectionally (trailing-aligned); a (C,)
    # slope applies per channel of NCHW only where trailing alignment
    # cannot claim it
    s = slope
    if s.dim() == 1 and x.dim() > 2 and s.shape[0] == x.shape[1] \
            and s.shape[0] != x.shape[-1]:
        s = s.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x >= 0, x, x * s)


def _h_prelu(node, args):
    return _op(_prelu, args[0], args[1], _name="PRelu")


def _cumsum(x, axis):
    return torch.cumsum(x, axis)


def _h_cumsum(node, args):
    a = node.attrs()
    if a.get("exclusive", 0) or a.get("reverse", 0):
        raise NotImplementedError(
            "ONNX CumSum exclusive/reverse are not supported")
    return _op(_cumsum, args[0], _name="CumSum",
               axis=int(np.asarray(_np(args[1])).reshape(-1)[0]))


def _depth_space(x, bs, mode, to_space):
    n, c, hh, ww = x.shape
    if to_space:
        if mode == "DCR":
            y = x.reshape(n, bs, bs, c // (bs * bs), hh, ww)
            y = y.permute(0, 3, 4, 1, 5, 2)
        else:  # CRD
            y = x.reshape(n, c // (bs * bs), bs, bs, hh, ww)
            y = y.permute(0, 1, 4, 2, 5, 3)
        return y.reshape(n, c // (bs * bs), hh * bs, ww * bs)
    y = x.reshape(n, c, hh // bs, bs, ww // bs, bs)
    y = y.permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * bs * bs, hh // bs, ww // bs)


def _h_depth_space(to_space):
    def h(node, args):
        a = node.attrs()
        mode = a.get("mode", "DCR")
        if isinstance(mode, bytes):
            mode = mode.decode()
        return _op(_depth_space, args[0],
                   _name="DepthToSpace" if to_space else "SpaceToDepth",
                   bs=int(a["blocksize"]), mode=mode, to_space=to_space)
    return h


def _gather_elements(x, i, axis):
    return torch.gather(x, axis, i.long())


def _h_gather_elements(node, args):
    # indices stay an op input (ArgMax/TopK outputs are the common source)
    return _op(_gather_elements, args[0], args[1], _name="GatherElements",
               axis=node.attrs().get("axis", 0))


def _trilu(x, *kt, k, upper):
    if kt:
        k = kt[0].reshape(-1)[0].to(torch.int64)
    r, c = x.shape[-2], x.shape[-1]
    rows = torch.arange(r, device=x.device)[:, None]
    cols = torch.arange(c, device=x.device)[None, :]
    mask = (cols - rows >= k) if upper else (cols - rows <= k)
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _h_trilu(node, args):
    """Trilu-14: the upper/lower triangle of the last two dims; the
    optional second input is the diagonal offset k.  A k the host knows
    (an initializer or Constant) folds into the op; a computed k stays an
    input and the mask compares on the device."""
    upper = bool(node.attrs().get("upper", 1))
    if len(args) <= 1:
        return _op(_trilu, args[0], _name="Trilu", k=0, upper=upper)
    host = getattr(args[1], _HOST_ATTR, None)
    if host is None:
        return _op(_trilu, args[0], args[1], _name="Trilu", k=0,
                   upper=upper)
    return _op(_trilu, args[0], _name="Trilu",
               k=int(np.asarray(host).reshape(-1)[0]), upper=upper)


def _linear_rows(data, idx):
    """ScatterND's index tuples (..., k) as rows of data viewed as
    (prod(shape[:k]), rest)."""
    k = idx.shape[-1]
    idx = idx.long()
    lin = torch.zeros(idx.shape[:-1], dtype=torch.long, device=idx.device)
    for j in range(k):
        lin = lin * data.shape[j] + idx[..., j]
    return lin.reshape(-1), k


_SCATTER_REDUCE = {"mul": "prod", "max": "amax", "min": "amin"}


def _scatter_nd(data, idx, upd, red):
    lin, k = _linear_rows(data, idx)
    d2 = data.reshape((-1,) + tuple(data.shape[k:]))
    u2 = upd.reshape((lin.shape[0],) + tuple(data.shape[k:])).to(data.dtype)
    if red == "none":
        out = d2.index_copy(0, lin, u2)
    elif red == "add":
        out = d2.index_add(0, lin, u2)
    else:
        flat = d2.reshape(d2.shape[0], -1)
        out = flat.scatter_reduce(
            0, lin[:, None].expand(-1, flat.shape[1]),
            u2.reshape(u2.shape[0], -1), _SCATTER_REDUCE[red],
            include_self=True)
    return out.reshape(data.shape)


def _reduction(node, opname):
    red = node.attrs().get("reduction", "none")
    if isinstance(red, bytes):
        red = red.decode()
    if red not in ("none", "add", "mul", "max", "min"):
        raise NotImplementedError(
            f"ONNX {opname} reduction {red!r} is not supported")
    return red


def _h_scatter_nd(node, args):
    """ScatterND-11/16/18 (none/add/mul/max/min).  With duplicate indices
    and reduction 'none' the spec leaves the result undefined."""
    return _op(_scatter_nd, args[0], args[1], args[2], _name="ScatterND",
               red=_reduction(node, "ScatterND"))


def _scatter_elements(data, idx, upd, axis, red):
    idx = idx.long()
    upd = upd.to(data.dtype)
    if red == "none":
        return torch.scatter(data, axis, idx, upd)
    if red == "add":
        return torch.scatter_add(data, axis, idx, upd)
    return torch.scatter_reduce(data, axis, idx, upd, _SCATTER_REDUCE[red],
                                include_self=True)


def _h_scatter_elements(node, args):
    """ScatterElements-11/16/18 (and legacy Scatter-9)."""
    return _op(_scatter_elements, args[0], args[1], args[2],
               _name="ScatterElements", axis=node.attrs().get("axis", 0),
               red=_reduction(node, "ScatterElements"))


def _gather_nd(data, idx, b):
    idx = idx.long()
    batch = tuple(data.shape[:b])
    nb = int(np.prod(batch)) if b else 1
    d = data.reshape((nb,) + tuple(data.shape[b:]))
    i = idx.reshape((nb, -1, idx.shape[-1]))
    ar = torch.arange(nb, device=data.device)[:, None]
    y = d[(ar,) + tuple(i[..., j] for j in range(i.shape[-1]))]
    return y.reshape(batch + tuple(idx.shape[b:-1]) + tuple(y.shape[2:]))


def _h_gather_nd(node, args):
    """GatherND-11/12/13 with batch_dims."""
    return _op(_gather_nd, args[0], args[1], _name="GatherND",
               b=int(node.attrs().get("batch_dims", 0)))


def _nonzero(x):
    return torch.stack(torch.nonzero(x, as_tuple=True)).to(torch.int32)


def _h_nonzero(node, args):
    """NonZero-9/13: (rank, N) int32 indices of the nonzero elements.  The
    output's shape depends on the data: eager only (module docstring)."""
    if _capturing(args[0]):
        raise RuntimeError(
            f"{_node_desc()} has a data-dependent output shape, which a "
            f"CUDA-graph capture cannot hold; run this graph eagerly")
    return _op(_nonzero, args[0], _name="NonZero")


def _group_norm(x, s, b, g, eps):
    n, c = x.shape[0], x.shape[1]
    if c % g:
        raise ValueError(f"GroupNormalization: channels {c} not divisible "
                         f"by num_groups {g}")
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    ax = tuple(range(2, xg.dim()))
    mu = torch.mean(xg, ax, keepdim=True)
    var = torch.mean(torch.square(xg - mu), ax, keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    if s.shape[0] == g and s.shape[0] != c:  # per group (opset 18)
        s = torch.repeat_interleave(s, c // g)
        b = torch.repeat_interleave(b, c // g)
    elif s.shape[0] != c:
        raise ValueError(f"GroupNormalization scale length {s.shape[0]} is "
                         f"neither C={c} nor num_groups={g}")
    shape = (1, c) + (1,) * (x.dim() - 2)
    return y * s.reshape(shape) + b.reshape(shape)


def _h_group_norm(node, args):
    """GroupNormalization-18/21: scale and bias per group (18) or per
    channel (21), told apart by length."""
    a = node.attrs()
    return _op(_group_norm, args[0], args[1], args[2],
               _name="GroupNormalization", g=int(a["num_groups"]),
               eps=a.get("epsilon", 1e-5))


def _isinf(x, neg, pos):
    return torch.isinf(x) & ((pos & (x > 0)) | (neg & (x < 0)))


def _hardmax(x, axis):
    oh = F.one_hot(torch.argmax(x, dim=axis), x.shape[axis]).to(x.dtype)
    return torch.movedim(oh, -1, axis)


def _eye_like(x, k, dt):
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    cols = torch.arange(x.shape[1], device=x.device)[None, :]
    dtype = x.dtype if dt is None else autograd._torch_dtype(
        onnx_pb.DTYPE_TO_NP[dt])
    return (cols - rows == k).to(dtype)


def _size(x):
    return torch.full((), x.numel(), dtype=torch.int32, device=x.device)


def _celu(x, alpha):
    return torch.clamp_min(x, 0) + torch.clamp_max(
        alpha * (torch.exp(x / alpha) - 1), 0)


def _shrink(x, lambd, bias):
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x > lambd, x - bias,
                       torch.where(x < -lambd, x + bias, zero))


def _nary(fn, name):
    def h(node, args):
        return _op(fn, *args, _name=name)
    return h


def _sum_n(*xs):
    return functools.reduce(torch.add, xs)


def _mean_n(*xs):
    return functools.reduce(torch.add, xs) / len(xs)


def _matmul(a, b):
    return torch.matmul(*amp.cast_in(a, b))


def _relu(x):
    return torch.clamp_min(x, 0)


def _sigmoid(x):
    return 1 / (1 + torch.exp(-x))


def _mod(fmod):
    return torch.fmod if fmod else torch.remainder


# subgraph-carrying control-flow ops, dispatched by _exec_nodes (they need
# the enclosing env); the conformance sweep counts them as supported
_CONTROL_FLOW_OPS = ("If", "Loop", "Scan")

_ONNX_OPS = {
    "Add": _handle_binary(torch.add),
    "Sub": _handle_binary(torch.sub),
    "Mul": _handle_binary(torch.mul),
    "Div": _handle_binary(torch.true_divide),
    "Pow": _handle_binary(torch.pow),
    # the amp cast of a native Linear's product applies here too
    "MatMul": _handle_binary(_matmul),
    "Equal": _handle_binary(torch.eq),
    "Greater": _handle_binary(torch.gt),
    "Less": _handle_binary(torch.lt),
    "Min": _handle_binary(torch.minimum),
    "Max": _handle_binary(torch.maximum),
    "Relu": _handle_unary(_relu),
    "Sigmoid": _handle_unary(_sigmoid),
    "Tanh": _handle_unary(torch.tanh),
    "Erf": _handle_unary(torch.erf),
    "Exp": _handle_unary(torch.exp),
    "Log": _handle_unary(torch.log),
    "Sqrt": _handle_unary(torch.sqrt),
    "Neg": _handle_unary(torch.neg),
    "Abs": _handle_unary(torch.abs),
    "Reciprocal": _handle_unary(torch.reciprocal),
    "Identity": _handle_unary(autograd._identity),
    "Floor": _handle_unary(torch.floor),
    "Ceil": _handle_unary(torch.ceil),
    # ONNX Gelu defaults to the exact erf form (approximate="none")
    "Gelu": lambda node, args: autograd.gelu(
        args[0],
        approximate=node.attrs().get("approximate", "none") == "tanh"),
    "LeakyRelu": lambda node, args: autograd.leakyrelu(
        args[0], node.attrs().get("alpha", 0.01)),
    "Elu": lambda node, args: autograd.elu(
        args[0], node.attrs().get("alpha", 1.0)),
    "Selu": lambda node, args: autograd.selu(args[0]),
    "Softplus": lambda node, args: autograd.softplus(args[0]),
    "Gemm": _h_gemm,
    "Conv": _h_conv,
    "MaxPool": _h_pool(True),
    "AveragePool": _h_pool(False),
    "GlobalAveragePool": _h_global_avg_pool,
    "GlobalMaxPool": _h_global_max_pool,
    "Upsample": _h_upsample,
    "BatchNormalization": _h_batchnorm,
    "Reshape": _h_reshape,
    "Transpose": _h_transpose,
    "Concat": _h_concat,
    "Softmax": _h_softmax,
    "Flatten": _h_flatten,
    "Squeeze": _h_squeeze,
    "Unsqueeze": _h_unsqueeze,
    "Gather": _h_gather,
    "Slice": _h_slice,
    "Split": _h_split,
    "Cast": _h_cast,
    "Clip": _h_clip,
    "ReduceMean": _h_reduce,
    "ReduceSum": _h_reduce,
    "ReduceMax": _h_reduce,
    "ReduceMin": _h_reduce,
    "Constant": _h_constant,
    "ConstantOfShape": _h_constant_of_shape,
    "Shape": _h_shape,
    "Expand": _h_expand,
    "Dropout": _h_dropout,
    "LayerNormalization": _h_layernorm,
    "Where": _h_where,
    "OneHot": _h_onehot,
    "Range": _h_range,
    "Tile": _h_tile,
    "Pad": _h_pad,
    "ConvTranspose": _h_conv_transpose,
    "Resize": _h_resize,
    "InstanceNormalization": _h_instance_norm,
    "PRelu": _h_prelu,
    "CumSum": _h_cumsum,
    "DepthToSpace": _h_depth_space(True),
    "SpaceToDepth": _h_depth_space(False),
    "GatherElements": _h_gather_elements,
    "Trilu": _h_trilu,
    "ScatterND": _h_scatter_nd,
    "ScatterElements": _h_scatter_elements,
    "GatherND": _h_gather_nd,
    "NonZero": _h_nonzero,
    "GroupNormalization": _h_group_norm,
    "And": _handle_binary(torch.logical_and),
    "Or": _handle_binary(torch.logical_or),
    "Xor": _handle_binary(torch.logical_xor),
    "Not": _handle_unary(torch.logical_not),
    "GreaterOrEqual": _handle_binary(torch.ge),
    "LessOrEqual": _handle_binary(torch.le),
    "Mod": lambda node, args: _handle_binary(
        _mod(node.attrs().get("fmod", 0)))(node, args),
    "Sign": _handle_unary(torch.sign),
    "Round": _handle_unary(torch.round),  # half to even, as jnp.round
    "Sin": _handle_unary(torch.sin),
    "Cos": _handle_unary(torch.cos),
    "Tan": _handle_unary(torch.tan),
    "Asin": _handle_unary(torch.asin),
    "Acos": _handle_unary(torch.acos),
    "Atan": _handle_unary(torch.atan),
    "Sinh": _handle_unary(torch.sinh),
    "Cosh": _handle_unary(torch.cosh),
    "Asinh": _handle_unary(torch.asinh),
    "Acosh": _handle_unary(torch.acosh),
    "Atanh": _handle_unary(torch.atanh),
    "IsNaN": _handle_unary(torch.isnan),
    "IsInf": lambda node, args: _op(
        _isinf, args[0], _name="IsInf",
        neg=bool(node.attrs().get("detect_negative", 1)),
        pos=bool(node.attrs().get("detect_positive", 1))),
    "ReduceLogSum": _h_reduce,
    # opset-13 Hardmax: one-hot of the argmax along ``axis``
    "Hardmax": lambda node, args: _op(
        _hardmax, args[0], _name="Hardmax",
        axis=node.attrs().get("axis", -1)),
    "Sum": _nary(_sum_n, "Sum"),
    "Mean": _nary(_mean_n, "Mean"),
    "Size": _handle_unary(_size),
    "EyeLike": lambda node, args: _op(
        _eye_like, args[0], _name="EyeLike", k=node.attrs().get("k", 0),
        dt=node.attrs().get("dtype")),
    "Softsign": _handle_unary(lambda x: x / (1 + torch.abs(x))),
    "HardSigmoid": lambda node, args: _op(
        lambda x, alpha, beta: torch.clamp(alpha * x + beta, 0.0, 1.0),
        args[0], _name="HardSigmoid", alpha=node.attrs().get("alpha", 0.2),
        beta=node.attrs().get("beta", 0.5)),
    "HardSwish": _handle_unary(
        lambda x: x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)),
    "LogSoftmax": lambda node, args: _op(
        lambda x, axis: torch.log_softmax(x, dim=axis), args[0],
        _name="LogSoftmax", axis=node.attrs().get("axis", -1)),
    "Celu": lambda node, args: _op(
        _celu, args[0], _name="Celu", alpha=node.attrs().get("alpha", 1.0)),
    "Mish": _handle_unary(lambda x: x * torch.tanh(torch.log1p(
        torch.exp(x)))),
    "ThresholdedRelu": lambda node, args: _op(
        lambda x, alpha: torch.where(x > alpha, x, torch.zeros_like(x)),
        args[0], _name="ThresholdedRelu",
        alpha=node.attrs().get("alpha", 1.0)),
    "Shrink": lambda node, args: _op(
        _shrink, args[0], _name="Shrink",
        lambd=node.attrs().get("lambd", 0.5),
        bias=node.attrs().get("bias", 0.0)),
    "ReduceSumSquare": _h_reduce,
    "ReduceProd": _h_reduce,
    "ReduceL1": _h_reduce,
    "ReduceL2": _h_reduce,
    "ReduceLogSumExp": _h_reduce,
    "ArgMin": _h_arg_extremum(torch.argmin, "ArgMin"),
    "ArgMax": _h_arg_extremum(torch.argmax, "ArgMax"),
    "TopK": _h_topk,
    "Einsum": _h_einsum,
    "LSTM": _h_rnn("lstm"),
    "GRU": _h_rnn("gru"),
    "RNN": _h_rnn("rnn"),
}


# ---------------------------------------------------------------------------
# Frontend: export record -> ONNX (SingaFrontend.to_onnx)
# ---------------------------------------------------------------------------

# recorded op names (the part before '#') -> ONNX op types
_EXPORT_OPS = {
    "ReLU": "Relu", "Sigmoid": "Sigmoid", "Tanh": "Tanh", "Gelu": "Gelu",
    "Add": "Add", "Sub": "Sub", "Mul": "Mul", "Div": "Div", "Pow": "Pow",
    "Matmul": "MatMul", "AddBias": "Add", "SoftMax": "Softmax",
    "Exp": "Exp", "Log": "Log", "Sqrt": "Sqrt", "Abs": "Abs",
    "Negative": "Neg", "Conv2d": "Conv", "MaxPool2d": "MaxPool",
    "ConvTranspose2d": "ConvTranspose",
    "AvgPool2d": "AveragePool",
    "Flatten": "Flatten", "Reshape": "Reshape", "Transpose": "Transpose",
    "Concat": "Concat", "Identity": "Identity", "Erf": "Erf",
    "LayerNorm": "LayerNormalization", "_Dropout": "Dropout",
}


# -- decomposed export of fused ops ------------------------------------------
# The fused ops (attention, the embedding gather, BERT's mask builders...)
# have no single ONNX node; they export as small subgraphs of standard ops
# that the backend imports back.  Each decomposer receives an _Emit bound
# to the graph being built and names its final output(s) f"{stem}_out{i}".

def _dec_attention(op, in_names, emit, out_name):
    """(q, k, v[, mask]) attention -> Transpose/MatMul/Mul/(Add)/Softmax/
    MatMul; the causal variant bakes a static (S, T) additive mask."""
    p = getattr(op, "params", {}) or {}
    scale = float(p.get("scale", 1.0))
    causal = bool(p.get("causal", False))
    q_t, k_t = op.src[0][2], op.src[1][2]
    s, t = q_t.shape[-2], k_t.shape[-2]
    u = emit.uniq("Attention")
    kt = f"{u}_kT"
    emit.node("Transpose", [in_names[1]], [kt], perm=[0, 1, 3, 2])
    sc = f"{u}_scores"
    emit.node("MatMul", [in_names[0], kt], [sc])
    cur = f"{u}_scaled"
    emit.node("Mul", [sc, emit.const(f"const_scale_{float(scale)!r}",
                                     np.float32(scale))], [cur])
    if len(in_names) > 3:
        nxt = f"{u}_masked"
        emit.node("Add", [cur, in_names[3]], [nxt])
        cur = nxt
    if causal:
        keep = np.tril(np.ones((s, t), bool))
        window = p.get("window")
        if window is not None:  # sliding-window band
            i, j = np.arange(s)[:, None], np.arange(t)[None, :]
            keep &= (i - j) < int(window)
        cm = np.where(keep, 0.0, -1e9).astype(np.float32)
        nxt = f"{u}_causal"
        # shape-keyed name: every layer shares one mask constant
        wtag = "" if window is None else f"_w{int(window)}"
        emit.node("Add", [cur, emit.const(f"const_causal_{s}x{t}{wtag}",
                                          cm)], [nxt])
        cur = nxt
    pr = f"{u}_probs"
    emit.node("Softmax", [cur], [pr], axis=-1)
    emit.node("MatMul", [pr, in_names[2]], [out_name])


def _dec_embedding(op, in_names, emit, out_name):
    """embedding(ids, W) -> Gather(W, ids)."""
    emit.node("Gather", [in_names[1], in_names[0]], [out_name], axis=0)


def _dec_repeat_kv(op, in_names, emit, out_name):
    """GQA K/V head repeat (B, H_kv, S, D) -> (B, H_kv·g, S, D),
    element-interleaved: Reshape(+1 axis) / Tile(g) / Reshape(merge)."""
    g = int((getattr(op, "params", {}) or {}).get("repeats", 1))
    b, hkv, s, d = op.src[0][2].shape
    u = emit.uniq("RepeatKV")
    r5 = f"{u}_r5d"
    emit.node("Reshape", [in_names[0], emit.const(
        f"const_shape_{b}x{hkv}x1x{s}x{d}",
        np.asarray([b, hkv, 1, s, d], np.int64))], [r5])
    t5 = f"{u}_tiled"
    emit.node("Tile", [r5, emit.const(
        f"const_reps_11{g}11", np.asarray([1, 1, g, 1, 1], np.int64))],
        [t5])
    emit.node("Reshape", [t5, emit.const(
        f"const_shape_{b}x{hkv * g}x{s}x{d}",
        np.asarray([b, hkv * g, s, d], np.int64))], [out_name])


def _dec_attn_mask(op, in_names, emit, out_name):
    """BERT's (1-m)·-1e9 [:, None, None, :] -> Sub/Mul/Unsqueeze."""
    u = emit.uniq("AttnMask")
    t1, t2 = f"{u}_inv", f"{u}_scaled"
    emit.node("Sub", [emit.const("const_one_f32", np.float32(1.0)),
                      in_names[0]], [t1])
    emit.node("Mul", [t1, emit.const("const_neg1e9_f32",
                                     np.float32(-1e9))], [t2])
    # opset >= 13: axes is an input
    emit.node("Unsqueeze",
              [t2, emit.const("const_axes_1_2",
                              np.asarray([1, 2], np.int64))], [out_name])


def _dec_first_token(op, in_names, emit, out_name):
    """x[:, 0, :] -> Gather(x, 0, axis=1) (a scalar index drops the
    axis)."""
    emit.node("Gather",
              [in_names[0],
               emit.const("const_idx0_i64", np.asarray(0, np.int64))],
              [out_name], axis=1)


def _dec_batchnorm(op, in_names, emit, out_name):
    """BN -> the 5-input BatchNormalization node; the running statistics
    ride ``op.params`` (they are layer state, not op inputs) and export
    as constants under their state names."""
    p = getattr(op, "params", {}) or {}
    u = emit.uniq("bn")
    names = []
    for key in ("rm", "rv"):
        t = p[key]
        arr = tensor.to_numpy(t).astype(np.float32)
        names.append(emit.const(emit.state_name(t) or f"{u}_{key}", arr))
    emit.node("BatchNormalization",
              [in_names[0], in_names[1], in_names[2], names[0], names[1]],
              [out_name], epsilon=float(p.get("eps", 1e-5)),
              momentum=float(p.get("momentum", 0.9)))


def _dec_reduce_mean(op, in_names, emit, out_name):
    """reduce_mean(x, axes) -> ReduceMean with axes as an input (opset
    >= 18)."""
    p = getattr(op, "params", {}) or {}
    ax = p.get("ax")
    ins = [in_names[0]]
    if ax is not None:
        axes = np.asarray(list(ax), np.int64)
        ins.append(emit.const(
            f"const_axes_{'_'.join(map(str, axes.tolist()))}", axes))
    emit.node("ReduceMean", ins, [out_name],
              keepdims=1 if p.get("keepdims") else 0)


def _dec_relu6(op, in_names, emit, out_name):
    """relu6(x) -> Clip(x, 0, 6)."""
    emit.node("Clip",
              [in_names[0],
               emit.const("const_zero_f32", np.float32(0.0)),
               emit.const("const_six_f32", np.float32(6.0))], [out_name])


def _dec_mul_scalar(op, in_names, emit, out_name):
    s = float((getattr(op, "params", {}) or {}).get("s", 1.0))
    emit.node("Mul", [in_names[0], emit.const(f"const_scalar_{s!r}",
                                              np.float32(s))], [out_name])


# gate orders for export (ours -> ONNX): inverse of _ONNX_GATE_PERM
_EXPORT_GATE_PERM = {"lstm": [0, 3, 1, 2], "gru": [1, 0, 2],
                     "vanilla_tanh": [0], "vanilla_relu": [0]}
_EXPORT_RNN_NODE = {"lstm": "LSTM", "gru": "GRU",
                    "vanilla_tanh": "RNN", "vanilla_relu": "RNN"}


def _dec_rnn(op, in_names, emit, out_name):
    """One recorded ``RNN[l{l}d{d}]`` scan -> one ONNX LSTM/GRU/RNN node.
    W/R/B are unpacked from the flat weight's values (the inverse gate
    reorder of the importer's); the initial states are wired from the
    op's hx/cx inputs through Slice nodes; the op's outputs (y, h_T, c_T)
    become Squeeze views of the node's Y / Y_h / Y_c."""
    p = getattr(op, "params", {}) or {}
    mode = p["mode"]
    H = int(p["hidden"])
    reverse = int(p["direction"]) == 1
    idx = int(p["idx"])
    sl = p["slices"]
    w_flat = tensor.to_numpy(op.src[3][2])

    def unpack(name):
        a, b, shape = sl[name]
        return w_flat[a:b].reshape(shape)

    ridx = np.concatenate([np.arange(q * H, (q + 1) * H)
                           for q in _EXPORT_GATE_PERM[mode]])
    W = unpack("w_ih")[ridx][None]
    R = unpack("w_hh")[ridx][None]
    B = np.concatenate([unpack("b_ih")[ridx], unpack("b_hh")[ridx]])[None]

    u = emit.uniq(_EXPORT_RNN_NODE[mode])

    def row(src_name, tag):
        # hx/cx are (L*D, B, H); the node wants row ``idx`` as (1, B, H)
        out = f"{u}_{tag}"
        emit.node("Slice",
                  [src_name,
                   emit.const(f"const_i64_{idx}",
                              np.asarray([idx], np.int64)),
                   emit.const(f"const_i64_{idx + 1}",
                              np.asarray([idx + 1], np.int64)),
                   emit.const("const_i64_0", np.asarray([0], np.int64))],
                  [out])
        return out

    wn = emit.const(f"{u}_W", W.astype(np.float32))
    rn = emit.const(f"{u}_R", R.astype(np.float32))
    bn = emit.const(f"{u}_B", B.astype(np.float32))
    ins = [in_names[0], wn, rn, bn, "", row(in_names[1], "h0")]
    attrs = dict(hidden_size=H)
    if reverse:
        attrs["direction"] = "reverse"
    if mode == "gru":
        attrs["linear_before_reset"] = 1  # the cuDNN cell form
    if mode == "vanilla_relu":
        attrs["activations"] = ["Relu"]
    y_raw, h_raw = f"{u}_Y", f"{u}_Yh"
    outs = [y_raw, h_raw]
    if mode == "lstm":
        ins.append(row(in_names[2], "c0"))
        outs.append(f"{u}_Yc")
    emit.node(_EXPORT_RNN_NODE[mode], ins, outs, **attrs)

    assert out_name.endswith("_out0"), out_name
    stem = out_name[:-1]
    ax1 = emit.const("const_i64_axes1", np.asarray([1], np.int64))
    ax0 = emit.const("const_i64_axes0", np.asarray([0], np.int64))
    emit.node("Squeeze", [y_raw, ax1], [out_name])
    emit.node("Squeeze", [h_raw, ax0], [stem + "1"])
    if mode == "lstm":
        emit.node("Squeeze", [f"{u}_Yc", ax0], [stem + "2"])
    else:
        # c_T of the modes without a cell state is zeros: h - h
        emit.node("Sub", [stem + "1", stem + "1"], [stem + "2"])


_EXPORT_DECOMPOSE = {
    "Attention": _dec_attention,
    "TPAttention": _dec_attention,
    "Embedding": _dec_embedding,
    "RepeatKV": _dec_repeat_kv,
    "AttnMask": _dec_attn_mask,
    "FirstToken": _dec_first_token,
    "MulScalar": _dec_mul_scalar,
    "ReLU6": _dec_relu6,
    "ReduceMean": _dec_reduce_mean,
    "BatchNorm2d": _dec_batchnorm,
}


def _record_forward(m, inputs):
    """One forward of ``m`` on ``inputs`` recorded for export: training
    mode, float32 compute, no gradient.  Returns (record, outputs)."""
    params = m.get_params() if hasattr(m, "get_params") else {}
    prev_mode, prev_dtype = m.training, amp._compute_dtype
    m.train(True)
    amp.set_compute_dtype(None)
    try:
        with autograd.ExportRecord(
                roots=list(inputs) + list(params.values())) as rec, \
                torch.no_grad():
            y = m.forward(*inputs)
    finally:
        m.train(prev_mode)
        amp._compute_dtype = prev_dtype
    return rec, (list(y) if isinstance(y, (list, tuple)) else [y])


def to_onnx(m, inputs, model_name="singa_model"):
    """Export ``m``'s forward graph on ``inputs`` (a list of tensors) to an
    ONNX ``ModelProto`` (module docstring)."""
    rec, outputs = _record_forward(m, inputs)
    params = m.get_params() if hasattr(m, "get_params") else {}
    param_by_id = {id(t): (name, t) for name, t in params.items()}
    state_names = {}
    if hasattr(m, "get_states"):
        state_names = {id(t): name for name, t in m.get_states().items()}
    input_names = {id(t): f"input_{i}" for i, t in enumerate(inputs)}

    nodes = []
    initializers = []
    seen_ops = set()
    name_ctr = [0]
    op_unames = {}

    def tensor_name(op, idx):
        # ops made by _op(_name=...) share their name across instances:
        # qualify it per instance, or value names would collide
        if id(op) not in op_unames:
            op_unames[id(op)] = f"{op.name}_{len(op_unames)}"
        return f"{op_unames[id(op)]}_out{idx}"

    exported = set()

    class _Emit:
        """Graph-building helper handed to the decomposers."""

        def uniq(self, base):
            name_ctr[0] += 1
            return f"{base}_{name_ctr[0]}"

        def node(self, op_type, ins, outs, **attrs):
            n = NodeProto(op_type=op_type,
                          name=f"{op_type}_{self.uniq('n')}",
                          input=list(ins), output=list(outs))
            for k, v in attrs.items():
                n.attribute.append(AttributeProto.make(k, v))
            nodes.append(n)
            return n

        def const(self, name, arr):
            """A value as a Constant node (initializers import as
            trainable weights; a baked mask or scale must not), deduped
            by name."""
            if name not in exported:
                exported.add(name)
                self.node("Constant", [], [name],
                          value=TensorProto.from_numpy(np.asarray(arr),
                                                       name))
            return name

        @staticmethod
        def state_name(t):
            return state_names.get(id(t))

    emit = _Emit()

    def visit(op):
        if id(op) in seen_ops:
            return
        seen_ops.add(id(op))
        base = op.name.split("#")[0]
        is_rnn = base.startswith("RNN[l")
        in_names = []
        for src_i, (src_op, x_id, x_t, _) in enumerate(op.src):
            if is_rnn and src_i == 3:
                # the packed flat weight: _dec_rnn writes it as unpacked
                # W/R/B constants
                in_names.append(None)
                continue
            if x_id in input_names:
                in_names.append(input_names[x_id])
            elif x_id in param_by_id:
                pname, pt = param_by_id[x_id]
                in_names.append(pname)
                if pname not in exported:
                    exported.add(pname)
                    initializers.append(
                        TensorProto.from_numpy(tensor.to_numpy(pt), pname))
            elif src_op is not None \
                    and not isinstance(src_op, autograd.Dummy):
                visit(src_op)
                in_names.append(tensor_name(src_op, src_op.y_id2idx[x_id]))
            else:
                fn = rec.lineage_of(x_t)
                if fn is not None:
                    raise NotImplementedError(
                        f"export: an input of {base!r} was computed from "
                        f"the model's inputs or parameters by {fn}, which "
                        f"records no op; compute it with the autograd "
                        f"ops, or feed it as a model input")
                # a leaf no input or parameter flows into (position ids):
                # bake it as an initializer
                cname = f"const_{x_id}"
                in_names.append(cname)
                if cname not in exported:
                    exported.add(cname)
                    initializers.append(
                        TensorProto.from_numpy(tensor.to_numpy(x_t), cname))
        if is_rnn:
            _dec_rnn(op, in_names, emit, tensor_name(op, 0))
            return
        if base in _EXPORT_DECOMPOSE:
            _EXPORT_DECOMPOSE[base](op, in_names, emit, tensor_name(op, 0))
            return
        onnx_type = _EXPORT_OPS.get(base)
        if onnx_type is None:
            raise NotImplementedError(
                f"export of op {base!r} not supported by sonnx frontend")
        p = getattr(op, "params", {}) or {}
        if base == "Reshape":
            # ONNX Reshape takes the target shape as an int64 input
            shape = tuple(p.get("shape"))
            in_names.append(emit.const(
                "const_shape_" + "_".join(str(s) for s in shape),
                np.asarray(shape, np.int64)))
        out_names = [tensor_name(op, i) for i in range(len(op.y_id2idx))]
        node = NodeProto(op_type=onnx_type, name=f"{base}_{name_ctr[0]}",
                         input=in_names, output=out_names)
        name_ctr[0] += 1
        attr = node.attribute
        if base == "SoftMax":
            attr.append(AttributeProto.make("axis", p.get("axis", -1)))
        elif base == "Concat":
            # ONNX Concat has no default axis
            attr.append(AttributeProto.make("axis", int(p["axis"])))
        elif base == "Flatten":
            attr.append(AttributeProto.make("axis", p.get("axis", 1)))
        elif base == "Transpose" and p.get("perm") is not None:
            attr.append(AttributeProto.make("perm", list(p["perm"])))
        elif base in ("Conv2d", "ConvTranspose2d"):
            attr.append(AttributeProto.make(
                "strides", list(p.get("stride", (1, 1)))))
            pads = p.get("pads", ((0, 0), (0, 0)))
            # ONNX layout: all lows, then all highs
            attr.append(AttributeProto.make(
                "pads", [pr[0] for pr in pads] + [pr[1] for pr in pads]))
            attr.append(AttributeProto.make(
                "dilations", list(p.get("dilation", (1, 1)))))
            attr.append(AttributeProto.make("group", p.get("group", 1)))
            if base == "ConvTranspose2d":
                attr.append(AttributeProto.make(
                    "output_padding", list(p.get("output_padding", (0, 0)))))
        elif base in ("MaxPool2d", "AvgPool2d"):
            attr.append(AttributeProto.make("kernel_shape",
                                            list(p["kernel"])))
            attr.append(AttributeProto.make(
                "strides", list(p.get("stride", p["kernel"]))))
            pairs = p.get("pads_pairs", ((0, 0), (0, 0)))
            attr.append(AttributeProto.make(
                "pads", [pairs[0][0], pairs[1][0], pairs[0][1],
                         pairs[1][1]]))
        elif base == "LayerNorm":
            attr.append(AttributeProto.make("epsilon",
                                            float(p.get("eps", 1e-5))))
            attr.append(AttributeProto.make("axis", int(p.get("axis", -1))))
        elif base == "Gelu":
            attr.append(AttributeProto.make(
                "approximate",
                "tanh" if p.get("approximate", True) else "none"))
        elif base == "_Dropout":
            # opset >= 12: ratio is an input
            r = float(getattr(op, "ratio", 0.5))
            node.input.append(emit.const(f"const_scalar_{r!r}",
                                         np.float32(r)))
        nodes.append(node)

    out_infos = []
    for out in outputs:
        op = rec.producer.get(id(out))
        if op is None:
            fn = rec.lineage_of(out)
            raise NotImplementedError(
                "export requires a recorded forward: an output was "
                + (f"computed by {fn}, which records no op" if fn
                   else "made by no op"))
        visit(op)
        out_infos.append(ValueInfoProto(
            name=tensor_name(op, op.y_id2idx[id(out)]),
            elem_type=onnx_pb.FLOAT, shape=list(out.shape)))

    # visit() appends producers before consumers: topologically sorted
    in_infos = [ValueInfoProto(name=f"input_{i}", elem_type=onnx_pb.FLOAT,
                               shape=list(t.shape))
                for i, t in enumerate(inputs)]
    in_infos += [ValueInfoProto(name=t.name, elem_type=t.data_type,
                                shape=list(t.dims))
                 for t in initializers]
    g = GraphProto(name=model_name, node=nodes, initializer=initializers,
                   input=in_infos, output=out_infos)
    # opset 20: the earliest covering everything emitted (Gelu's
    # approximate attribute; Unsqueeze axes as an input needs 13, Dropout
    # ratio as an input 12)
    proto = ModelProto(graph=g)
    for o in proto.opset_import:
        if not o.domain:
            o.version = 20
    return proto


class SingaFrontend:
    to_onnx = staticmethod(to_onnx)


def save(model_proto: ModelProto, path: str):
    onnx_pb.save_model(model_proto, path)


def load(path: str) -> ModelProto:
    return onnx_pb.load_model(path)
