"""``Model`` API (counterpart of ``singa_tpu/model.py:121-486``):
``compile(inputs, is_train, use_graph, sequential)``, a user-overridden
``train_one_batch``, ``set_optimizer``, ``train``/``eval``,
``train_n_batches``, ``get_states``/``set_states`` under the JAX
package's state names, and checkpoints: ``save_states``/``load_states``.

A checkpoint is the JAX package's zip, one ``.npy`` a tensor: the
``get_states()`` names, then ``__opt__<name>`` for the optimizer's state
(``__opt____step_counter__`` among them), then ``__aux__<name>`` for the
caller's extras.  Each array's ``.npy`` bytes are those the JAX package
writes for it; a bf16 state is stored as the JAX package stores it (its
bits under the header descr ``<V2``, what ``np.save`` makes of an
``ml_dtypes.bfloat16`` array), and ``load_states`` reads such an array
back as bf16.  So zips carry a model between the two packages both ways.
The port stores its entries uncompressed where the JAX package deflates
them (each package reads both): deflate shrinks float weights by a few
percent and is slow, two minutes for two saves of VGG-16's 1.1 GB of
weights and momentum on the host of an H100 machine.

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

import io as _io
import os
import stat as _stat
import tempfile
import threading
import uuid as _uuid
import zipfile

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import amp, graphs, layer
from .observe import trace as _trace
from .observe.registry import registry as _obs_registry
from .resilience import faults as _faults

__all__ = ["Model", "AsyncSaveHandle"]

#: umask-derived checkpoint file mode, per directory (``_ckpt_mode``)
_CKPT_MODES = {}
#: the ``.npy`` header descr the JAX package writes for a bf16 array
_BF16_DESCR = "<V2"


def _ckpt_mode(ckpt_dir):
    """The mode a file created in ``ckpt_dir`` gets from the umask and the
    directory's default ACLs, read from a probe file made there (the
    process umask is never changed); cached per directory."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    mode = _CKPT_MODES.get(ckpt_dir)
    if mode is None:
        p = os.path.join(ckpt_dir, f".singa-tpu-mode-{_uuid.uuid4().hex}")
        fd = os.open(p, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o666)
        try:
            mode = _stat.S_IMODE(os.fstat(fd).st_mode)
        finally:
            os.close(fd)
            try:
                os.unlink(p)
            except OSError:
                pass
        _CKPT_MODES[ckpt_dir] = mode
    return mode


def _npy_bytes(v) -> bytes:
    """The ``.npy`` file of a tensor or array, as the JAX package writes
    it: ``np.save``'s bytes, and for bf16 the raw bits under ``<V2``."""
    buf = _io.BytesIO()
    if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
        bits = np.ascontiguousarray(
            v.detach().cpu().view(torch.int16).numpy()).view("V2")
        header = np.lib.format.header_data_from_array_1_0(bits)
        header["descr"] = _BF16_DESCR
        np.lib.format.write_array_header_1_0(buf, header)
        buf.write(bits.tobytes())
        return buf.getvalue()
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    np.save(buf, np.asarray(v), allow_pickle=False)
    return buf.getvalue()


def _from_npy(arr: np.ndarray) -> torch.Tensor:
    """An array read from a checkpoint as a tensor; a 2-byte void array
    is bf16 bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


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

    # -- state (params + layer states + optimizer states) ------------------
    def persistent_tensors(self) -> dict:
        """Everything that survives across steps, by name, sorted: the
        model's states, then the optimizer's as ``__opt__<name>``."""
        d = dict(sorted(self.get_states().items()))
        if self._optimizer is not None:
            for k, v in sorted(self._optimizer.state_tensors().items()):
                d[f"__opt__{k}"] = v
        return d

    def save_states(self, fpath, aux_states=None, async_save=False,
                    retry=None):
        """Write a zip of one ``.npy`` a state (module docstring): the
        model's states, the optimizer's as ``__opt__<name>`` and
        ``aux_states`` as ``__aux__<name>``, into a temporary file in the
        target's directory that is then renamed over ``fpath``, with the
        mode a plain ``open`` would give.

        ``async_save=True`` takes device-side copies of every tensor on
        the current stream and returns an :class:`AsyncSaveHandle` at
        once; a background thread waits for the copies, moves them to the
        host and writes the file.  A captured step rewrites weights and
        optimizer state in place, and a replay launched after this call
        is ordered after the copies on the stream, so the file holds the
        state of this call's moment.  ``wait()`` re-raises a failure;
        an unwaited failure is logged and counted in
        ``checkpoint.async_failures``.

        ``retry``: a :class:`~singa_tpu_torch.resilience.retry.RetryPolicy`
        under which transient write errors are retried (site
        ``checkpoint.write``)."""
        def snap(t):
            t = t.detach()
            return t.clone() if async_save else t

        with _trace.span("snapshot/capture", cat="snapshot",
                         path=str(fpath), async_save=bool(async_save)):
            captured = {k: snap(v) for k, v in self.get_states().items()}
            if self._optimizer is not None:
                for k, v in self._optimizer.state_tensors().items():
                    captured[f"__opt__{k}"] = snap(v)
            if aux_states:
                for k, v in aux_states.items():
                    captured[f"__aux__{k}"] = np.asarray(v)
            # the background thread waits for the copies on each device
            ready = []
            if async_save:
                for dev in {v.device for v in captured.values()
                            if isinstance(v, torch.Tensor)
                            and v.device.type == "cuda"}:
                    ready.append(torch.cuda.Event())
                    ready[-1].record(torch.cuda.current_stream(dev))

        def _write():
            with _trace.span("snapshot/write", cat="snapshot",
                             path=str(fpath), tensors=len(captured),
                             async_save=bool(async_save)):
                if retry is None:
                    _write_inner()
                else:
                    from .resilience.retry import retry_call

                    retry_call(_write_inner, "checkpoint.write",
                               policy=retry)

        def _write_inner():
            _faults.check("checkpoint.write")
            for ev in ready:
                ev.synchronize()
            files = {k: _npy_bytes(v) for k, v in captured.items()}
            d = os.path.dirname(os.path.abspath(fpath)) or "."
            fd, tmp = tempfile.mkstemp(
                prefix=os.path.basename(fpath) + ".", suffix=".tmp", dir=d)
            try:
                os.fchmod(fd, _ckpt_mode(d))
                with os.fdopen(fd, "wb") as fh:
                    with zipfile.ZipFile(fh, "w", zipfile.ZIP_STORED) as zf:
                        for k, data in files.items():
                            zf.writestr(k + ".npy", data)
                os.replace(tmp, fpath)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

        if not async_save:
            _write()
            return None
        return AsyncSaveHandle(_write)

    def load_states(self, fpath):
        """Load a zip written by ``save_states`` (of either package): the
        model's states through ``set_states`` (an unknown or missing name
        raises), the optimizer's when this model has one; returns the aux
        states as ``{name: array}``.  An optimizer state must belong to a
        parameter of this model, under a slot this optimizer keeps, or
        ``KeyError`` is raised."""
        _faults.check("checkpoint.read")
        aux, opt_states, states = {}, {}, {}
        with zipfile.ZipFile(fpath, "r") as zf:
            for info in zf.namelist():
                k = info[:-len(".npy")]
                arr = np.load(_io.BytesIO(zf.read(info)), allow_pickle=False)
                if k.startswith("__aux__"):
                    aux[k[len("__aux__"):]] = arr
                elif k.startswith("__opt__"):
                    opt_states[k[len("__opt__"):]] = _from_npy(arr)
                else:
                    states[k] = _from_npy(arr)
        self.set_states(states)
        if self._optimizer is not None and opt_states:
            params = set(self.get_params())
            slots = self._optimizer.state_slots
            bad = sorted(k for k in opt_states if k != "__step_counter__"
                         and (k.rpartition(":")[0] not in params
                              or k.rpartition(":")[2] not in slots))
            if bad:
                raise KeyError(
                    f"load_states: optimizer states {bad[:5]} "
                    f"({len(bad)} in all) name no parameter of this model "
                    f"under a slot of {type(self._optimizer).__name__} "
                    f"{list(slots)}")
            self._optimizer.set_states(opt_states)
        return aux

    def set_states(self, states: dict):
        """Load parameters by the JAX package's names and layouts.

        This is the carry-across function: ``states`` is what
        ``singa_tpu``'s ``Model.get_states()`` returns (as numpy arrays),
        unchanged, so both packages can compute from the same weights.
        Every name must match: an unknown or missing name raises.  The
        tensors are overwritten in place, so captured steps keep reading
        them."""
        super().set_states(states)


class AsyncSaveHandle:
    """The background write of ``Model.save_states(async_save=True)``:
    ``wait(timeout)`` joins it and re-raises its failure, ``done()`` says
    whether it ended.  A failure nobody waits for is logged on the
    ``checkpoint`` channel and counted in ``checkpoint.async_failures``."""

    def __init__(self, fn):
        self._exc = None

        def run():
            try:
                fn()
            except BaseException as e:  # re-raised by wait()
                self._exc = e
                _obs_registry().counter(
                    "checkpoint.async_failures",
                    help="async checkpoint writes that failed in the "
                         "background thread").inc()
                from .utils.logging import get_channel

                get_channel("checkpoint").error(
                    "async checkpoint save failed (call wait() to "
                    "re-raise): %r", e)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self, timeout=None):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("checkpoint write still in progress")
        if self._exc is not None:
            raise self._exc

    def done(self):
        return not self._thread.is_alive()
