"""Multi-axis device mesh and sharding plan (counterpart of
``singa_tpu/parallel/sharding.py``).

A mesh names up to five axes, ``(data, model, seq, pipe, expert)``:
batch rows, Megatron tensor parallelism (``parallel/tensor_parallel.py``),
sequence parallelism by ring attention (``parallel/ring_attention.py``),
GPipe stages (``parallel/pipeline.py``) and experts; a
:class:`ShardingPlan` maps every persistent state tensor and batch input
to a :class:`P` (a partition spec) over it.

The execution model is one process per rank over a ``torch.distributed``
group, as ``parallel/communicator.py`` runs data parallelism.  The JAX
package is single controller: one process holds global arrays and XLA
inserts the collectives (GSPMD).  Here each rank holds only its shard:

* a spec decides which slice of the global (JAX-layout) array a rank
  holds (:func:`shard_array`; :func:`gather_array` puts the slices back
  together), so ``Model.set_states``/``save_states`` move global arrays
  and one zip carries a model between the packages;
* the layers issue their collectives themselves, in
  ``torch.autograd.Function`` pairs over the axis groups the mesh makes;
* every gradient is averaged over the ``data`` x ``seq`` group, the
  ranks that hold the same parameter shard and see other tokens
  (``Mesh.grad_group``).

Rank r sits at ``np.unravel_index(r, (dp, tp, sp, pp, ep))``: the order in
which ``jax.sharding.Mesh`` lays out ``jax.devices()`` in the JAX
package's ``create_mesh``.  A dimension that its axes do not divide
raises ``ValueError`` naming the tensor and the axes, where the JAX
package fails in ``jax.device_put``: nothing is padded.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.distributed as dist

from . import communicator as _comm

__all__ = [
    "DATA", "MODEL", "SEQ", "PIPE", "EXPERT", "TP", "EP", "PP", "AXES",
    "P", "Mesh", "Axis", "create_mesh", "create_tp_mesh", "create_ep_mesh",
    "create_pp_mesh", "ShardingPlan", "shard_array", "gather_array",
    "constrain", "plan_active",
]

DATA = "data"
MODEL = "model"
SEQ = "seq"
PIPE = "pipe"
EXPERT = "expert"
AXES = (DATA, MODEL, SEQ, PIPE, EXPERT)
#: the serve-side axes (tensor, expert, pipeline parallel decode): kept
#: apart from the training axes, as in the JAX package
TP = "tp"
EP = "ep"
PP = "pp"

# True while a planned training step runs (``Model``'s step enters
# ``_PlanActive``)
_plan_active = False


def plan_active() -> bool:
    return _plan_active


class _PlanActive:
    """Context manager the planned training step runs in."""

    def __enter__(self):
        global _plan_active
        self._prev = _plan_active
        _plan_active = True

    def __exit__(self, *exc):
        global _plan_active
        _plan_active = self._prev
        return False


class P(tuple):
    """A partition spec: one entry a dimension, ``None`` (whole), an axis
    name, or a tuple of names (the dimension split over their product,
    the first the major); missing trailing entries are ``None``.  Equal
    to the JAX ``PartitionSpec`` of the same entries as tuples."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def _axes_of(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Axis:
    """One mesh axis as a rank sees it: ``size``, this rank's ``index``
    on it, the global ``ranks`` along it (by index) and their process
    ``group`` (None at size 1)."""

    def __init__(self, name, ranks, index, group):
        self.name = name
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = int(index)
        self.group = group

    def peer(self, offset):
        """The global rank ``offset`` steps along the axis (cyclic)."""
        return self.ranks[(self.index + offset) % self.size]

    def __repr__(self):
        return (f"Axis({self.name!r}, size={self.size}, "
                f"index={self.index})")


def _process_world():
    up = dist.is_available() and dist.is_initialized()
    return (dist.get_world_size(), dist.get_rank()) if up else (1, 0)


class Mesh:
    """Named axes over the ranks of the process group.

    ``shape``: ``{name: size}`` in axis order; ``ranks``: the global ranks
    as an array of that shape (rank r at ``np.unravel_index(r, sizes)``);
    ``rank``/``coords``: this process's place; ``device``: where its
    tensors live (``cuda:<local rank>`` unless the caller asks for the
    CPU).  With ``groups`` (the default when a process group is up) every
    axis longer than 1 gets one process subgroup for each line of ranks
    along it, and the ``data`` x ``seq`` ranks one more
    (:attr:`grad_group`); every rank makes every group, in one order, as
    ``torch.distributed.new_group`` requires.  ``rank`` given without a
    process group builds a mesh for its coordinates only."""

    def __init__(self, sizes, axis_names=AXES, rank=None, device=None,
                 groups=None):
        sizes = tuple(int(n) for n in sizes)
        if len(sizes) != len(axis_names) or min(sizes) < 1:
            raise ValueError(f"mesh sizes {sizes} for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.size = math.prod(sizes)
        self.ranks = np.arange(self.size).reshape(sizes)
        world, me = _process_world()
        self.rank = me if rank is None else int(rank)
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside the mesh of "
                             f"{self.size}")
        self.coords = self.coords_of(self.rank)
        self.device = torch.device(device) if device is not None else \
            self._default_device()
        if groups is None:
            groups = world > 1 and rank is None
        self._groups, self._axes = {}, {}
        if groups:
            if world != self.size:
                raise ValueError(f"a mesh of {self.size} ranks over a "
                                 f"process group of {world}")
            for names in [(n,) for n in self.axis_names] + [(DATA, SEQ)]:
                if all(n in self.shape for n in names):
                    self._make_groups(names)

    @staticmethod
    def _default_device():
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device for the mesh: pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda", _comm._local_rank or 0)

    def coords_of(self, rank) -> dict:
        idx = np.unravel_index(int(rank), self.ranks.shape)
        return {n: int(i) for n, i in zip(self.axis_names, idx)}

    def axis_size(self, name) -> int:
        return self.shape.get(name, 1)

    def axis_index(self, name) -> int:
        return self.coords.get(name, 0)

    def _line(self, names, rank=None):
        """The global ranks that share ``rank``'s coordinates off
        ``names`` (axis names in mesh order), ordered row-major by their
        coordinates on ``names``."""
        c = self.coords_of(self.rank if rank is None else rank)
        idx = tuple(slice(None) if n in names else c[n]
                    for n in self.axis_names)
        return self.ranks[idx].reshape(-1).tolist()

    def _make_groups(self, names):
        n = math.prod(self.shape[a] for a in names)
        if n == 1:
            return
        if n == self.size:
            self._groups[names] = dist.group.WORLD
            return
        seen = set()
        for r in range(self.size):
            line = tuple(self._line(names, r))
            if line in seen:
                continue
            seen.add(line)
            g = dist.new_group(list(line))
            if self.rank in line:
                self._groups[names] = g

    def group(self, *names):
        """The process group of this rank's line along ``names`` (None
        when it holds this rank alone)."""
        return self._groups.get(tuple(names))

    def axis(self, name) -> Axis:
        """This rank's view of axis ``name`` (made once)."""
        ax = self._axes.get(name)
        if ax is None:
            ax = self._axes[name] = Axis(name, self._line((name,)),
                                         self.axis_index(name),
                                         self.group(name))
        return ax

    @property
    def grad_group(self):
        """The ranks whose gradients are averaged: same coordinates off
        ``data`` and ``seq``."""
        return self.group(DATA, SEQ)

    @property
    def grad_world(self) -> int:
        return self.axis_size(DATA) * self.axis_size(SEQ)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def _checked_size(n, what):
    world, _ = _process_world()
    if n > world:
        raise ValueError(
            f"{what} = {n} needs {n} ranks, the process group has {world}: "
            f"start {n} processes and call parallel.communicator."
            f"initialize_distributed in each, or shrink the mesh")


def create_mesh(dp=1, tp=1, sp=1, pp=1, ep=1, device=None) -> Mesh:
    """Mesh over ``(data, model, seq, pipe, expert)``, size-1 axes kept,
    over the whole process group (world size dp·tp·sp·pp·ep; one
    process and no group for a mesh of one)."""
    sizes = (int(dp), int(tp), int(sp), int(pp), int(ep))
    _checked_size(math.prod(sizes), "mesh dp*tp*sp*pp*ep")
    return Mesh(sizes, AXES, device=device)


def create_tp_mesh(tp, device=None) -> Mesh:
    """1-D serve-side tensor-parallel mesh (axis :data:`TP`)."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    _checked_size(int(tp), "tp")
    return Mesh((int(tp),), (TP,), device=device)


def create_ep_mesh(ep, tp=1, device=None) -> Mesh:
    """2-D serve-side ``(ep, tp)`` mesh: experts over :data:`EP`, the
    dense layers' Megatron layout over :data:`TP`."""
    if ep < 1 or tp < 1:
        raise ValueError(f"ep and tp must be >= 1, got ep={ep} tp={tp}")
    _checked_size(int(ep) * int(tp), f"ep x tp = {ep} x {tp}")
    return Mesh((int(ep), int(tp)), (EP, TP), device=device)


def create_pp_mesh(stages, device=None) -> Mesh:
    """1-D serve-side pipeline mesh (axis :data:`PP`)."""
    if stages < 1:
        raise ValueError(f"stages must be >= 1, got {stages}")
    _checked_size(int(stages), "stages")
    return Mesh((int(stages),), (PP,), device=device)


# ----------------------------------------------------- slices by spec


def _spec_slices(shape, mesh, spec, rank, name):
    """Per dimension, the ``slice`` of the global ``shape`` that ``rank``
    holds under ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    if len(spec) > len(shape):
        raise ValueError(f"{name}: spec {P(*spec)} has more entries than "
                         f"its {len(shape)} dimensions")
    coords = mesh.coords_of(rank)
    out = []
    for dim, (size, entry) in enumerate(zip(shape, spec)):
        axes = _axes_of(entry)
        n = math.prod(mesh.axis_size(a) for a in axes)
        if size % n:
            raise ValueError(
                f"{name}: dimension {dim} of size {size} is not divisible "
                f"by mesh axis {' x '.join(axes)} of size {n}")
        idx = 0
        for a in axes:
            idx = idx * mesh.axis_size(a) + coords.get(a, 0)
        step = size // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard_array(x, mesh, spec, name="array", rank=None):
    """The slice of global ``x`` that ``rank`` (default: this one) holds
    under ``spec``, as a new contiguous tensor (``x`` may be a numpy
    array)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    sl = _spec_slices(x.shape, mesh, spec,
                      mesh.rank if rank is None else rank, name)
    return x[sl].clone(memory_format=torch.contiguous_format)


def global_shape(shape, mesh, spec):
    """The global shape whose ``spec`` slices have ``shape``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(int(s) * math.prod(mesh.axis_size(a) for a in _axes_of(e))
                 for s, e in zip(shape, spec))


def gather_array(x, mesh, spec):
    """The global array of which ``x`` is this rank's ``spec`` slice: a
    collective over the whole mesh (every rank calls it, in one order);
    ``x`` itself when ``spec`` shards nothing."""
    if not any(_axes_of(e) and math.prod(mesh.axis_size(a)
                                         for a in _axes_of(e)) > 1
               for e in spec):
        return x
    parts = _comm.group_all_gather(x.detach()[None], None, dim=0,
                                   op="gather_states")
    out = x.new_empty(global_shape(x.shape, mesh, spec))
    for r in range(mesh.size):
        out[_spec_slices(out.shape, mesh, spec, r, "array")] = parts[r]
    return out


# ---------------------------------------------------------- the plan


class ShardingPlan:
    """Maps persistent state and batch inputs to specs over a mesh.

    A state's spec is (first match): the tensor's own ``partition_spec``
    (set by the parallel layers), the first of ``rules`` (``(regex,
    P)`` pairs on the state name) that matches, replicated ``P()``.  An
    optimizer slot (``__opt__{param}:{slot}``) takes its parameter's.

    Batch inputs are split over ``data`` on dim 0 and, when the mesh has
    a ``seq`` axis that divides it, ``seq`` on dim 1, unless
    ``input_specs`` gives each input's spec by position."""

    def __init__(self, mesh: Mesh, rules=(), input_specs=None,
                 shard_seq_inputs=True):
        self.mesh = mesh
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]
        self.input_specs = input_specs
        self.shard_seq_inputs = bool(shard_seq_inputs)

    # -- mesh facts --------------------------------------------------------
    def axis_size(self, name) -> int:
        return self.mesh.axis_size(name)

    @property
    def world(self) -> int:
        return self.mesh.size

    # -- state -------------------------------------------------------------
    def spec_for_state(self, name, t, param_specs=None) -> P:
        spec = getattr(t, "partition_spec", None)
        if spec is not None:
            return spec
        base = name
        if name.startswith("__opt__"):
            base = name[len("__opt__"):].rsplit(":", 1)[0]
            if param_specs and base in param_specs:
                return param_specs[base]
        for pat, s in self.rules:
            if pat.search(base):
                return s
        return P()

    # -- inputs ------------------------------------------------------------
    def spec_for_input(self, arr, index) -> P:
        if self.input_specs is not None:
            return self.input_specs[index]
        if arr.ndim == 0:
            return P()
        dims = [None] * arr.ndim
        if arr.shape[0] % self.axis_size(DATA) == 0:
            dims[0] = DATA
        if (self.shard_seq_inputs and arr.ndim >= 2
                and self.axis_size(SEQ) > 1
                and arr.shape[1] % self.axis_size(SEQ) == 0):
            dims[1] = SEQ
        return P(*dims)

    # -- activation spec helper (used by the parallel layers) --------------
    def act_spec(self, ndim, model_last=False, seq_dim=1) -> P:
        """(B, ..., E) activation: data on dim 0, seq on ``seq_dim`` when
        the mesh shards sequences, model on the last dim for a
        column-parallel output."""
        dims = [None] * ndim
        dims[0] = DATA
        if ndim >= 3 and self.axis_size(SEQ) > 1 and seq_dim < ndim - 1:
            dims[seq_dim] = SEQ
        if model_last:
            dims[-1] = MODEL
        return P(*dims)

    # -- this rank's slices ------------------------------------------------
    def shard(self, x, spec, name="array"):
        """This rank's slice of global ``x`` under ``spec``."""
        return shard_array(x, self.mesh, spec, name)

    def gather(self, x, spec):
        """The global array of this rank's slice ``x`` (a collective)."""
        return gather_array(x, self.mesh, spec)

    def seq_offset(self, s_local) -> int:
        """The global position of this rank's first sequence column."""
        return self.mesh.axis_index(SEQ) * int(s_local)


def constrain(x, plan: ShardingPlan, spec):
    """The JAX package's layout pin: a rank already holds its slice of
    every activation here, so it returns ``x``."""
    return x
