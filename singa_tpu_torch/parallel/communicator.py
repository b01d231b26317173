"""The communicator (counterpart of ``singa_tpu/parallel/communicator.py``)
over ``torch.distributed``: the reference's NCCL ``Communicator`` with
``synch`` (all-reduce), ``fused_synch`` (one flat buffer), ``synch_half``
(a 16-bit wire format) and top-K or threshold sparsification with
residuals.

One process per rank, as the reference runs.  The JAX package is single
controller: one process holds the global batch and a ``shard_map`` splits
the captured step over a mesh, so outside that step every collective is
the world-1 identity.  Here :func:`initialize_distributed` joins this
process to a ``torch.distributed`` process group (NCCL unless the caller
names ``"gloo"``), each rank feeds its own shard, and every call below is
a real collective, eager or inside a captured CUDA graph alike.  NCCL
needs its communicator made by a collective before any capture: the
graph runner's first call of a step is eager, and its collectives do
that.

Observability: each call issues its collectives and counts them once,
at issue (``comms.collectives{op=}``, ``comms.bytes{op=}`` the bytes this
rank puts on the wire: bf16 halves them, top-K sends K (int32 index,
value) pairs a tensor; and a ``comms/<op>`` trace event).  A captured
step issues them while it is captured; its replays are not counted
again, as the JAX package counts once per compile.  The ``comm.collective`` fault site is checked at
issue too, its transient faults retried under ``_COMM_RETRY``; a real
collective error is never retried or swallowed.
"""

from __future__ import annotations

import datetime
import math
import socket
import time

import torch
import torch.distributed as dist

from ..observe import trace as _otrace
from ..observe.registry import registry as _obs_registry
from ..resilience import faults as _faults
from ..resilience.retry import RetryPolicy, retry_call

__all__ = ["Communicator", "initialize_distributed", "process_info"]

#: rank within its host, set by ``initialize_distributed``
_local_rank = None

#: host-side retry policy for injected ``comm.collective`` faults (a
#: collective stall is milliseconds, not the checkpoint layer's seconds)
_COMM_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.01,
                          max_delay_s=0.1)


def process_info() -> dict:
    """This process's place in the run: ``process_index`` (its rank),
    ``process_count`` (the world size) and ``local_device_count`` (the
    CUDA devices it sees, 0 on a CPU-only host); ``{0, 1}`` before
    :func:`initialize_distributed`.  ``observe.monitor`` labels crash
    bundles with the same rank."""
    up = dist.is_available() and dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_device_count": torch.cuda.device_count(),
    }


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _record_collective(op, tensors, world=None):
    """Count one collective issue (``comms.collectives`` /
    ``comms.bytes`` by ``op``), emit its trace event, and fire the
    ``comm.collective`` fault site when faults are armed."""
    if _faults._armed:
        retry_call(lambda: _faults.check("comm.collective"),
                   "comm.collective", policy=_COMM_RETRY)
    n = _nbytes(tensors)
    reg = _obs_registry()
    reg.counter("comms.collectives", help="collective ops issued",
                op=op).inc()
    reg.counter("comms.bytes", help="collective payload bytes issued",
                op=op).inc(n)
    _otrace.event(f"comms/{op}", cat="comms", bytes=n,
                  arrays=len(tensors), world=world,
                  captured=torch.cuda.is_available()
                  and torch.cuda.is_current_stream_capturing())


def _wait_for_coordinator(address, timeout):
    """Bounded TCP probe of the rank-0 coordinator, so that a rank whose
    coordinator never came up gets a ``ConnectionError`` after
    ``timeout`` seconds instead of a rendezvous that hangs."""
    host, _, port = str(address).rpartition(":")
    host = host.strip("[]")  # bracketed IPv6 form "[::1]:1234"
    if not host or not port.isdigit():
        return  # unparseable address: init_process_group reports it
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with socket.create_connection((host, int(port)), timeout=2):
                return
        except OSError:
            time.sleep(0.5)
    raise ConnectionError(
        f"coordinator {address} unreachable after {timeout:.0f}s: check "
        f"that the process_id=0 task is up and the address/port are "
        f"correct")


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend="nccl",
                           init_method=None, initialization_timeout=300):
    """Join this process to the process group (the reference's MPI init
    and NCCL-id broadcast).

    ``coordinator_address`` is rank 0's ``host:port`` (a TCP store), or
    ``init_method`` any ``torch.distributed`` URL (``file://...``, which
    the CPU tests use); ``num_processes`` is the world size and
    ``process_id`` this rank.  ``backend`` is ``"nccl"`` unless the caller
    names ``"gloo"``; NCCL binds this process to the CUDA device of its
    rank modulo the visible devices.
    ``initialization_timeout`` (seconds) bounds the probe of the
    coordinator on the other ranks and every collective's wait."""
    global _local_rank
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if num_processes is None or process_id is None:
        raise ValueError("initialize_distributed needs num_processes and "
                         "process_id")
    if (coordinator_address is None) == (init_method is None):
        raise ValueError("give exactly one of coordinator_address and "
                         "init_method")
    if coordinator_address is not None:
        if int(process_id) != 0:
            _wait_for_coordinator(coordinator_address,
                                  initialization_timeout)
        init_method = f"tcp://{coordinator_address}"
    kw = {}
    if backend == "nccl":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("backend 'nccl' needs a CUDA device; ask for "
                               "backend='gloo' to run on the CPU")
        _local_rank = int(process_id) % n
        torch.cuda.set_device(_local_rank)
        kw["device_id"] = torch.device("cuda", _local_rank)
    else:
        _local_rank = int(process_id)
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=initialization_timeout), **kw)


def _all_gather(out, t, group):
    """``out`` (W·n,) ← every rank's ``t`` (n,), in rank order."""
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, t, group=group)


# -- collectives over a mesh axis's group (parallel/sharding.py) ----------


def group_all_reduce(t, group, op="axis_all_reduce"):
    """The sum of ``t`` over ``group``'s ranks, in place (``t`` itself is
    returned); counted as ``op``."""
    _record_collective(op, [t], world=dist.get_world_size(group))
    dist.all_reduce(t, group=group)
    return t


def group_all_gather(t, group, dim=0, op="axis_all_gather"):
    """Every rank's ``t`` concatenated along ``dim`` in the group's rank
    order (a new tensor on ``t``'s device; a gloo group, which cannot
    gather CUDA tensors, gathers host copies)."""
    n = dist.get_world_size(group)
    _record_collective(op, [t], world=n)
    flat = t.detach().contiguous().reshape(-1)
    if flat.is_cuda and dist.get_backend(group) == "gloo":
        flat = flat.cpu()
    out = flat.new_empty((n * flat.numel(),))
    _all_gather(out, flat, group)
    parts = out.reshape(n, *t.shape).unbind(0)
    return torch.cat(parts, dim=dim).to(t.device)


def group_broadcast(t, src, group, op="axis_broadcast"):
    """``t`` of global rank ``src`` on every rank of ``group``, in place."""
    _record_collective(op, [t], world=dist.get_world_size(group))
    dist.broadcast(t, src=src, group=group)
    return t


def exchange(sends, recvs, group=None, op="p2p"):
    """Point-to-point transfers paired in one batch on every rank:
    ``sends`` are ``(tensor, dst, tag)`` and ``recvs`` ``(buffer, src,
    tag)``, ``dst``/``src`` global ranks; the buffers are filled in place.
    Every rank must issue its side of each pair in the same order (the
    ring and pipeline hops do).  A transfer to this rank itself is a copy.
    Device tensors go to the wire as they are, except on a gloo group,
    which cannot send or receive CUDA tensors: those travel through host
    copies.  Counted as ``op``, with the bytes sent to other ranks."""
    me = dist.get_rank()
    own = {tag: t for t, dst, tag in sends if dst == me}
    sends = [(t, d, g) for t, d, g in sends if d != me]
    for buf, src, tag in recvs:
        if src == me:
            buf.copy_(own[tag])
    recvs = [(b, s, g) for b, s, g in recvs if s != me]
    if not sends and not recvs:
        return
    _record_collective(op, [t for t, _, _ in sends],
                       world=dist.get_world_size(group))
    staged = dist.get_backend(group) == "gloo"
    wire_sends = [(t.cpu() if staged and t.is_cuda else t.contiguous(), d, g)
                  for t, d, g in sends]
    wire_recvs = [(torch.empty(b.shape, dtype=b.dtype)
                   if staged and b.is_cuda else b, s, g)
                  for b, s, g in recvs]
    ops = [dist.P2POp(dist.isend, t, d, group, g) for t, d, g in wire_sends]
    ops += [dist.P2POp(dist.irecv, b, s, group, g)
            for b, s, g in wire_recvs]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    for (buf, _, _), (wire, _, _) in zip(recvs, wire_recvs):
        if wire is not buf:
            buf.copy_(wire)


class Communicator:
    """The reference's communicator over a process group (default: the
    whole world).  Every method is a real collective over the group's
    ``world_size`` ranks; ``num_devices``, when given, must equal it."""

    def __init__(self, group=None, num_devices=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "no process group: call parallel.communicator."
                "initialize_distributed(...) in every rank first (world "
                "size 1 for one process)")
        self.group = group
        self.world_size = dist.get_world_size(group)
        if num_devices is not None and int(num_devices) != self.world_size:
            raise ValueError(f"num_devices={num_devices} but the process "
                             f"group has {self.world_size} ranks")
        self.global_rank = dist.get_rank()
        self.rank = dist.get_rank(group)  # within the group
        self.local_rank = self.global_rank if _local_rank is None \
            else _local_rank
        self.num_processes = dist.get_world_size()
        self.backend = dist.get_backend(group)

    def _record(self, op, tensors):
        _record_collective(op, tensors, world=self.world_size)

    def _reduce_(self, t):
        dist.all_reduce(t, group=self.group)
        return t

    # -- dense all-reduce (reference: Communicator::synch) ----------------
    def all_reduce(self, arr, average=False):
        """The sum (or mean) of ``arr`` over the ranks, as a new tensor."""
        self._record("all_reduce", [arr])
        out = self._reduce_(arr.detach().clone())
        return out.div_(self.world_size) if average else out

    def synch(self, arr):
        return self.all_reduce(arr, average=False)

    def all_gather(self, arr):
        """Every rank's ``arr`` stacked in rank order, (W, *arr.shape)."""
        self._record("all_gather", [arr])
        out = arr.new_empty((self.world_size * arr.numel(),))
        _all_gather(out, arr.detach().reshape(-1).contiguous(), self.group)
        return out.reshape(self.world_size, *arr.shape)

    # -- one flat buffer (reference: fusedSynch) --------------------------
    def fused_synch(self, arrs, average=False):
        """Many tensors in one all-reduce of their concatenation, split
        back to their shapes."""
        if not arrs:
            return []
        self._record("fused_synch", arrs)
        flat = self._reduce_(torch.cat([a.reshape(-1) for a in arrs]))
        if average:
            flat.div_(self.world_size)
        return _split_like(flat, arrs)

    # -- 16-bit wire (reference: synchHalf; bf16 as in the JAX package) --
    def synch_half(self, arr, average=False):
        """``all_reduce`` with bf16 on the wire: the sum is taken in bf16
        and cast back to ``arr``'s dtype."""
        half = arr.to(torch.bfloat16, copy=True)  # never arr itself
        self._record("synch_half", [half])
        red = self._reduce_(half).to(arr.dtype)
        return red.div_(self.world_size) if average else red

    def fused_synch_half(self, arrs, average=False):
        if not arrs:
            return []
        flat = torch.cat([a.reshape(-1) for a in arrs]).to(torch.bfloat16)
        self._record("fused_synch_half", [flat])
        red = self._reduce_(flat).to(arrs[0].dtype)
        if average:
            red.div_(self.world_size)
        return _split_like(red, arrs)

    # -- sparse sync with residuals (reference: sparsification) -----------
    def sparse_all_reduce(self, arr, residual, spars=0.05, topK=True,
                          average=False):
        """``(synced, new_residual)``, both shaped like ``arr``.  The rank
        adds ``arr`` to its ``residual``; ``topK``: the ``ceil(spars·n)``
        entries of largest magnitude travel as (int32 index, value) pairs
        gathered from every rank (2·K·W elements on the wire) and are
        summed into place, else (threshold) the entries above ``spars``
        in magnitude are summed by a dense all-reduce.  What was not sent
        is the new residual."""
        flat = (residual + arr).reshape(-1)
        if topK:
            k = max(1, int(math.ceil(float(spars) * flat.numel())))
            idx = torch.topk(flat.abs(), k).indices
            vals = flat[idx]
            contrib = torch.zeros_like(flat).index_copy_(0, idx, vals)
            wire_idx = idx.to(torch.int32)
            self._record("sparse_topk", [wire_idx, vals])
            all_idx = wire_idx.new_empty(k * self.world_size)
            all_vals = vals.new_empty(k * self.world_size)
            _all_gather(all_idx, wire_idx, self.group)
            _all_gather(all_vals, vals, self.group)
            # one scatter-add a rank, in rank order: an index appears once
            # in each, so no two adds race and every rank sums to the same
            # bits (one add of all W·K pairs on the card sums an index
            # several ranks chose in the order its atomics land)
            summed = torch.zeros_like(flat)
            for r in range(self.world_size):
                summed.index_add_(0, all_idx[r * k:(r + 1) * k],
                                  all_vals[r * k:(r + 1) * k])
        else:
            contrib = torch.where(flat.abs() > float(spars), flat,
                                  torch.zeros_like(flat))
            self._record("sparse_threshold", [contrib])
            summed = self._reduce_(contrib.clone())
        if average:
            summed.div_(self.world_size)
        return summed.reshape(arr.shape), (flat - contrib).reshape(arr.shape)

    # -- ordering (reference: event-sync of comm stream vs compute) -------
    def wait(self):
        """Nothing to wait for: every collective here is issued
        synchronously, so work queued after it on the current stream is
        ordered after it."""


def _split_like(flat, arrs):
    out, off = [], 0
    for a in arrs:
        n = a.numel()
        out.append(flat[off:off + n].reshape(a.shape))
        off += n
    return out
