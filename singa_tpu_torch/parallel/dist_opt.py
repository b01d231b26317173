"""``DistOpt``, the data-parallel optimizer wrapper (counterpart of
``singa_tpu/parallel/dist_opt.py``), with the reference's five sync
modes over :class:`~singa_tpu_torch.parallel.communicator.Communicator`:

  backward_and_update          dense all-reduce of the mean gradient;
                               gradients under ``threshold`` elements
                               ride one flat buffer (fusedSynch)
  backward_and_update_half     the same with bf16 on the wire
  backward_and_partial_update  round-robin: parameter i syncs on the steps
                               where step ≡ i (mod W); off-turn gradients
                               accumulate in the rank's accumulator and
                               are folded in at its next sync (1/W of the
                               dense wire bytes)
  backward_and_sparse_update   topK=True: the top-K entries of
                               residual + gradient travel as (index,
                               value) pairs; topK=False: the entries over
                               a threshold, by a dense all-reduce; what
                               is not sent stays in the residual

One process per rank (``parallel/communicator.py``): each rank keeps its
own accumulators, shaped like their parameters.  ``get_states`` /
``save_states`` write them in the JAX package's layout, one
``__residual__<name>`` of shape (W, *shape) gathered from every rank
(a collective: every rank saves), and ``set_states`` / ``load_states``
give each rank its row, so a zip moves between the packages both ways.

Partial update in a captured step: the round-robin phase (the step
modulo W) is a host integer, :attr:`DistOpt.host_step`, kept beside the
device step counter and re-read from ``__step_counter__`` by
``set_states``.  The graph runner keys steps by
:meth:`DistOpt.graph_key`, which holds the phase once a partial step has
run, so the mode captures W graphs and each issues only the all-reduces
of its own parameters.  A replay runs no Python, so the runner, not the
step, advances the host step of a graph-mode step (``model.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from ..observe import trace as _trace
from .communicator import Communicator

__all__ = ["DistOpt"]

_RES = "__residual__"


class DistOpt:
    """Wraps ``opt`` (any ``singa_tpu_torch.opt.Optimizer``); calling it
    on a loss is ``backward_and_update``.  ``communicator`` (default: one
    over ``group``, the whole world by default) does the collectives;
    ``num_devices``, when given, must equal the world size."""

    is_distributed = True

    def __init__(self, opt, communicator=None, group=None, num_devices=None,
                 **unused_reference_args):
        self.opt = opt
        self.communicator = communicator if communicator is not None else \
            Communicator(group=group, num_devices=num_devices)
        self.world_size = self.communicator.world_size
        self.global_rank = self.communicator.global_rank
        self.local_rank = self.communicator.local_rank
        self._residuals = {}  # param name -> this rank's accumulator
        self._host_step = 0   # the step counter's value, on the host
        self._partial = False  # a partial step has run: key by phase

    # -- delegation, so DistOpt quacks like the wrapped optimizer ---------
    @property
    def step_counter(self):
        return self.opt.step_counter

    @property
    def clip_norm(self):
        return self.opt.clip_norm

    @property
    def state_slots(self):
        return self.opt.state_slots

    def _param_name(self, p):
        return self.opt._param_name(p)

    def apply(self, name, p, g, hp=None):
        self.opt.apply(name, p, g, hp)

    def step(self):
        self.opt.step()
        self._host_step += 1

    @property
    def host_step(self) -> int:
        """The steps taken, on the host: the partial mode's phase is this
        modulo the world size.  ``step()`` adds one where Python runs the
        step; the graph runner sets it after each of its steps, as a
        replay runs no Python and a capture runs it without a step."""
        return self._host_step

    @host_step.setter
    def host_step(self, n):
        self._host_step = int(n)

    def attach_model(self, model):
        self.model = model

    def graph_key(self):
        """What a captured step bakes in beyond its inputs: the world
        size, and the round-robin phase once a partial step has run at a
        world size above 1."""
        phased = self._partial and self.world_size > 1
        return (self.world_size,
                self._host_step % self.world_size if phased else None)

    def update(self, param, grad):
        """One parameter's update from the mean of ``grad`` over the ranks
        (reference ``DistOpt.update``); no clipping, as a global norm does
        not exist one parameter at a time."""
        g = self.communicator.all_reduce(grad, average=True)
        with torch.no_grad():
            self.opt._counter(param.device)
            self.opt.apply(self._param_name(param), param, g)

    # -- state --------------------------------------------------------------
    def residuals(self) -> dict:
        """This rank's accumulators by parameter name."""
        return dict(self._residuals)

    def state_tensors(self) -> dict:
        """The wrapped optimizer's state and, under ``__residual__<name>``,
        every rank's accumulator stacked (W, *shape), gathered here (so
        every rank must call it)."""
        d = dict(self.opt.state_tensors())
        for k, r in self._residuals.items():
            d[_RES + k] = self.communicator.all_gather(r)
        return d

    def get_states(self) -> dict:
        out = self.opt.get_states()
        for k, r in self._residuals.items():
            out[_RES + k] = self.communicator.all_gather(r).cpu().numpy()
        return out

    def set_states(self, states):
        """Load states by name; a ``__residual__<name>`` array (W, *shape)
        gives this rank row ``global_rank``, and ``__step_counter__``
        also sets the host step (the partial mode's phase)."""
        rest = {}
        for k, v in states.items():
            if not k.startswith(_RES):
                rest[k] = v
                continue
            src = v if isinstance(v, torch.Tensor) else \
                torch.from_numpy(np.array(v))
            if src.dim() == 0 or src.shape[0] != self.world_size:
                raise ValueError(
                    f"{k}: a residual has shape (world, *param_shape) with "
                    f"world = {self.world_size}, got {tuple(src.shape)}")
            row = src[self.global_rank]
            name = k[len(_RES):]
            if name in self._residuals:
                self._residuals[name].copy_(row)
            else:
                self._residuals[name] = row.clone()
        self.opt.set_states(rest)
        if "__step_counter__" in states:
            self._host_step = int(round(float(states["__step_counter__"])))

    def sync_layer_states(self, model):
        """Average the model's states that are not parameters (batch
        norm's running statistics) over the ranks, in place, in one
        all-reduce: each rank computed them on its own shard (the JAX
        package's ``pmean``).  Under a sharding plan these are the rank's
        own slices."""
        params = set(model.get_params())
        ts = [t for k, t in sorted(model._local_states().items())
              if k not in params and t.is_floating_point()]
        with torch.no_grad():
            for t, v in zip(ts, self.communicator.fused_synch(
                    ts, average=True)):
                t.copy_(v)

    def seed_rank_generator(self, generator):
        """Give each rank its own random stream, from the generator's seed
        and the rank in the communicator's group (dropout masks differ
        across ranks); at world size 1 the generator is left as it is."""
        if self.world_size > 1:
            generator.manual_seed(
                (generator.initial_seed() * 1000003
                 + self.communicator.rank) % 2 ** 63)

    # -- the reference's entry points ----------------------------------------
    def __call__(self, loss):
        self.backward_and_update(loss)

    def _pairs(self, loss):
        pairs = list(autograd.backward(loss))
        if pairs:
            self.opt._counter(pairs[0][0].device)
        return pairs

    def backward_and_update(self, loss, threshold=2 ** 21):
        """Dense sync of the mean gradient; gradients smaller than
        ``threshold`` elements share one all-reduce.  With the wrapped
        optimizer's ``clip_norm`` the synced gradients are clipped by
        their global norm before any update."""
        self._dense_sync(loss, threshold, False, "dense")

    def backward_and_update_half(self, loss, threshold=2 ** 21):
        """``backward_and_update`` with bf16 on the wire; clipping, in
        float32, acts on what was synced."""
        self._dense_sync(loss, threshold, True, "half")

    def sync_dense(self, pairs, threshold=2 ** 21, half=False):
        """The mean over the ranks of each ``(param, grad)``'s gradient:
        one all-reduce for a gradient of ``threshold`` elements or more,
        one flat buffer for the rest (fusedSynch); bf16 on the wire with
        ``half``.  Returns ``(param, synced grad)`` pairs."""
        c = self.communicator
        one, fused = (c.synch_half, c.fused_synch_half) if half else \
            (c.all_reduce, c.fused_synch)
        bucket = [(p, g) for p, g in pairs if g.numel() < threshold]
        synced = [(p, one(g, average=True))
                  for p, g in pairs if g.numel() >= threshold]
        if bucket:
            synced += list(zip([p for p, _ in bucket],
                               fused([g for _, g in bucket], average=True)))
        return synced

    def _dense_sync(self, loss, threshold, half, mode):
        with _trace.span("opt/update", cat="train", mode=mode):
            pairs = self._pairs(loss)
            with torch.no_grad():
                self._apply_all(self.sync_dense(pairs, threshold, half))
                self.step()
        self.opt._m_updates.inc()

    def _apply_all(self, pairs):
        """Apply every ``(param, synced grad)``, first scaled by their
        global norm when the wrapped optimizer has ``clip_norm``
        (``Optimizer._clip_pairs``: the synced gradient is the full
        batch's, and every rank computes the same scale)."""
        if self.opt.clip_norm is not None:
            pairs = self.opt._clip_pairs(pairs)
        hp = self.opt.hyper()
        for p, g in pairs:
            self.opt.apply(self._param_name(p), p, g, hp)

    def backward_and_partial_update(self, loss):
        """Round-robin sync: the i-th gradient of the backward pass syncs
        when step ≡ i (mod W), its accumulator added and then cleared;
        the others update with a zero gradient and accumulate."""
        self._refuse_clip("backward_and_partial_update")
        self._partial = True
        w = self.world_size
        phase = self._host_step % w
        with _trace.span("opt/update", cat="train", mode="partial",
                         phase=phase):
            pairs = self._pairs(loss)
            with torch.no_grad():
                hp = self.opt.hyper()
                for i, (p, g) in enumerate(pairs):
                    name = self._param_name(p)
                    r = self._residual_for(name, p)
                    acc = r + g
                    if i % w == phase:
                        delta = self.communicator.all_reduce(acc,
                                                             average=True)
                        r.zero_()
                    else:
                        delta = torch.zeros_like(acc)
                        r.copy_(acc)
                    self.opt.apply(name, p, delta, hp)
                self.step()
        self.opt._m_updates.inc()

    def backward_and_sparse_update(self, loss, spars=0.05, topK=True):
        """Sparse sync with residuals (``Communicator.sparse_all_reduce``):
        the top ``spars`` share of each residual + gradient by magnitude
        (``topK``), or its entries above ``spars`` in magnitude."""
        self._refuse_clip("backward_and_sparse_update")
        with _trace.span("opt/update", cat="train",
                         mode="sparse_topk" if topK else "sparse_threshold"):
            pairs = self._pairs(loss)
            with torch.no_grad():
                hp = self.opt.hyper()
                for p, g in pairs:
                    name = self._param_name(p)
                    r = self._residual_for(name, p)
                    synced, new_res = self.communicator.sparse_all_reduce(
                        g, r, spars=spars, topK=topK, average=True)
                    r.copy_(new_res)
                    self.opt.apply(name, p, synced, hp)
                self.step()
        self.opt._m_updates.inc()

    def _refuse_clip(self, mode):
        """Partial and sparse sync update from part of the gradient, so no
        global norm exists whose clip would mean the single-device
        ``clip_norm``: refused."""
        if self.opt.clip_norm is not None:
            raise ValueError(
                f"clip_norm is not supported under DistOpt.{mode} "
                f"(the synced update is a partial gradient; a global "
                f"norm over it is not the single-device clip). Use "
                f"the dense or fp16 sync modes, which clip the synced "
                f"global-norm exactly.")

    def _residual_for(self, name, p) -> torch.Tensor:
        """This rank's accumulator for parameter ``name``: zeros like the
        parameter at first, moved to its device by the first step (an
        eager one) when loaded elsewhere."""
        r = self._residuals.get(name)
        if r is None:
            r = self._residuals[name] = torch.zeros_like(p)
        elif r.device != p.device or r.dtype != p.dtype:
            r = self._residuals[name] = r.to(p.device, p.dtype)
        return r
