"""One rank of the port's data-parallel runs that ``test_torch_dist.py``
holds against the JAX package.

    python tests/torch_dist_worker.py SPEC.json RANK

``SPEC.json``: ``world``, ``init`` (a ``file://`` URL, so that parallel
test workers never share a port), ``out`` (a directory) and
``scenarios``.  The rank joins a gloo process group on the CPU, then for
each scenario builds the port's model, wraps SGD in ``DistOpt``, loads
the JAX package's zip (taken after its warm step), trains 3 graph-mode
steps on its shard of each global batch (rows ``rank·n/W`` to
``(rank+1)·n/W``, as the JAX mesh shards them) and writes its parameters,
optimizer state, residual slice and losses to ``<name>_r<rank>.npz``
and its ``save_states`` zip to ``<name>_r<rank>.zip``.  ``comm`` runs the
communicator's operations on the rank's arrays.  It imports nothing of
JAX.
"""

import json
import os
import sys
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from singa_tpu_torch import device, layer, model, opt  # noqa: E402
from singa_tpu_torch.models.common import apply_dist_option  # noqa: E402
from singa_tpu_torch.models.mlp import MLP  # noqa: E402
from singa_tpu_torch.parallel import communicator as comm_mod  # noqa: E402
from singa_tpu_torch.parallel.dist_opt import DistOpt  # noqa: E402

STEPS = 3


class DistMLP(MLP):
    """``tests/test_dist.py``'s ``_DistMLP``: 8 -> 16 -> 4."""

    def __init__(self, dist_option="plain", spars=None):
        super().__init__(data_size=8, perceptron_size=16, num_classes=4)
        self._dist_option = dist_option
        self._spars = spars

    def train_one_batch(self, x, y):
        return super().train_one_batch(x, y, dist_option=self._dist_option,
                                       spars=self._spars)


class BNNet(model.Model):
    """``tests/test_dist.py``'s batch-norm net: conv, BN, linear."""

    def __init__(self, dist_option="plain", spars=None):
        super().__init__()
        self.conv = layer.Conv2d(4, 3, padding=1)
        self.bn = layer.BatchNorm2d()
        self.flat = layer.Flatten()
        self.fc = layer.Linear(10)
        self.ce = layer.SoftMaxCrossEntropy()
        self._dist_option = dist_option
        self._spars = spars

    def forward(self, x):
        return self.fc(self.flat(self.bn(self.conv(x))))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = self.ce(out, y)
        apply_dist_option(self.optimizer, loss, self._dist_option,
                          self._spars)
        return out, loss


MODELS = {"mlp": DistMLP, "bn": BNNet}


def _shard(a, rank, world):
    n = a.shape[1] // world
    return torch.from_numpy(np.ascontiguousarray(a[:, rank * n:(rank + 1)
                                                   * n]))


def run_scenario(sc, rank, world, out):
    cpu = device.create_cpu_device()
    cpu.SetRandSeed(0)
    m = MODELS[sc["model"]](sc["mode"], sc.get("spars"))
    dopt = DistOpt(opt.SGD(**sc["sgd"]), num_devices=world)
    m.set_optimizer(dopt)
    data = np.load(sc["data"])
    xs, ys = _shard(data["xs"], rank, world), _shard(data["ys"], rank, world)
    m.compile([xs[0]], is_train=True, use_graph=True)
    m.load_states(sc["zip"])
    if sc.get("multi"):
        _, losses = m.train_n_batches(xs[1:STEPS + 1], ys[1:STEPS + 1])
        losses = losses.numpy()
    else:
        losses = np.asarray([m(xs[i], ys[i])[1].item()
                             for i in range(1, STEPS + 1)])
    res = {f"state/{k}": v.detach().numpy()
           for k, v in m.get_states().items()}
    res.update({f"opt/{k}": v for k, v in dopt.opt.get_states().items()})
    res.update({f"residual/{k}": v.numpy()
                for k, v in dopt.residuals().items()})
    res["losses"] = losses
    m.save_states(os.path.join(out, f"{sc['name']}_r{rank}.zip"))
    np.savez(os.path.join(out, f"{sc['name']}_r{rank}.npz"), **res)


def run_comm(sc, rank, world, out):
    """The communicator's operations on this rank's arrays."""
    c = comm_mod.Communicator()
    d = np.load(sc["data"])
    a, b = torch.from_numpy(d["a"][rank]), torch.from_numpy(d["b"][rank])
    r = torch.from_numpy(d["r"][rank])
    res = {"all_reduce": c.all_reduce(a).numpy(),
           "all_reduce_mean": c.all_reduce(a, average=True).numpy(),
           "synch_half": c.synch_half(a, average=True).numpy()}
    for k, v in enumerate(c.fused_synch([a, b], average=True)):
        res[f"fused_synch{k}"] = v.numpy()
    for k, v in enumerate(c.fused_synch_half([a, b], average=True)):
        res[f"fused_synch_half{k}"] = v.numpy()
    for name, top in (("topk", True), ("threshold", False)):
        s, nr = c.sparse_all_reduce(a, r, spars=sc["spars"][name],
                                    topK=top, average=True)
        res[f"sparse_{name}"], res[f"sparse_{name}_res"] = s.numpy(), \
            nr.numpy()
    from singa_tpu_torch.observe import monitor

    pi = comm_mod.process_info()
    res["process_info"] = np.array([pi["process_index"], pi["process_count"],
                                    int(monitor._process_rank()),
                                    monitor._process_info()["process_index"]])
    np.savez(os.path.join(out, f"comm_r{rank}.npz"), **res)


def run_refusals(rank, world, out):
    """partialUpdate and sparseTopK refuse clip_norm with ValueError."""
    got = {}
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, 8).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 4, 8).astype(np.int32))
    for mode, spars in (("partialUpdate", None), ("sparseTopK", 0.1)):
        m = DistMLP(mode, spars)
        m.set_optimizer(DistOpt(opt.SGD(lr=0.1, clip_norm=1.0)))
        m.compile([x], is_train=True, use_graph=True)
        try:
            m(x, y)
            got[mode] = "no error"
        except ValueError as e:
            got[mode] = str(e)
    with open(os.path.join(out, f"refusals_r{rank}.json"), "w") as f:
        json.dump(got, f)


def run_partial_keys(rank, world, out):
    """Six partial steps of a fresh MLP: the graph key's phase before
    each step, the runner's entries after, and the all-reduces each step
    issued.  Then ``3W + 2`` graph-mode steps whose prepared steps act as
    CUDA graph replays do (``ReplayStep``) against as many eager ones
    from the same weights: the phases before each, the all-reduces each
    issued, the host step after, and the largest parameter difference."""
    from singa_tpu_torch import graphs
    from singa_tpu_torch.observe.registry import registry

    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(8, 8).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 4, 8).astype(np.int32))
    ar = registry().counter("comms.collectives", op="all_reduce")

    def fresh(use_graph):
        m = DistMLP("partialUpdate")
        dopt = DistOpt(opt.SGD(lr=0.1, momentum=0.9))
        m.set_optimizer(dopt)
        m.compile([x], is_train=True, use_graph=use_graph)
        return m, dopt

    def steps(m, dopt, n):
        phases, counts = [], []
        for _ in range(n):
            phases.append(dopt.graph_key()[1])
            before = ar.value
            m(x, y)
            counts.append(ar.value - before)
        return phases, counts

    m, dopt = fresh(True)
    phases, counts = steps(m, dopt, 6)
    res = dict(phases=phases, all_reduces_per_step=counts,
               entries=len(m._graph_runner._entries))

    class ReplayStep(graphs.Step):
        """A captured step's replay, on the CPU: the function runs at the
        host step it was prepared at, and leaves the host step as it
        found it (a CUDA graph replay runs no Python)."""

        def __init__(self, fn, device, **kw):
            super().__init__(fn, device, **kw)
            self.at = replay_opt.host_step

        def __call__(self):
            now = replay_opt.host_step
            replay_opt.host_step = self.at
            try:
                return self.fn()
            finally:
                replay_opt.host_step = now

    n = 3 * world + 2
    m, replay_opt = fresh(True)
    eager, eager_opt = fresh(False)
    eager.set_states(m.get_states())
    plain_step, graphs.Step = graphs.Step, ReplayStep
    try:
        res["replay_phases"], res["replay_all_reduces"] = steps(
            m, replay_opt, n)
    finally:
        graphs.Step = plain_step
    res["eager_phases"], res["eager_all_reduces"] = steps(eager, eager_opt,
                                                          n)
    res["replay_host_step"] = replay_opt.host_step
    res["replay_max_diff_vs_eager"] = max(
        (v - eager.get_states()[k]).abs().max().item()
        for k, v in m.get_states().items())
    with open(os.path.join(out, f"partial_keys_r{rank}.json"), "w") as f:
        json.dump(res, f)


def main():
    spec = json.load(open(sys.argv[1]))
    rank, world = int(sys.argv[2]), int(spec["world"])
    torch.set_num_threads(1)
    comm_mod.initialize_distributed(
        init_method=spec["init"], num_processes=world, process_id=rank,
        backend="gloo", initialization_timeout=spec.get("timeout", 60))
    try:
        for sc in spec["scenarios"]:
            if sc["name"] == "comm":
                run_comm(sc, rank, world, spec["out"])
            elif sc["name"] == "refusals":
                run_refusals(rank, world, spec["out"])
            elif sc["name"] == "partial_keys":
                run_partial_keys(rank, world, spec["out"])
            else:
                run_scenario(sc, rank, world, spec["out"])
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
