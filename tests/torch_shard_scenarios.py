"""The port's sharded-training scenarios, run by every rank of a spawned
gloo group (``tests/torch_dist_worker.py`` hands them any scenario with
a ``kind``), and the launcher the test files use to spawn that group.

Kinds: ``ring`` (ring and zigzag attention, ``parallel/ring_attention.py``),
``train`` (a model under a ``ShardingPlan``: two steps from a JAX zip),
``pipe`` (``gpipe_spmd`` and ``PipelinedTransformer``) and ``refusals``.
Each rank writes ``<name>_r<rank>.npz`` (or ``.json``) into the spec's
``out`` directory.  Nothing here imports JAX.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from singa_tpu_torch import autograd, device, layer, model, opt
from singa_tpu_torch.parallel import communicator as _comm
from singa_tpu_torch.parallel import sharding as shd
from singa_tpu_torch.parallel.tensor_parallel import (
    ColumnParallelLinear, ParallelTransformerBlock, VocabParallelEmbedding,
    gather_from_axis)

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dist_worker.py"
JOIN_S = 150

# tests/test_parallel.py's TinyLM
VOCAB, HIDDEN, HEADS, INTER, LAYERS = 64, 32, 4, 64, 2
# tests/test_pipeline.py's PipeLM
P_VOCAB, P_HIDDEN, P_HEADS, P_INTER, P_LAYERS = 32, 16, 2, 32, 4


class TinyLM(model.Model):
    """``tests/test_parallel.py``'s ``TinyLM`` on the port."""

    def __init__(self, plan=None, causal=True, use_flash=False):
        super().__init__()
        self.embed = VocabParallelEmbedding(VOCAB, HIDDEN, plan)
        self.blocks = torch.nn.ModuleList(
            ParallelTransformerBlock(HEADS, INTER, plan, causal=causal,
                                     use_flash=use_flash)
            for _ in range(LAYERS))
        self.head = ColumnParallelLinear(VOCAB, plan, gather_output=True)
        self.loss_fn = layer.SoftMaxCrossEntropy()

    def forward(self, ids):
        x = self.embed(ids)
        for blk in self.blocks:
            x = blk(x)
        return self.head(x)

    def train_one_batch(self, ids, labels):
        logits = self.forward(ids)
        b, s, v = logits.shape
        loss = self.loss_fn(autograd.reshape(logits, (b * s, v)),
                            autograd.reshape(labels, (b * s,)))
        self.optimizer(loss)
        return logits, loss


class PipeLM(model.Model):
    """``tests/test_pipeline.py``'s ``PipeLM`` on the port."""

    def __init__(self, plan=None, num_microbatches=4):
        from singa_tpu_torch.parallel.pipeline import PipelinedTransformer

        super().__init__()
        self.embed = layer.Embedding(P_VOCAB, P_HIDDEN)
        self.trunk = PipelinedTransformer(P_LAYERS, P_HEADS, P_INTER,
                                          plan=plan,
                                          num_microbatches=num_microbatches)
        self.head = layer.Linear(P_VOCAB)
        self.loss_fn = layer.SoftMaxCrossEntropy()

    def forward(self, ids):
        return self.head(self.trunk(self.embed(ids)))

    def train_one_batch(self, ids, labels):
        logits = self.forward(ids)
        b, s, v = logits.shape
        loss = self.loss_fn(autograd.reshape(logits, (b * s, v)),
                            autograd.reshape(labels, (b * s,)))
        self.optimizer(loss)
        return logits, loss


def build_model(kind, plan):
    """The scenario's model: ``tinylm``, ``gpt2`` (``GPT2Config.tiny``),
    ``bert`` (``BertConfig.tiny``), or ``pipe``; no dropout."""
    if kind == "tinylm":
        return TinyLM(plan)
    if kind == "gpt2":
        from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

        return GPT2LMHead(GPT2Config.tiny(dropout=0.0), plan)
    if kind == "bert":
        from singa_tpu_torch.models.bert import BertConfig, BertForMaskedLM

        return BertForMaskedLM(BertConfig.tiny(hidden_dropout=0.0,
                                               attn_dropout=0.0), plan)
    if kind == "pipe":
        return PipeLM(plan)
    raise ValueError(kind)


def _mesh(sizes):
    return shd.create_mesh(*sizes, device="cpu")


def _gather_seq(t, axis):
    return t if axis.size == 1 else _comm.group_all_gather(t, axis.group,
                                                           dim=2)


# ------------------------------------------------------------------ ring


def run_ring(sc, rank, world, out):
    """Every case of ``sc["cases"]`` on the arrays of ``sc["data"]``
    (global q, k, v, w, masks): the ring's output and the gradients of
    ``sum(o * w)`` gathered to global arrays."""
    from singa_tpu_torch.parallel import ring_attention as ra

    d = np.load(sc["data"])
    mesh = _mesh((1, 1, world, 1, 1))
    axis = mesh.axis(shd.SEQ)
    res = {}
    for case in sc["cases"]:
        name, layout = case["name"], case["layout"]
        q, k, v = (torch.from_numpy(d[n]).requires_grad_()
                   for n in ("q", "k", "v"))
        w = torch.from_numpy(d["w"])
        if layout == "repartition":
            x = torch.from_numpy(d["q"])
            loc = ra._local(x, axis)
            zz = ra.zigzag_repartition(loc, axis)
            back = ra.zigzag_repartition(zz, axis, inverse=True)
            res[f"{name}/zigzag"] = _gather_seq(zz, axis).numpy()
            res[f"{name}/back"] = _gather_seq(back, axis).numpy()
            continue
        if layout == "zigzag_sharded":
            o = ra.zigzag_ring_attention_sharded(
                q, k, v, mesh=mesh, use_flash=case.get("use_flash", False))
        elif layout == "sharded":
            o = ra.ring_attention_sharded(q, k, v, mesh=mesh,
                                          causal=case["causal"])
        else:
            mask = case.get("mask")
            kv_mask = None if mask is None else ra._local(
                torch.from_numpy(d[mask]).transpose(2, 3), axis) \
                .transpose(2, 3)
            ql, kl, vl = (ra._local(t, axis) for t in (q, k, v))
            if layout == "zigzag":
                ql, kl, vl = (ra.zigzag_repartition(t, axis)
                              for t in (ql, kl, vl))
                ol = ra.zigzag_ring_self_attention(
                    ql, kl, vl, axis, use_flash=case.get("use_flash", False))
                ol = ra.zigzag_repartition(ol, axis, inverse=True)
            else:
                ol = ra.ring_self_attention(
                    ql, kl, vl, axis, causal=case["causal"], kv_mask=kv_mask,
                    use_flash=case.get("use_flash", False))
            o = gather_from_axis(ol, axis, dim=2)
        (o * w).sum().backward()
        res[f"{name}/o"] = o.detach().numpy()
        for n, t in (("dq", q), ("dk", k), ("dv", v)):
            # each rank holds its own block's gradient (zeros elsewhere)
            g = t.grad.clone()
            _comm.group_all_reduce(g, None)
            res[f"{name}/{n}"] = g.numpy()
    np.savez(os.path.join(out, f"{sc['name']}_r{rank}.npz"), **res)


# ----------------------------------------------------------------- train


def _numpy(t):
    return t.detach().cpu().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def run_train(sc, rank, world, out):
    """A model under ``sc["mesh"]`` (dp, tp, sp[, pp]): compiled on the
    global batch, loaded from the JAX zip, ``sc["steps"]`` graph-mode
    steps (or one ``train_n_batches`` call); the losses, the gathered
    states and optimizer states, the parameters' specs, and a
    ``save_states`` zip."""
    dev = device.create_cpu_device()
    dev.SetRandSeed(0)
    sizes = tuple(sc["mesh"]) + (1,) * (5 - len(sc["mesh"]))
    plan = shd.ShardingPlan(_mesh(sizes))
    m = build_model(sc["model"], plan)
    m.set_sharding_plan(plan)
    m.set_optimizer(opt.SGD(**sc["sgd"]))
    d = np.load(sc["data"])
    xs, ys = torch.from_numpy(d["xs"]), torch.from_numpy(d["ys"])
    m.compile([xs[0]], is_train=True, use_graph=True)
    m.load_states(sc["zip"])
    n = sc["steps"]
    if sc.get("multi"):
        _, losses = m.train_n_batches(xs[:n], ys[:n])
        losses = losses.numpy()
    else:
        losses = np.asarray([m(xs[i], ys[i])[1].item() for i in range(n)])
    res = {f"state/{k}": _numpy(v) for k, v in m.get_states().items()}
    res.update({f"opt/{k}": _numpy(v)
                for k, v in m._optimizer_states().items()})
    res["losses"] = losses
    res["local_shapes"] = np.array(json.dumps(
        {k: list(v.shape) for k, v in m._local_states().items()}))
    res["specs"] = np.array(json.dumps(
        {k: [list(e) if isinstance(e, tuple) else e
             for e in getattr(v, "partition_spec", ())]
         for k, v in m.get_params().items()}))
    m.save_states(os.path.join(out, f"{sc['name']}_r{rank}.zip"))
    np.savez(os.path.join(out, f"{sc['name']}_r{rank}.npz"), **res)


def run_refusals(sc, rank, world, out):
    """A ``DistOpt`` with a plan raises ``ValueError`` in either order;
    an undivided vocabulary raises naming the table and the axis; a
    planned graph step over gloo on the CPU runs (capture refusal is
    for the card)."""
    from singa_tpu_torch.parallel.dist_opt import DistOpt

    got = {}
    plan = shd.ShardingPlan(_mesh((1, world, 1, 1, 1)))
    m = TinyLM(plan)
    m.set_sharding_plan(plan)
    try:
        m.set_optimizer(DistOpt(opt.SGD(lr=0.1)))
        got["plan_then_distopt"] = "no error"
    except ValueError as e:
        got["plan_then_distopt"] = str(e)
    m = TinyLM(plan)
    m.set_optimizer(DistOpt(opt.SGD(lr=0.1)))
    try:
        m.set_sharding_plan(plan)
        got["distopt_then_plan"] = "no error"
    except ValueError as e:
        got["distopt_then_plan"] = str(e)
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    g = GPT2LMHead(GPT2Config.tiny(vocab_size=255, dropout=0.0), plan)
    g.set_sharding_plan(plan)
    g.set_optimizer(opt.SGD(lr=0.1))
    try:
        g.compile([torch.zeros((2, 8), dtype=torch.int32)], is_train=True)
        got["undivided_vocab"] = "no error"
    except ValueError as e:
        got["undivided_vocab"] = str(e)
    with open(os.path.join(out, f"{sc['name']}_r{rank}.json"), "w") as f:
        json.dump(got, f)


# ------------------------------------------------------------------ pipe


def run_pipe(sc, rank, world, out):
    """``gpipe_spmd`` over the mesh's pipe axis on ``stage(x) = tanh(x ·
    W_r + b_r)`` with this rank's rows of the stacked global W, b: the
    outputs and the gradients of ``sum(y * w)`` (W, b gathered)."""
    from singa_tpu_torch.parallel.pipeline import gpipe_spmd

    d = np.load(sc["data"])
    sizes = tuple(sc["mesh"]) + (1,) * (5 - len(sc["mesh"]))
    mesh = _mesh(sizes)
    axis = mesh.axis(shd.PIPE)
    spec = shd.P(shd.PIPE)
    wl = torch.nn.Parameter(shd.shard_array(d["W"], mesh, spec))
    bl = torch.nn.Parameter(shd.shard_array(d["b"], mesh, spec))
    x = torch.from_numpy(d["x"]).requires_grad_()

    def stage(p, h):
        for i in range(p["W"].shape[0]):
            h = torch.tanh(h @ p["W"][i] + p["b"][i])
        return h

    y = gpipe_spmd(stage, {"W": wl, "b": bl}, x, axis)
    (y * torch.from_numpy(d["w"])).sum().backward()
    res = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
           "dW": shd.gather_array(wl.grad, mesh, spec).numpy(),
           "db": shd.gather_array(bl.grad, mesh, spec).numpy()}
    np.savez(os.path.join(out, f"{sc['name']}_r{rank}.npz"), **res)


KINDS = {"ring": run_ring, "train": run_train, "refusals": run_refusals,
         "pipe": run_pipe}


def run(sc, rank, world, out):
    KINDS[sc["kind"]](sc, rank, world, out)


# ----------------------------------------------------- the test side


def launch(tmp, world, scenarios):
    """Start ``world`` ranks of ``tests/torch_dist_worker.py`` over a gloo
    group meeting at a ``file://`` URL under ``tmp``; returns the
    processes and their logs."""
    spec = dict(world=world, init=f"file://{tmp}/rendezvous", out=str(tmp),
                timeout=60, scenarios=scenarios)
    path = Path(tmp) / "spec.json"
    path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(Path(tmp) / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), str(path), str(r)], cwd=ROOT,
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def join(tmp, procs):
    """Wait for every rank (``JOIN_S`` in all); raises with every rank's
    log when one failed or hung (a hung rank is killed)."""
    deadline = time.monotonic() + JOIN_S
    rcs = []
    for p, log in procs:
        try:
            rcs.append(p.wait(max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            rcs.append("timeout")
        log.close()
    if any(rc != 0 for rc in rcs):
        logs = "\n".join((Path(tmp) / f"rank{r}.log").read_text()[-3000:]
                         for r in range(len(procs)))
        raise RuntimeError(f"rank exit codes {rcs}:\n{logs}")


def load_ranks(tmp, name, world):
    return [dict(np.load(Path(tmp) / f"{name}_r{r}.npz"))
            for r in range(world)]
