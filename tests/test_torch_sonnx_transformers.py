"""Transformer ONNX interop between the port and the JAX package: BERT
(trunk, with an attention mask, the masked-LM head with dropout) and
GPT-2 (plain and grouped-query), fused and ``use_flash=True``, each
exported by both packages from the same weights (carried across by
``set_states``) and imported by both.

On the CPU the port's flash route is its plain version and the JAX
package's flash kernel runs in interpret mode; both record the same
``TPAttention`` op, which both export as the same decomposed subgraph.
The two packages' exports are the same bytes once the names of baked
constants, which carry a Python ``id`` (``const_<id>``), are numbered in
order, and the process-wide counters in ``_Dropout#<n>`` are dropped.  Tolerances as the JAX package's transformer round trips: rtol
1e-4, atol 1e-5 in float32.
"""

import collections
import re

import numpy as np
import pytest

from singa_tpu import sonnx as jsonnx
from singa_tpu import tensor as jtensor
from singa_tpu.models.bert import BertConfig as JBertConfig
from singa_tpu.models.bert import BertForMaskedLM as JBertForMaskedLM
from singa_tpu.models.bert import BertModel as JBertModel
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu_torch import autograd, device, layer, opt, sonnx, tensor
from singa_tpu_torch.io import onnx_pb
from singa_tpu_torch.models.bert import BertConfig, BertForMaskedLM, BertModel
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

B, S = 2, 12
RTOL, ATOL = 1e-4, 1e-5
NO_DROP = dict(hidden_dropout=0.0, attn_dropout=0.0)


def _inputs(kind):
    rng = np.random.RandomState(0)
    if kind.startswith("gpt2"):
        return [rng.randint(0, 256, (B, S)).astype(np.int32)]
    ids = rng.randint(0, 1000, (B, S)).astype(np.int32)
    if kind == "bert_mlm":
        return [ids]
    tt = np.zeros((B, S), np.int32)
    if kind == "bert_trunk":
        return [ids, tt]
    am = np.ones((B, S), np.float32)
    am[:, -4:] = 0.0  # padded tail
    return [ids, tt, am]


def _models(kind, flash):
    if kind.startswith("bert"):
        kw = dict(use_flash=flash, **({} if kind == "bert_mlm" else NO_DROP))
        if kind == "bert_mlm":
            return (JBertForMaskedLM(JBertConfig.tiny(**kw)),
                    BertForMaskedLM(BertConfig.tiny(**kw)))
        return JBertModel(JBertConfig.tiny(**kw)), BertModel(BertConfig.tiny(**kw))
    kw = dict(dropout=0.0, attn_impl="flash" if flash else "fused")
    if kind == "gpt2_gqa":
        kw["n_kv_head"] = 2
    return (JGPT2LMHead(JGPT2Config.tiny(**kw)),
            GPT2LMHead(GPT2Config.tiny(**kw)))


CASES = [(k, f) for k in ("bert_trunk", "bert_mask", "bert_mlm", "gpt2",
                          "gpt2_gqa") for f in (False, True)
         if not (k == "bert_mlm" and f)]
IDS = [f"{k}-{'flash' if f else 'fused'}" for k, f in CASES]


class Built:
    """One configuration in both packages, the same weights, and both
    packages' exports."""

    def __init__(self, kind, flash):
        self.dev = device.create_cpu_device()
        self.feeds = _inputs(kind)
        jm, tm = _models(kind, flash)
        jx = [jtensor.from_numpy(a) for a in self.feeds]
        self.tx = [tensor.from_numpy(a, self.dev) for a in self.feeds]
        jm.compile(jx[:1], is_train=False, use_graph=False)
        tm.compile(self.tx[:1], is_train=False)
        tm.set_states({k: jtensor.to_numpy(v)
                       for k, v in jm.get_states().items()})
        jm.eval()
        tm.eval()
        self.tm = tm
        out = tm.forward(*self.tx)
        self.native = [tensor.to_numpy(o) for o in
                       (out if isinstance(out, tuple) else (out,))]
        self.jax_bytes = jsonnx.to_onnx(jm, jx).serialize()
        self.port_proto = sonnx.to_onnx(tm, self.tx)
        self.port_bytes = self.port_proto.serialize()


@pytest.fixture(scope="module")
def built():
    return {c: Built(*c) for c in CASES}


def _close(outs, want, what):
    assert len(outs) == len(want), what
    for i, (o, w) in enumerate(zip(outs, want)):
        np.testing.assert_allclose(np.asarray(o), w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} output {i}")


def _canonical(blob):
    """The model re-serialized with every ``const_<id>`` name renumbered
    in order of first appearance and op-class counters dropped."""
    m = onnx_pb.load_model(blob)
    names = {}

    def rename(n):
        if re.fullmatch(r"const_\d+", n):
            return names.setdefault(n, f"const_c{len(names)}")
        # op classes' instance counters (``_Dropout#<n>``) differ too
        return re.sub(r"#\d+_", "#_", n)

    g = m.graph
    for node in g.node:
        node.input = [rename(n) for n in node.input]
        node.output = [rename(n) for n in node.output]
    for t in list(g.initializer) + list(g.input) + list(g.output):
        t.name = rename(t.name)
    return m.serialize()


def _signature(blob):
    m = onnx_pb.load_model(blob)
    canon = lambda n: re.sub(r"^const_\d+$", "const_#", n)  # noqa: E731
    return (collections.Counter(n.op_type for n in m.graph.node),
            sorted((canon(i.name), tuple(i.dims), i.data_type)
                   for i in m.graph.initializer))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_port_roundtrip(built, case, tmp_path):
    b = built[case]
    path = str(tmp_path / "model.onnx")
    sonnx.save(b.port_proto, path)
    rep = sonnx.prepare(path, b.dev)
    _close([tensor.to_numpy(o) for o in rep.run(b.feeds)], b.native,
           f"{case} port -> port")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_jax_export_into_port(built, case):
    b = built[case]
    rep = sonnx.prepare(b.jax_bytes, b.dev)
    outs = [tensor.to_numpy(o) for o in rep.run(b.feeds)]
    _close(outs, b.native, f"{case} JAX -> port")
    jouts = [jtensor.to_numpy(o)
             for o in jsonnx.prepare(b.jax_bytes).run(b.feeds)]
    _close(outs, jouts, f"{case} JAX -> port vs JAX -> JAX")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_port_export_into_jax(built, case):
    b = built[case]
    outs = [jtensor.to_numpy(o)
            for o in jsonnx.prepare(b.port_bytes).run(b.feeds)]
    _close(outs, b.native, f"{case} port -> JAX")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_exports_agree(built, case):
    """Equal op-type counts, initializer names, shapes and types, and the
    same bytes up to the baked constants' id-derived names."""
    b = built[case]
    assert _signature(b.port_bytes) == _signature(b.jax_bytes)
    assert _canonical(b.port_bytes) == _canonical(b.jax_bytes)


def test_flash_route_records_tpattention(built):
    """The flash and fused BERT graphs differ only in the recorded
    op's name, Attention against TPAttention; the decomposition is the
    same."""
    fused = onnx_pb.load_model(built[("bert_trunk", False)].port_bytes)
    flash = onnx_pb.load_model(built[("bert_trunk", True)].port_bytes)
    assert [n.op_type for n in fused.graph.node] == \
        [n.op_type for n in flash.graph.node]
    assert any("TPAttention" in o for n in flash.graph.node
               for o in n.output)
    assert not any("TPAttention" in o for n in fused.graph.node
                   for o in n.output)


def test_gpt2_causality_survives(built):
    """Perturbing the last token moves only the last position's logits of
    the imported graph."""
    b = built[("gpt2", False)]
    rep = sonnx.prepare(b.port_bytes, b.dev)
    ids2 = b.feeds[0].copy()
    ids2[:, -1] = (ids2[:, -1] + 1) % 256
    a = tensor.to_numpy(rep.run(b.feeds)[0])
    c = tensor.to_numpy(rep.run([ids2])[0])
    np.testing.assert_allclose(a[:, :-1], c[:, :-1], rtol=1e-5, atol=1e-6)
    assert not np.allclose(a[:, -1], c[:, -1])


def test_exported_constants_frozen_and_shared(built):
    """Decomposer constants are Constant nodes (never trainable once
    imported) and shape-keyed, so the layers share one causal mask."""
    proto = built[("gpt2", False)].port_proto
    consts = [n.output[0] for n in proto.graph.node
              if n.op_type == "Constant"]
    assert len([c for c in consts if c.startswith("const_causal")]) == 1
    for prefix in ("const_causal", "const_scale", "const_shape",
                   "const_one", "const_neg", "const_idx", "const_axes"):
        assert not any(i.name.startswith(prefix)
                       for i in proto.graph.initializer), prefix
    sm = sonnx.SONNXModel(proto, built[("gpt2", False)].dev)
    trainable = set(sm.get_params())
    assert trainable
    assert not any(n.startswith("const_") for n in trainable)


class _TrainableImport(sonnx.SONNXModel):
    def __init__(self, proto, dev):
        super().__init__(proto, dev)
        self.loss_fn = layer.SoftMaxCrossEntropy()

    def train_one_batch(self, x, y):
        logits = self.forward(x)
        b, s, v = logits.shape
        loss = self.loss_fn(autograd.reshape(logits, (b * s, v)),
                            autograd.reshape(y, (b * s,)))
        self.optimizer(loss)
        return logits, loss


def test_imported_gpt2_is_trainable(built):
    """SONNXModel over the imported GPT-2: gradients reach every
    initializer through the decomposed graph, and the loss falls."""
    b = built[("gpt2", False)]
    ids = b.feeds[0]
    labels = np.roll(ids, -1, 1).astype(np.int64)
    m = _TrainableImport(b.port_proto, b.dev)
    m.set_optimizer(opt.Adam(lr=2e-3))
    m.train(True)
    x = tensor.from_numpy(ids, b.dev)
    y = tensor.from_numpy(labels, b.dev)
    losses = [float(m(x, y)[1].detach()) for _ in range(8)]
    assert losses[-1] < losses[0] - 0.3, losses
    assert not any(n.startswith("const_") for n in m.get_params())
