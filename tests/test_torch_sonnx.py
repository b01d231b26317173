"""The port's ``sonnx`` (import, export, ``SONNXModel``) against the JAX
package's: the cases of ``tests/test_sonnx.py`` run on the port, and
where the JAX package can run the same thing, the two are held together.

Everything runs on the CPU at small sizes.  Models are built in both
packages and the JAX weights carried into the port by ``set_states``, or
built in the port alone where only the port is under test.  Tolerances:
rtol 1e-4, atol 1e-5 in float32 for outputs (2e-4 against torch-golden
recurrences, as the JAX tests); exports are compared byte for byte.
"""

import collections
import os

import numpy as np
import pytest
import torch

from singa_tpu import sonnx as jsonnx
from singa_tpu import tensor as jtensor
from singa_tpu.models.cnn import CNN as JCNN
from singa_tpu.models.mlp import MLP as JMLP
from singa_tpu_torch import autograd, device, layer, model, opt, sonnx, tensor
from singa_tpu_torch.io import onnx_pb
from singa_tpu_torch.models.char_rnn import CharRNN, one_hot
from singa_tpu_torch.models.cnn import CNN
from singa_tpu_torch.models.mlp import MLP

import test_onnx_conformance as jc

RTOL, ATOL = 1e-4, 1e-5
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture
def dev():
    d = device.create_cpu_device()
    d.SetRandSeed(0)
    return d


def _t(a, dev):
    return tensor.from_numpy(np.asarray(a), dev)


def _np(t):
    return tensor.to_numpy(t)


def _graph_model(nodes, initializers, inputs, outputs):
    return onnx_pb.ModelProto(graph=onnx_pb.GraphProto(
        name="t", node=nodes, initializer=initializers, input=inputs,
        output=outputs))


def _vi(name, elem=onnx_pb.FLOAT, shape=()):
    return onnx_pb.ValueInfoProto(name, elem, list(shape))


# ------------------------------------------------- both packages, one model


def _pair(jm, tm, x, dev):
    """Compile both on ``x`` and carry the JAX weights into the port."""
    jx, tx = jtensor.from_numpy(x), _t(x, dev)
    jm.compile([jx], is_train=False, use_graph=False)
    tm.compile([tx], is_train=False)
    tm.set_states({k: jtensor.to_numpy(v)
                   for k, v in jm.get_states().items()})
    return jx, tx


MODELS = {
    "mlp": (lambda: JMLP(data_size=6, perceptron_size=8, num_classes=3),
            lambda: MLP(data_size=6, perceptron_size=8, num_classes=3),
            (4, 6)),
    "cnn": (lambda: JCNN(num_classes=10, num_channels=1),
            lambda: CNN(num_classes=10, num_channels=1), (2, 1, 28, 28)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_export_import_roundtrip(name, dev, tmp_path):
    """Port export -> file -> port import == the port's forward."""
    _, make, shape = MODELS[name]
    m = make()
    x = _t(np.random.RandomState(0).randn(*shape).astype(np.float32), dev)
    m.compile([x], is_train=False)
    native = _np(m.forward(x))
    path = str(tmp_path / f"{name}.onnx")
    sonnx.save(sonnx.to_onnx(m, [x]), path)
    (out,) = sonnx.prepare(path, dev).run([x])
    np.testing.assert_allclose(_np(out), native, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_same_export_bytes_and_outputs_across_packages(name, dev):
    """The same weights export to the same bytes in both packages, and
    each package's import of them gives the same outputs."""
    make_j, make_t, shape = MODELS[name]
    jm, tm = make_j(), make_t()
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    jx, tx = _pair(jm, tm, x, dev)
    jblob = jsonnx.to_onnx(jm, [jx]).serialize()
    tblob = sonnx.to_onnx(tm, [tx]).serialize()
    assert tblob == jblob
    jout = jtensor.to_numpy(jsonnx.prepare(jblob).run([x])[0])
    tout = _np(sonnx.prepare(jblob, dev).run([x])[0])
    np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tout, _np(tm.forward(tx)), rtol=RTOL,
                               atol=ATOL)


class _Trainable(sonnx.SONNXModel):
    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = autograd.softmax_cross_entropy(out, y)
        self.optimizer(loss)
        return out, loss


def _mlp_proto(dev, n=16):
    m = MLP(data_size=6, perceptron_size=8, num_classes=3)
    rng = np.random.RandomState(0)
    x = _t(rng.randn(n, 6).astype(np.float32), dev)
    y = _t(rng.randint(0, 3, (n,)).astype(np.int64), dev)
    m.compile([x], is_train=False)
    return sonnx.to_onnx(m, [x]), x, y


@pytest.mark.parametrize("use_graph", [False, True])
def test_imported_model_is_trainable(dev, use_graph):
    """SONNXModel trains an imported MLP eagerly and through the graph
    runner (on the CPU the runner runs its steps eagerly, through the
    same keys and buffers); both give the same losses, which fall."""
    proto, x, y = _mlp_proto(dev)
    runs = {}
    for graph in sorted({False, use_graph}):
        tm = _Trainable(proto, dev)
        tm.compile([x], is_train=True, use_graph=graph)
        tm.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
        runs[graph] = [float(tm(x, y)[1].detach()) for _ in range(10)]
    losses = runs[use_graph]
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(runs[use_graph], runs[False], rtol=1e-6)


def test_imported_training_matches_jax(dev):
    """Three SGD steps of the imported MLP in each package, from the
    same bytes: equal losses and weights (rtol 1e-4, atol 1e-5)."""
    proto, x, y = _mlp_proto(dev)
    blob = proto.serialize()

    class JTrainable(jsonnx.SONNXModel):
        def train_one_batch(self, xx, yy):
            from singa_tpu import autograd as jag

            out = self.forward(xx)
            loss = jag.softmax_cross_entropy(out, yy)
            self.optimizer(loss)
            return out, loss

    from singa_tpu import opt as jopt

    jm = JTrainable(blob)
    jm.set_optimizer(jopt.SGD(lr=0.1, momentum=0.9))
    jm.train(True)
    jx = jtensor.from_numpy(_np(x))
    jy = jtensor.from_numpy(_np(y).astype(np.int32))
    jl = [float(jtensor.to_numpy(jm.train_one_batch(jx, jy)[1]))
          for _ in range(3)]
    tm = _Trainable(blob, dev)
    tm.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    tm.train(True)
    tl = [float(tm.train_one_batch(x, y)[1].detach()) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    jw = {k: jtensor.to_numpy(v) for k, v in jm.get_states().items()}
    for k, v in tm.get_states().items():
        np.testing.assert_allclose(_np(v), jw[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_imported_states_zip_interchange(dev, tmp_path):
    """A save_states zip of an imported model (weights, momentum, step
    counter) loads into the JAX package's SONNXModel of the same bytes,
    and the JAX package's zip back into the port, bit for bit."""
    proto, x, y = _mlp_proto(dev)
    blob = proto.serialize()
    tm = _Trainable(blob, dev)
    tm.compile([x], is_train=True)
    tm.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    tm(x, y)
    assert set(tm.get_states()) == {i.name for i in proto.graph.initializer}
    p1 = str(tmp_path / "port.zip")
    tm.save_states(p1)

    from singa_tpu import opt as jopt

    jm = jsonnx.SONNXModel(blob)
    jm.set_optimizer(jopt.SGD(lr=0.1, momentum=0.9))
    jm.load_states(p1)
    for k, v in tm.get_states().items():
        np.testing.assert_array_equal(jtensor.to_numpy(jm.get_states()[k]),
                                      _np(v), err_msg=k)
    p2 = str(tmp_path / "jax.zip")
    jm.save_states(p2)
    tm2 = _Trainable(blob, dev)
    tm2.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    tm2.load_states(p2)
    for k, v in tm.get_states().items():
        np.testing.assert_array_equal(_np(tm2.get_states()[k]), _np(v),
                                      err_msg=k)
    for k, v in tm.optimizer.state_tensors().items():
        np.testing.assert_array_equal(
            _np(tm2.optimizer.state_tensors()[k]), _np(v), err_msg=k)
    # the escaped module keys never leak: states and params by ONNX name
    assert all("." in k for k in tm.get_params())
    assert {k.rpartition(":")[0] for k in tm.optimizer.state_tensors()
            if ":" in k} <= set(tm.get_params())


# ------------------------------------------------------------ the importer


def test_unsupported_op_reports_name(dev):
    g = _graph_model([onnx_pb.NodeProto(op_type="FancyOp", input=["x"],
                                        output=["y"])], [],
                     [_vi("x", shape=[1])], [_vi("y", shape=[1])])
    with pytest.raises(NotImplementedError, match="FancyOp"):
        sonnx.prepare(g, dev).run([np.zeros((1,), np.float32)])


def test_handlers_cover_bert_oplist():
    bert_ops = ["Add", "Cast", "Concat", "Constant", "ConstantOfShape",
                "Div", "Erf", "Gather", "Identity", "MatMul", "Mul",
                "Pow", "ReduceMean", "Reshape", "Shape", "Slice",
                "Softmax", "Sqrt", "Sub", "Tanh", "Transpose",
                "Unsqueeze", "Where", "Expand", "Equal",
                "LayerNormalization", "Gemm"]
    assert not [o for o in bert_ops if o not in sonnx._ONNX_OPS]


def test_layernorm_export_preserves_eps(dev):
    class M(model.Model):
        def __init__(self):
            super().__init__()
            self.ln = layer.LayerNorm(eps=1e-12)

        def forward(self, x):
            return self.ln(x)

    m = M()
    x = _t(np.random.RandomState(0).randn(2, 8).astype(np.float32) * 100,
           dev)
    m.compile([x], is_train=False)
    proto = sonnx.to_onnx(m, [x])
    ln = [n for n in proto.graph.node if n.op_type == "LayerNormalization"]
    assert ln and ln[0].attrs()["epsilon"] == pytest.approx(1e-12)
    (out,) = sonnx.prepare(proto, dev).run([x])
    np.testing.assert_allclose(_np(out), _np(m.forward(x)), rtol=1e-5,
                               atol=1e-6)


def test_same_pool_records_resolved_pads(dev):
    """SAME pooling records its resolved (lo, hi) pads for export."""
    from singa_tpu_torch.ops import pooling as pool_ops

    x = _t(np.random.RandomState(2).randn(1, 1, 5, 5).astype(np.float32),
           dev)
    with autograd.ExportRecord() as rec:
        y = pool_ops.pooling2d(x, kernel=(2, 2), stride=(2, 2),
                               is_max=True, pad_mode="SAME_UPPER")
    assert tuple(y.shape) == (1, 1, 3, 3)
    assert rec.producer[id(y)].params["pads_pairs"] == ((0, 1), (0, 1))


@pytest.mark.parametrize("name,tol", [("gemm", (1e-5, 1e-6)),
                                      ("ct_lstm", (2e-4, 1e-5)),
                                      ("trilu_scatternd", (2e-5, 1e-6))])
def test_foreign_fixture(name, tol, dev):
    """ONNX files written by an independent encoder
    (tests/fixtures/make_foreign_onnx.py), against their goldens, and
    against the JAX package's import of the same bytes."""
    with open(os.path.join(FIXTURES, f"foreign_{name}.onnx"), "rb") as f:
        blob = f.read()
    io = np.load(os.path.join(FIXTURES, f"foreign_{name}_io.npz"))
    (out,) = sonnx.prepare(blob, dev).run([_t(io["x"], dev)])
    np.testing.assert_allclose(_np(out), io["y"], rtol=tol[0], atol=tol[1])
    jout = jtensor.to_numpy(jsonnx.prepare(blob).run([io["x"]])[0])
    np.testing.assert_allclose(_np(out), jout, rtol=RTOL, atol=ATOL)


def test_asymmetric_conv_pads_import(dev):
    rng = np.random.RandomState(3)
    x = rng.randn(1, 2, 6, 6).astype(np.float32)
    W = rng.randn(3, 2, 3, 3).astype(np.float32)
    node = onnx_pb.NodeProto(
        op_type="Conv", name="c", input=["x", "W"], output=["y"],
        attribute=[onnx_pb.AttributeProto.make("kernel_shape", [3, 3]),
                   onnx_pb.AttributeProto.make("pads", [0, 0, 1, 1]),
                   onnx_pb.AttributeProto.make("strides", [1, 1])])
    g = _graph_model([node], [onnx_pb.TensorProto.from_numpy(W, "W")],
                     [_vi("x", shape=[1, 2, 6, 6])],
                     [_vi("y", shape=[1, 3, 5, 5])])
    (out,) = sonnx.prepare(g, dev).run([x])
    ref = torch.nn.functional.conv2d(
        torch.nn.functional.pad(torch.from_numpy(x), [0, 1, 0, 1]),
        torch.from_numpy(W))
    np.testing.assert_allclose(_np(out), ref.numpy(), rtol=RTOL, atol=ATOL)
    jout = jtensor.to_numpy(jsonnx.prepare(g.serialize()).run([x])[0])
    np.testing.assert_allclose(_np(out), jout, rtol=RTOL, atol=ATOL)


def _pad_model(attrs, n_inputs):
    names = ["x", "pads", "cval"][:n_inputs]
    node = onnx_pb.NodeProto(op_type="Pad", name="p", input=names,
                             output=["y"], attribute=attrs)
    return _graph_model([node], [], [_vi(n) for n in names], [_vi("y")])


def test_pad_mode_and_constant_value_input(dev):
    x_np = np.arange(6, dtype=np.float32).reshape(2, 3)
    feeds = {"x": x_np, "pads": np.array([0, 1, 0, 1], np.int64),
             "cval": np.array([7.5], np.float32)}
    (out,) = sonnx.prepare(_pad_model([], 3), dev).run(feeds)
    np.testing.assert_array_equal(
        _np(out), np.pad(x_np, ((0, 0), (1, 1)), constant_values=7.5))
    rep = sonnx.prepare(_pad_model(
        [onnx_pb.AttributeProto.make("mode", "reflect")], 2), dev)
    (out,) = rep.run({"x": x_np, "pads": feeds["pads"]})
    np.testing.assert_array_equal(
        _np(out), np.pad(x_np, ((0, 0), (1, 1)), mode="reflect"))
    rep = sonnx.prepare(_pad_model(
        [onnx_pb.AttributeProto.make("mode", "wrap")], 2), dev)
    with pytest.raises(NotImplementedError):
        rep.run({"x": x_np, "pads": feeds["pads"]})


def test_negative_pads_crop(dev):
    x_np = np.arange(16, dtype=np.float32).reshape(4, 4)
    rep = sonnx.prepare(_pad_model([], 2), dev)
    (out,) = rep.run({"x": x_np, "pads": np.array([0, -1, 0, -1], np.int64)})
    np.testing.assert_array_equal(_np(out), x_np[:, 1:3])


def test_constants_made_once_on_the_rep_device(dev):
    """Constant, Shape and Range values land on the rep's device, keep a
    host copy, and a second run reuses the tensors the first made (a
    captured replay then reads them without a host copy)."""
    cval = onnx_pb.TensorProto.from_numpy(np.float32(3.0).reshape(()), "c")
    nodes = [onnx_pb.NodeProto(op_type="Constant", name="k", input=[],
                               output=["c"], attribute=[
                                   onnx_pb.AttributeProto.make("value",
                                                               cval)]),
             onnx_pb.NodeProto(op_type="Shape", name="s", input=["x"],
                               output=["shp"])]
    g = _graph_model(nodes, [], [_vi("x", shape=[2, 3])],
                     [_vi("c"), _vi("shp", onnx_pb.INT64, [2])])
    rep = sonnx.prepare(g, dev)
    x = _t(np.zeros((2, 3), np.float32), dev)
    c, shp = rep.run([x])
    c2, shp2 = rep.run([x])
    assert c.device == shp.device == dev.torch_device
    assert c2 is c and shp2 is shp
    assert tuple(c.shape) == ()
    np.testing.assert_array_equal(getattr(shp, sonnx._HOST_ATTR), [2, 3])


def test_export_grad_free_graph(dev):
    m = MLP(data_size=6, perceptron_size=8, num_classes=3)
    x = _t(np.random.RandomState(5).randn(4, 6).astype(np.float32), dev)
    m.compile([x], is_train=False)
    for p in m.get_params().values():
        p.requires_grad_(False)
    proto = sonnx.to_onnx(m, [x])
    (out,) = sonnx.prepare(proto, dev).run([x])
    np.testing.assert_allclose(_np(out), _np(m.forward(x)), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------ control flow


def _branch(tag, op, d, local_name=None):
    cname = local_name or f"{tag}_c"
    return onnx_pb.GraphProto(
        name=tag,
        node=[onnx_pb.NodeProto(op_type=op, name=f"{tag}_n",
                                input=["x", cname], output=[f"{tag}_y"])],
        initializer=[onnx_pb.TensorProto.from_numpy(
            np.full((2, 3), d, np.float32), cname)],
        output=[_vi(f"{tag}_y", shape=[2, 3])])


def _if_model(then_g, else_g, extra_inputs=()):
    node = onnx_pb.NodeProto(
        op_type="If", name="if0", input=["cond"], output=["y"],
        attribute=[onnx_pb.AttributeProto.make("then_branch", then_g),
                   onnx_pb.AttributeProto.make("else_branch", else_g)])
    return _graph_model(
        [node], [],
        [_vi("cond", onnx_pb.BOOL), _vi("x", shape=[2, 3])]
        + list(extra_inputs), [_vi("y", shape=[2, 3])])


@pytest.mark.parametrize("cond", [True, False])
def test_if_after_wire_roundtrip(dev, cond):
    """If's subgraph attributes survive the codec; the condition picks
    the branch; both branches read the outer input x."""
    blob = _if_model(_branch("t", "Add", 1.0),
                     _branch("e", "Add", -1.0)).serialize()
    x_np = np.ones((2, 3), np.float32)
    (y,) = sonnx.prepare(blob, dev).run({"cond": np.asarray(cond),
                                         "x": x_np})
    np.testing.assert_allclose(_np(y), x_np + (1.0 if cond else -1.0))
    (jy,) = jsonnx.prepare(blob).run({"cond": np.asarray(cond), "x": x_np})
    np.testing.assert_array_equal(_np(y), jtensor.to_numpy(jy))


def test_if_branch_initializer_shadows_outer_name(dev):
    g = _if_model(_branch("t", "Add", 5.0, "c"),
                  _branch("e", "Add", -5.0, "c"),
                  extra_inputs=[_vi("c", shape=[2, 3])])
    (y,) = sonnx.prepare(g, dev).run(
        {"cond": np.asarray(True), "x": np.zeros((2, 3), np.float32),
         "c": np.full((2, 3), 100.0, np.float32)})
    np.testing.assert_allclose(_np(y), np.full((2, 3), 5.0))


def _loop_model():
    body = onnx_pb.GraphProto(
        name="body",
        node=[onnx_pb.NodeProto(op_type="Add", name="b",
                                input=["v_in", "x"], output=["v_out"]),
              onnx_pb.NodeProto(op_type="Identity", name="c",
                                input=["cond_in"], output=["cond_out"])],
        input=[_vi("it", onnx_pb.INT64), _vi("cond_in", onnx_pb.BOOL),
               _vi("v_in", shape=[2, 3])],
        output=[_vi("cond_out", onnx_pb.BOOL), _vi("v_out", shape=[2, 3])])
    node = onnx_pb.NodeProto(
        op_type="Loop", name="loop0", input=["M", "keep", "v0"],
        output=["vf"], attribute=[onnx_pb.AttributeProto.make("body", body)])
    return _graph_model(
        [node], [],
        [_vi("M", onnx_pb.INT64), _vi("keep", onnx_pb.BOOL),
         _vi("v0", shape=[2, 3]), _vi("x", shape=[2, 3])],
        [_vi("vf", shape=[2, 3])])


def test_loop_gradient_flows(dev):
    """y = v0 + 3·x through an unrolled Loop: dy/dx = 3."""
    rep = sonnx.prepare(_loop_model(), dev)
    x = _t(np.ones((2, 3), np.float32), dev).requires_grad_(True)
    (vf,) = rep.run({"M": np.asarray(3, np.int64), "keep": np.asarray(True),
                     "v0": np.zeros((2, 3), np.float32), "x": x})
    np.testing.assert_allclose(_np(vf), 3.0 * np.ones((2, 3)))
    grads = autograd.gradients(autograd.reduce_mean(vf))
    np.testing.assert_allclose(_np(grads[x]), np.full((2, 3), 3.0 / 6.0))


def test_data_dependent_ops_refuse_capture(dev, monkeypatch):
    """Under a CUDA-graph capture (simulated here: the CPU has none) a
    host read of a computed value, a NonZero and an If on a computed
    condition raise a RuntimeError naming the node; constants keep
    working from their host copies."""
    monkeypatch.setattr(sonnx, "_capturing", lambda t: True)
    g = _if_model(_branch("t", "Add", 1.0), _branch("e", "Add", -1.0))
    with pytest.raises(RuntimeError, match="'if0' \\(If\\)"):
        sonnx.prepare(g, dev).run({"cond": _t(np.asarray(True), dev),
                                   "x": np.ones((2, 3), np.float32)})
    nz = _graph_model([onnx_pb.NodeProto(op_type="NonZero", name="nz",
                                         input=["x"], output=["y"])], [],
                      [_vi("x", shape=[4])], [_vi("y")])
    with pytest.raises(RuntimeError, match="'nz' \\(NonZero\\)"):
        sonnx.prepare(nz, dev).run([_t(np.ones(4, np.float32), dev)])
    # Reshape's shape comes from an initializer's host copy: no read
    rs = _graph_model(
        [onnx_pb.NodeProto(op_type="Reshape", name="r",
                           input=["x", "shp"], output=["y"])],
        [onnx_pb.TensorProto.from_numpy(np.asarray([3, 2], np.int64),
                                        "shp")],
        [_vi("x", shape=[2, 3])], [_vi("y")])
    (y,) = sonnx.prepare(rs, dev).run([_t(np.ones((2, 3), np.float32),
                                          dev)])
    assert tuple(y.shape) == (3, 2)


def _scan_model(reverse=False):
    body = onnx_pb.GraphProto(
        name="body", input=[_vi("s_in"), _vi("x_t")],
        node=[onnx_pb.NodeProto(op_type="Add", input=["s_in", "x_t"],
                                output=["s_out"]),
              onnx_pb.NodeProto(op_type="Identity", input=["s_out"],
                                output=["y_t"])],
        output=[_vi("s_out"), _vi("y_t")])
    attrs = [onnx_pb.AttributeProto.make("body", body),
             onnx_pb.AttributeProto.make("num_scan_inputs", 1)]
    if reverse:
        attrs += [onnx_pb.AttributeProto.make("scan_input_directions", [1]),
                  onnx_pb.AttributeProto.make("scan_output_directions",
                                              [1])]
    scan = onnx_pb.NodeProto(op_type="Scan", input=["s0", "x"],
                             output=["s_final", "ys"], attribute=attrs)
    return _graph_model([scan], [], [_vi("s0"), _vi("x")],
                        [_vi("s_final"), _vi("ys")])


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_cumsum(dev, reverse):
    rep = sonnx.prepare(_scan_model(reverse), dev)
    x = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    s_final, ys = rep.run([np.zeros((3,), np.float32), x])
    want = np.cumsum(x[::-1], 0)[::-1] if reverse else np.cumsum(x, 0)
    np.testing.assert_allclose(_np(ys), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(s_final), x.sum(0), rtol=1e-5, atol=1e-6)


def test_scan_differentiable(dev):
    rep = sonnx.prepare(_scan_model(), dev)
    x = _t(np.random.RandomState(2).randn(5, 3).astype(np.float32),
           dev).requires_grad_(True)
    _, ys = rep.run([np.zeros((3,), np.float32), x])
    grads = autograd.gradients(autograd.reduce_sum(autograd.mul(ys, ys)))
    assert x in grads and grads[x].shape == x.shape


# --------------------------------------------------------- the RNN family


def test_onnx_lstm_bidirectional_and_gru_lbr0(dev):
    """Bidirectional LSTM against torch's golden; the ONNX-default GRU
    (linear_before_reset=0, its own loop) against a numpy recurrence and
    the JAX package."""
    from test_torch_onnx_conformance import run_both

    inputs, attrs, inits, golden = jc._rnn_case("LSTM", bidirectional=True)
    jouts, touts = run_both("LSTM", inputs, attrs, 3, inits)
    for got, want, j in zip(touts, golden, jouts):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got, j, rtol=RTOL, atol=ATOL)
    rng = np.random.RandomState(11)
    T, B, I, H = 3, 2, 4, 5
    x = rng.randn(T, B, I).astype(np.float32)
    W = rng.randn(1, 3 * H, I).astype(np.float32) * 0.4
    R = rng.randn(1, 3 * H, H).astype(np.float32) * 0.4
    Bb = rng.randn(1, 6 * H).astype(np.float32) * 0.4
    sig = lambda v: 1 / (1 + np.exp(-v))  # noqa: E731
    wz, wr, wn = np.split(W[0], 3)
    rz, rr, rn = np.split(R[0], 3)
    wbz, wbr, wbn, rbz, rbr, rbn = np.split(Bb[0], 6)
    h = np.zeros((B, H), np.float32)
    ys = []
    for t in range(T):
        z = sig(x[t] @ wz.T + wbz + h @ rz.T + rbz)
        r = sig(x[t] @ wr.T + wbr + h @ rr.T + rbr)
        n = np.tanh(x[t] @ wn.T + wbn + (r * h) @ rn.T + rbn)
        h = (1 - z) * n + z * h
        ys.append(h.copy())
    Y = np.stack(ys)[:, None]
    jouts, touts = run_both(
        "GRU", {"x": x}, {"hidden_size": H, "linear_before_reset": 0}, 2,
        (jc._init(W, "W"), jc._init(R, "R"), jc._init(Bb, "B")))
    np.testing.assert_allclose(touts[0], Y, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(touts[1], Y[-1], rtol=2e-4, atol=1e-5)
    for got, j in zip(touts, jouts):
        np.testing.assert_allclose(got, j, rtol=RTOL, atol=ATOL)


def test_onnx_rnn_reverse_direction(dev):
    from test_torch_onnx_conformance import run_both

    rng = np.random.RandomState(5)
    T, B, I, H = 4, 2, 3, 4
    x = rng.randn(T, B, I).astype(np.float32)
    W = rng.randn(1, H, I).astype(np.float32) * 0.5
    R = rng.randn(1, H, H).astype(np.float32) * 0.5
    h = np.zeros((B, H), np.float32)
    ys = [None] * T
    for t in reversed(range(T)):
        h = np.tanh(x[t] @ W[0].T + h @ R[0].T)
        ys[t] = h.copy()
    jouts, touts = run_both("RNN", {"x": x},
                            {"hidden_size": H, "direction": "reverse"}, 2,
                            (jc._init(W, "W"), jc._init(R, "R")))
    np.testing.assert_allclose(touts[0], np.stack(ys)[:, None], rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(touts[1], h[None], rtol=2e-4, atol=1e-5)
    for got, j in zip(touts, jouts):
        np.testing.assert_allclose(got, j, rtol=RTOL, atol=ATOL)


class _RNNNet(model.Model):
    def __init__(self, cls, bidir):
        super().__init__()
        self.rnn = cls(8, bidirectional=bidir, num_layers=2)
        self.fc = layer.Linear(5)

    def forward(self, x):
        y, _ = self.rnn(x)
        return self.fc(y)


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("kind", ["LSTM", "GRU", "RNN"])
def test_rnn_family_export_import_roundtrip(dev, kind, bidir):
    """Each recorded layer-direction scan exports as one ONNX node, its
    W/R/B unpacked from the packed weight; 2 layers."""
    m = _RNNNet(getattr(layer, kind), bidir)
    x = _t(np.random.RandomState(0).randn(6, 3, 4).astype(np.float32), dev)
    m.compile([x], is_train=False)
    m.eval()
    proto = sonnx.to_onnx(m, [x])
    assert sum(n.op_type == kind for n in proto.graph.node) == \
        2 * (2 if bidir else 1)
    (got,) = sonnx.prepare(proto, dev).run([x])
    np.testing.assert_allclose(_np(got), _np(m.forward(x)), rtol=2e-4,
                               atol=1e-5)


def test_char_rnn_export_matches_jax(dev):
    """CharRNN (the char-RNN configuration's model, batch-first LSTM
    stack) exports to the same bytes in both packages, and each imports
    the other's file."""
    from singa_tpu.models.char_rnn import CharRNN as JCharRNN

    ids = np.random.RandomState(0).randint(0, 20, (3, 7))
    x_np = one_hot(ids, 20)
    jm = JCharRNN(20, hidden_size=8, num_layers=2, seq_length=7)
    tm = CharRNN(20, hidden_size=8, num_layers=2, seq_length=7)
    jx, tx = _pair(jm, tm, x_np, dev)
    jm.eval()
    tm.eval()
    native = _np(tm.forward(tx))
    tblob = sonnx.to_onnx(tm, [tx]).serialize()
    jblob = jsonnx.to_onnx(jm, [jx]).serialize()
    assert collections.Counter(
        n.op_type for n in onnx_pb.load_model(tblob).graph.node)["LSTM"] == 2
    (got,) = sonnx.prepare(jblob, dev).run([x_np])
    np.testing.assert_allclose(_np(got), native, rtol=2e-4, atol=1e-5)
    jgot = jtensor.to_numpy(jsonnx.prepare(tblob).run([x_np])[0])
    np.testing.assert_allclose(jgot, native, rtol=2e-4, atol=1e-5)


def test_rnn_export_wires_user_initial_state(dev):
    """h0/c0 given as model inputs are wired into the exported LSTM node
    (Slice of the graph input), not baked; the packed flat weight is not
    among the initializers."""
    class Net(model.Model):
        def __init__(self):
            super().__init__()
            self.rnn = layer.LSTM(8, num_layers=1)

        def forward(self, x, h0, c0):
            y, _ = self.rnn(x, h0, c0)
            return y

    m = Net()
    rng = np.random.RandomState(0)
    x, h0, c0 = (_t(rng.randn(*s).astype(np.float32), dev)
                 for s in ((5, 2, 4), (1, 2, 8), (1, 2, 8)))
    m.compile([x, h0, c0], is_train=False)
    m.eval()
    proto = sonnx.to_onnx(m, [x, h0, c0])
    assert not any(len(i.dims) == 1
                   and int(np.prod(i.dims)) == m.rnn.handle.weights_size
                   for i in proto.graph.initializer)
    rep = sonnx.prepare(proto, dev)
    h2 = _t(np.zeros((1, 2, 8), np.float32), dev)
    for h in (h0, h2):
        np.testing.assert_allclose(_np(rep.run([x, h, c0])[0]),
                                   _np(m.forward(x, h, c0)), rtol=2e-4,
                                   atol=1e-5)


def test_imported_lstm_reexports(dev):
    """An externally shaped ONNX LSTM imports, wraps in SONNXModel,
    re-exports (the packed weight unpacks back to W/R/B, no Gather or
    Concat packing subgraph) and re-imports, matching torch's golden."""
    inputs, attrs, inits, golden = jc._rnn_case("LSTM")
    node = onnx_pb.NodeProto(op_type="LSTM", name="n0",
                             input=list(inputs) + [t.name for t in inits],
                             output=["Y", "Yh", "Yc"])
    for k, v in attrs.items():
        node.attribute.append(onnx_pb.AttributeProto.make(k, v))
    jproto = jc.ModelProto(graph=jc.GraphProto(
        name="g", node=[], initializer=list(inits),
        input=[jc.ValueInfoProto(name=k, elem_type=jc.onnx_pb.FLOAT,
                                 shape=list(np.asarray(v).shape))
               for k, v in inputs.items()],
        output=[jc.ValueInfoProto(name="Y", elem_type=jc.onnx_pb.FLOAT,
                                  shape=[])]))
    proto = onnx_pb.load_model(jproto.serialize())
    proto.graph.node.append(node)
    x = _t(inputs["x"], dev)
    m2 = sonnx.SONNXModel(proto, dev)
    m2.compile([x], is_train=False)
    m2.eval()
    native = _np(m2.forward(x))
    proto2 = sonnx.to_onnx(m2, [x])
    assert any(n.op_type == "LSTM" for n in proto2.graph.node)
    assert not any(n.op_type in ("Gather", "Concat")
                   for n in proto2.graph.node)
    (y2,) = sonnx.prepare(proto2, dev).run([x])
    np.testing.assert_allclose(_np(y2), native, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(_np(y2), golden[0], rtol=2e-4, atol=1e-5)


def test_trilu_runtime_diagonal_k(dev):
    """Trilu whose k is a graph input: the mask compares on the device,
    and each k gives its triangle."""
    node = onnx_pb.NodeProto(op_type="Trilu", name="tri", input=["x", "k"],
                             output=["y"], attribute=[
                                 onnx_pb.AttributeProto.make("upper", 1)])
    rep = sonnx.prepare(_graph_model(
        [node], [], [_vi("x", shape=[4, 4]), _vi("k", onnx_pb.INT64, [1])],
        [_vi("y", shape=[4, 4])]), dev)
    x_np = np.random.RandomState(0).randn(4, 4).astype(np.float32)
    for k in (0, 1, -1, 2):
        (y,) = rep.run({"x": _t(x_np, dev),
                        "k": _t(np.asarray([k], np.int64), dev)})
        np.testing.assert_allclose(_np(y), np.triu(x_np, k), rtol=1e-6)


# ------------------------------------------------- what the export refuses


class _Planted(model.Model):
    """Linear -> an input-derived value made by an unrecorded torch op ->
    Linear."""

    def __init__(self, planted):
        super().__init__()
        self.fc1 = layer.Linear(8)
        self.fc2 = layer.Linear(3)
        self.planted = planted

    def forward(self, x):
        h = self.fc1(x)
        if self.planted == "clamp":
            h = torch.clamp(h, min=0.0)
        elif self.planted == "inplace":
            h = h.clone()
            h.mul_(2.0)
        elif self.planted == "param":
            return autograd.add(self.fc2(h), torch.neg(self.fc2.b))
        elif self.planted == "output":
            return torch.relu(self.fc2(h))
        return self.fc2(h)


@pytest.mark.parametrize("planted,fn", [
    ("clamp", "torch.clamp"), ("inplace", "torch.Tensor.mul_"),
    ("param", "torch.neg"), ("output", "torch.relu")])
def test_unrecorded_op_refused(dev, planted, fn):
    """An input- or parameter-derived tensor that no op recorded would be
    baked as a constant (a silently wrong graph): the export raises
    NotImplementedError naming the torch function instead."""
    m = _Planted(planted)
    x = _t(np.random.RandomState(0).randn(4, 6).astype(np.float32), dev)
    m.compile([x], is_train=False)
    with pytest.raises(NotImplementedError, match=fn.replace(".", r"\.")):
        sonnx.to_onnx(m, [x])


def test_shape_only_leaf_is_baked(dev):
    """A leaf no input flows into (zeros_like, arange from a shape) is a
    constant: the export bakes it, as BERT's position ids."""
    class M(model.Model):
        def __init__(self):
            super().__init__()
            self.fc = layer.Linear(3)

        def forward(self, x):
            bias = torch.ones_like(x) + torch.arange(x.shape[1])
            return self.fc(autograd.add(x, bias))

    m = M()
    x = _t(np.random.RandomState(0).randn(4, 6).astype(np.float32), dev)
    m.compile([x], is_train=False)
    proto = sonnx.to_onnx(m, [x])
    assert sum(i.name.startswith("const_") for i in proto.graph.initializer) \
        == 1
    (y,) = sonnx.prepare(proto, dev).run([x])
    np.testing.assert_allclose(_np(y), _np(m.forward(x)), rtol=RTOL,
                               atol=ATOL)


def test_export_record_costs_nothing_outside_export(dev):
    """Outside an export no op is recorded and the flag is off; the
    record's marks end with it."""
    assert not autograd.exporting and autograd._record is None
    x = _t(np.ones((2, 3), np.float32), dev)
    assert autograd.relu(x) is not None and autograd._record is None
    with autograd.ExportRecord(roots=[x]) as rec:
        y = autograd.relu(x)
        assert autograd.exporting
    assert not autograd.exporting and autograd._record is None
    assert [op.name for op in rec.ops] == ["ReLU"]
    assert rec.producer[id(y)].src[0][2] is x


def test_export_restores_mode_and_amp(dev):
    """to_onnx records in training mode with float32 compute and puts
    both back; batch norm's running statistics are left as they were."""
    from singa_tpu_torch import amp

    class M(model.Model):
        def __init__(self):
            super().__init__()
            self.conv = layer.Conv2d(4, 3, padding=1)
            self.bn = layer.BatchNorm2d()
            self.drop = layer.Dropout(0.5)

        def forward(self, x):
            return self.drop(self.bn(self.conv(x)))

    m = M()
    x = _t(np.random.RandomState(0).randn(2, 3, 5, 5).astype(np.float32),
           dev)
    m.compile([x], is_train=False)
    m.eval()
    before = {k: _np(v).copy() for k, v in m.get_states().items()}
    amp.enable()
    try:
        proto = sonnx.to_onnx(m, [x])
        assert amp._compute_dtype is torch.bfloat16
    finally:
        amp.enable(False)
    assert not m.training
    for k, v in m.get_states().items():
        np.testing.assert_array_equal(_np(v), before[k], err_msg=k)
    assert [n.op_type for n in proto.graph.node
            if n.op_type != "Constant"] == \
        ["Conv", "BatchNormalization", "Dropout"]
    assert all(i.data_type == onnx_pb.FLOAT for i in proto.graph.initializer)


def test_imported_bn_model_trains_in_graph_mode(dev):
    """Imported BatchNormalization statistics are state: training moves
    them, eval reads them, and they ride get_states but not get_params."""
    class Net(model.Model):
        def __init__(self):
            super().__init__()
            self.conv = layer.Conv2d(4, 3, padding=1)
            self.bn = layer.BatchNorm2d()
            self.flat = layer.Flatten()
            self.fc = layer.Linear(5)

        def forward(self, x):
            return self.fc(self.flat(autograd.relu(self.bn(self.conv(x)))))

    m = Net()
    rng = np.random.RandomState(0)
    x = _t(rng.randn(4, 3, 6, 6).astype(np.float32), dev)
    y = _t(rng.randint(0, 5, (4,)).astype(np.int64), dev)
    m.compile([x], is_train=False)
    tm = _Trainable(sonnx.to_onnx(m, [x]), dev)
    tm.compile([x], is_train=True, use_graph=True)
    tm.set_optimizer(opt.SGD(lr=1e-2, momentum=0.9))
    bn_states = [k for k in tm.get_states() if k not in tm.get_params()]
    assert sorted(bn_states) == ["Net.bn.running_mean", "Net.bn.running_var"]
    before = {k: _np(tm.get_states()[k]).copy() for k in bn_states}
    losses = [float(tm(x, y)[1].detach()) for _ in range(4)]
    assert losses[-1] < losses[0], losses
    assert all(not np.array_equal(_np(tm.get_states()[k]), before[k])
               for k in bn_states)
    tm.eval()
    out0 = _np(tm.forward(x))
    tm.set_states({k: _np(v) + (5.0 if k in bn_states else 0.0)
                   for k, v in tm.get_states().items()})
    assert not np.allclose(out0, _np(tm.forward(x)))


@pytest.mark.slow
@pytest.mark.parametrize("module,factory,kw,shape", [
    ("resnet", "resnet18", dict(num_classes=10), (2, 3, 32, 32)),
    ("mobilenet", "mobilenet_v2", dict(num_classes=10, width_mult=0.25),
     (2, 3, 32, 32)),
    ("vgg", "vgg11", dict(num_classes=10), (2, 3, 32, 32)),
    ("alexnet", "create_model", dict(num_classes=10), (2, 3, 224, 224)),
    ("xceptionnet", "create_model", dict(num_classes=10), (2, 3, 71, 71)),
    ("unet", "UNet", dict(num_classes=2, base_channels=4, depth=2),
     (2, 3, 32, 32)),
], ids=lambda v: v if isinstance(v, str) else None)
def test_zoo_exports_match_jax(dev, module, factory, kw, shape):
    """The CNN zoo (batch norm, residual adds, pooling, ReLU6, transposed
    convs, channel concatenation) exports the same graph in both packages
    from the same weights, and the import runs the native forward
    (~15-30 s a model, most of it JAX's eager compiles)."""
    import importlib

    from test_torch_sonnx_transformers import _canonical

    jm = getattr(importlib.import_module(f"singa_tpu.models.{module}"),
                 factory)(**kw)
    tm = getattr(importlib.import_module(
        f"singa_tpu_torch.models.{module}"), factory)(**kw)
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jx, tx = _pair(jm, tm, x, dev)
    jm.eval()
    tm.eval()
    tblob = sonnx.to_onnx(tm, [tx]).serialize()
    assert _canonical(tblob) == _canonical(jsonnx.to_onnx(jm, [jx])
                                           .serialize())
    (out,) = sonnx.prepare(tblob, dev).run([x])
    np.testing.assert_allclose(_np(out), _np(tm.forward(tx)), rtol=RTOL,
                               atol=ATOL)
