"""The port's ONNX codec (``singa_tpu_torch/io/onnx_pb.py``) against the
JAX package's: the same ``ModelProto`` built with each serializes to the
same bytes, each parses the other's bytes back to the same model, and
the repo's foreign fixtures (bytes written by an independent encoder)
re-serialize identically through both."""

import os

import numpy as np
import pytest

from singa_tpu.io import onnx_pb as jpb
from singa_tpu_torch.io import onnx_pb as tpb

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
ARRAYS = {
    "float32": np.arange(12, dtype=np.float32).reshape(3, 4),
    "float64": np.linspace(-1, 1, 5),
    "float16": np.asarray([0.5, -2.0, 65504.0], np.float16),
    "int64": np.asarray([[1, -2], [3, 2**40]], np.int64),
    "int32": np.asarray([7, -8, 9], np.int32),
    "int8": np.asarray([-128, 0, 127], np.int8),
    "uint8": np.asarray([0, 255], np.uint8),
    "bool": np.asarray([[True, False]]),
    "scalar": np.asarray(3.0, np.float32),
    "empty": np.zeros((0, 3), np.float32),
}


def _model(pb):
    """One model touching every message, attribute kind and tensor type
    the codec knows, built with codec ``pb``."""
    body = pb.GraphProto(
        name="body",
        node=[pb.NodeProto(op_type="Identity", name="b0", input=["a"],
                           output=["b"])],
        input=[pb.ValueInfoProto("a", pb.FLOAT, [2, 3])],
        output=[pb.ValueInfoProto("b", pb.FLOAT, [2, 3])])
    attrs = [pb.AttributeProto.make("alpha", 2.5),
             pb.AttributeProto.make("transB", 1),
             pb.AttributeProto.make("flag", True),
             pb.AttributeProto.make("pads", [1, 2, 1, 2]),
             pb.AttributeProto.make("scales", [1.0, 0.5]),
             pb.AttributeProto.make("mode", "test"),
             pb.AttributeProto.make("acts", ["Tanh", "Relu"]),
             pb.AttributeProto.make("value", pb.TensorProto.from_numpy(
                 ARRAYS["int64"], "v")),
             pb.AttributeProto.make("body", body)]
    inits = [pb.TensorProto.from_numpy(a, k) for k, a in ARRAYS.items()]
    node = pb.NodeProto(op_type="Gemm", name="g0", input=["x", "w", ""],
                        output=["y"], attribute=attrs)
    g = pb.GraphProto(
        name="g", node=[node], initializer=inits,
        input=[pb.ValueInfoProto("x", pb.FLOAT, [2, 3]),
               pb.ValueInfoProto("ids", pb.INT64, [-1, 7])],
        output=[pb.ValueInfoProto("y", pb.FLOAT, [2, 4])])
    return pb.ModelProto(graph=g)


def test_same_model_same_bytes():
    assert tpb.ModelProto.serialize(_model(tpb)) == \
        jpb.ModelProto.serialize(_model(jpb))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_parse_and_reserialize_across_codecs(direction):
    src, dst = (jpb, tpb) if direction == "jax_to_port" else (tpb, jpb)
    blob = _model(src).serialize()
    again = dst.load_model(blob)
    assert again.serialize() == blob


def test_roundtrip_values():
    m2 = tpb.ModelProto.parse(_model(tpb).serialize())
    assert m2.producer_name == "singa_tpu"
    n = m2.graph.node[0]
    assert n.op_type == "Gemm" and n.input == ["x", "w", ""]
    a = n.attrs()
    assert a["alpha"] == pytest.approx(2.5) and a["transB"] == 1
    assert a["flag"] == 1 and a["pads"] == [1, 2, 1, 2]
    assert a["scales"] == pytest.approx([1.0, 0.5])
    assert a["mode"] == "test" and a["acts"] == ["Tanh", "Relu"]
    np.testing.assert_array_equal(a["value"].to_numpy(), ARRAYS["int64"])
    assert a["body"].node[0].op_type == "Identity"
    assert m2.graph.input[1].shape == [-1, 7]
    for init in m2.graph.initializer:
        want = ARRAYS[init.name]
        got = init.to_numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["gemm", "ct_lstm", "trilu_scatternd"])
def test_foreign_fixture_bytes(name):
    """A file another encoder wrote parses to the same model in both
    codecs (the same bytes when each writes it back)."""
    with open(os.path.join(FIXTURES, f"foreign_{name}.onnx"), "rb") as f:
        blob = f.read()
    t, j = tpb.load_model(blob), jpb.load_model(blob)
    assert t.producer_name == "foreign_tool"
    assert t.serialize() == j.serialize()
    assert [n.op_type for n in t.graph.node] == \
        [n.op_type for n in j.graph.node]


def test_save_and_load_file(tmp_path):
    path = str(tmp_path / "m.onnx")
    tpb.save_model(_model(tpb), path)
    assert tpb.load_model(path).serialize() == \
        jpb.load_model(path).serialize() == _model(jpb).serialize()


def test_codec_imports_nothing_of_the_jax_package():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(tpb))
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert mods <= {"__future__", "struct", "dataclasses", "numpy"}, mods
