"""Node-level ONNX conformance of the port's ``sonnx`` against the JAX
package's: every key of ``_ONNX_OPS`` and ``_CONTROL_FLOW_OPS`` runs as a
one-node graph through both packages' handlers on the same inputs.

The case table is ``tests/test_onnx_conformance.py``'s ``CASES``,
imported, not copied (pytest puts ``tests/`` on ``sys.path``).  Each
case's graph is built with the JAX codec, serialized once, and prepared
from those bytes by both packages, so the port's codec reads every
attribute kind (tensors, subgraphs, strings) as the JAX one wrote it.
The cases draw their inputs from that module's seeded ``RandomState``
when called; each test calls its case once and feeds both packages the
same arrays.

Tolerance: rtol 1e-4, atol 1e-5 between the packages, in float32; the
JAX test's own golden, where the case has one, at its tolerance (rtol
2e-4, atol 1e-5).  Index outputs are int32 in both packages (the JAX
package's documented divergence from ONNX's int64).
"""

import numpy as np
import pytest

import test_onnx_conformance as jc
from singa_tpu import sonnx as jsonnx
from singa_tpu import tensor as jtensor
from singa_tpu.io import onnx_pb as jpb
from singa_tpu_torch import device, sonnx, tensor

RTOL, ATOL = 1e-4, 1e-5
N_OUT = {"Split": 2, "Loop": 2, "Scan": 2, "TopK": 2, "LSTM": 3, "GRU": 2,
         "RNN": 2}
INDEX_OPS = ("ArgMax", "ArgMin", "TopK", "NonZero")


def _model_bytes(op_type, inputs, attrs, n_out, initializers):
    """The one-node graph of ``jc._run_node``, serialized."""
    node = jpb.NodeProto(op_type=op_type, name="n0",
                         input=list(inputs) + [t.name for t in initializers],
                         output=[f"out{i}" for i in range(n_out)])
    for k, v in (attrs or {}).items():
        node.attribute.append(jpb.AttributeProto.make(k, v))
    g = jpb.GraphProto(
        name="g", node=[node], initializer=list(initializers),
        input=[jpb.ValueInfoProto(name=k, elem_type=jpb.FLOAT,
                                  shape=list(np.asarray(v).shape))
               for k, v in inputs.items()]
        + [jpb.ValueInfoProto(name=t.name, elem_type=t.data_type,
                              shape=list(t.dims)) for t in initializers],
        output=[jpb.ValueInfoProto(name=f"out{i}", elem_type=jpb.FLOAT,
                                   shape=[]) for i in range(n_out)])
    return jpb.ModelProto(graph=g).serialize()


def run_both(op_type, inputs, attrs=None, n_out=1, initializers=()):
    """(JAX outputs, port outputs) of the one-node graph, as numpy."""
    blob = _model_bytes(op_type, inputs, attrs, n_out, initializers)
    feeds = [np.asarray(v) for v in inputs.values()]
    jouts = jsonnx.prepare(blob).run(feeds)
    touts = sonnx.prepare(blob, device.create_cpu_device()).run(feeds)
    return ([np.asarray(jtensor.to_numpy(o)) for o in jouts],
            [tensor.to_numpy(o) for o in touts])


def assert_same(jouts, touts, what):
    assert len(jouts) == len(touts), what
    for i, (j, t) in enumerate(zip(jouts, touts)):
        assert j.shape == t.shape, (what, i, j.shape, t.shape)
        np.testing.assert_allclose(t.astype(np.float32),
                                   j.astype(np.float32), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} output {i}")


def test_handler_tables_have_the_same_keys():
    assert set(sonnx._ONNX_OPS) == set(jsonnx._ONNX_OPS)
    assert tuple(sonnx._CONTROL_FLOW_OPS) == tuple(jsonnx._CONTROL_FLOW_OPS)
    assert set(sonnx._EXPORT_OPS) == set(jsonnx._EXPORT_OPS)
    assert set(sonnx._EXPORT_DECOMPOSE) == set(jsonnx._EXPORT_DECOMPOSE)


def test_case_table_covers_every_port_handler():
    supported = set(sonnx._ONNX_OPS) | set(sonnx._CONTROL_FLOW_OPS)
    assert not supported - set(jc.CASES)


@pytest.mark.parametrize("op", sorted(jc.CASES))
def test_handler_matches_jax(op):
    inputs, attrs, inits, golden = jc.CASES[op]()
    jouts, touts = run_both(op, inputs, attrs, n_out=N_OUT.get(op, 1),
                            initializers=inits)
    assert_same(jouts, touts, op)
    if op in INDEX_OPS:
        idx = touts[1] if op == "TopK" else touts[0]
        assert idx.dtype == np.int32, (op, idx.dtype)
    for got, want in zip(touts, golden or ()):
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32),
                                   rtol=2e-4, atol=1e-5, err_msg=op)


@pytest.mark.parametrize("mode", ["DCR", "CRD"])
@pytest.mark.parametrize("op", ["DepthToSpace", "SpaceToDepth"])
def test_depth_space_modes(op, mode):
    rng = np.random.RandomState(1)
    x = rng.randn(1, 8, 2, 4).astype(np.float32) if op == "DepthToSpace" \
        else rng.randn(1, 2, 4, 8).astype(np.float32)
    attrs = {"blocksize": 2}
    if op == "DepthToSpace":
        attrs["mode"] = mode
    assert_same(*run_both(op, {"x": x}, attrs), f"{op} {mode}")


@pytest.mark.parametrize("ctm,nearest,scales", [
    ("half_pixel", "round_prefer_floor", [1, 1, 2, 2]),
    ("half_pixel", "round_prefer_floor", [1, 1, 0.5, 0.75]),
    ("asymmetric", "floor", [1, 1, 1.5, 3]),
])
def test_resize_nearest_modes(ctm, nearest, scales):
    x = np.random.RandomState(2).randn(1, 2, 4, 5).astype(np.float32)
    inits = (jc._init(np.asarray([], np.float32), "roi"),
             jc._init(np.asarray(scales, np.float32), "scales"))
    assert_same(*run_both("Resize", {"x": x},
                          {"mode": "nearest",
                           "coordinate_transformation_mode": ctm,
                           "nearest_mode": nearest},
                          initializers=inits), f"Resize {ctm}")


@pytest.mark.parametrize("sizes", [[1, 2, 8, 10], [1, 2, 3, 2],
                                   [1, 2, 6, 5]])
def test_resize_linear_half_pixel(sizes):
    """Linear Resize: jax.image.resize (no antialias) against
    F.interpolate's half-pixel linear family."""
    x = np.random.RandomState(3).randn(1, 2, 4, 5).astype(np.float32)
    inits = (jc._init(np.asarray([], np.float32), "roi"),
             jc._init(np.asarray([], np.float32), "scales"),
             jc._init(np.asarray(sizes, np.int64), "sizes"))
    assert_same(*run_both("Resize", {"x": x}, {"mode": "linear"},
                          initializers=inits), f"Resize linear {sizes}")


def test_upsample_linear_asymmetric():
    x = np.random.RandomState(4).randn(1, 2, 3, 4).astype(np.float32)
    assert_same(*run_both("Upsample", {"x": x},
                          {"mode": "linear",
                           "scales": [1.0, 1.0, 2.0, 1.5]}),
                "Upsample linear")


def test_prelu_trailing_broadcast_wins_ambiguity():
    x = np.random.RandomState(5).randn(2, 3, 3).astype(np.float32)
    inits = (jc._init(np.asarray([0.1, 0.2, 0.3], np.float32), "slope"),)
    assert_same(*run_both("PRelu", {"x": x}, initializers=inits), "PRelu")


@pytest.mark.parametrize("neg,pos", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_isinf_flag_combinations(neg, pos):
    x = np.asarray([[np.inf, -np.inf, 1.0], [0.0, np.nan, -2.0]],
                   np.float32)
    assert_same(*run_both("IsInf", {"x": x},
                          {"detect_negative": neg, "detect_positive": pos}),
                "IsInf")


@pytest.mark.parametrize("op,x", [
    ("Round", np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5],
                         np.float32)),
    ("Mod", None), ("ModF", None),
])
def test_rounding_and_sign_semantics(op, x):
    """Round is half to even in both; Mod follows the divisor's sign
    (jnp.mod / torch.remainder), fmod the dividend's."""
    if op == "Round":
        assert_same(*run_both("Round", {"x": x}), "Round")
        return
    a = np.asarray([5.5, -5.5, 5.5, -5.5], np.float32)
    b = np.asarray([2.0, 2.0, -2.0, -2.0], np.float32)
    assert_same(*run_both("Mod", {"a": a, "b": b},
                          {"fmod": int(op == "ModF")}), op)


def test_topk_ties_keep_index_order():
    """lax.top_k keeps equal values in index order; so does the port's
    stable sort (torch.topk does not promise it)."""
    x = np.asarray([[1.0, 3.0, 3.0, 2.0, 3.0, 1.0]], np.float32)
    for largest in (1, 0):
        jouts, touts = run_both(
            "TopK", {"x": x}, {"axis": -1, "largest": largest}, n_out=2,
            initializers=(jc._init(np.asarray([4], np.int64), "k"),))
        assert_same(jouts, touts, f"TopK largest={largest}")
        np.testing.assert_array_equal(touts[1], jouts[1])


@pytest.mark.parametrize("reduction", ["none", "add", "mul", "max", "min"])
def test_scatter_reductions(reduction):
    rng = np.random.RandomState(6)
    x = rng.randn(4, 3).astype(np.float32)
    nd_inits = (jc._init(np.asarray([[0], [2]], np.int64), "idx"),
                jc._init(rng.randn(2, 3).astype(np.float32), "upd"))
    assert_same(*run_both("ScatterND", {"x": x}, {"reduction": reduction},
                          initializers=nd_inits), f"ScatterND {reduction}")
    el_inits = (jc._init(np.asarray([[0, 2], [1, 0]], np.int64), "idx"),
                jc._init(rng.randn(2, 2).astype(np.float32), "upd"))
    assert_same(*run_both("ScatterElements", {"x": x[:2].copy()},
                          {"axis": 1, "reduction": reduction},
                          initializers=el_inits),
                f"ScatterElements {reduction}")


def test_negative_step_slice_and_reflect_pad():
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    inits = (jc._init(np.asarray([3, -1], np.int64), "st"),
             jc._init(np.asarray([0, -7], np.int64), "en"),
             jc._init(np.asarray([0, 1], np.int64), "ax"),
             jc._init(np.asarray([-1, -2], np.int64), "sp"))
    assert_same(*run_both("Slice", {"x": x}, initializers=inits), "Slice")
    for mode in ("reflect", "edge"):
        inits = (jc._init(np.asarray([1, 2, 2, 1], np.int64), "pads"),)
        assert_same(*run_both("Pad", {"x": x}, {"mode": mode},
                              initializers=inits), f"Pad {mode}")
