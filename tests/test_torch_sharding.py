"""The port's mesh and sharding plan (``singa_tpu_torch/parallel/
sharding.py``) against the JAX package's on the conftest's 8-device
virtual CPU mesh: rank -> coordinates in the order ``jax.sharding.Mesh``
lays out ``jax.devices()``; ``spec_for_state``, ``spec_for_input`` and
``act_spec`` on the same names and shapes; every rank's slice of a global
array equal to that rank's shard of ``jax.device_put(x, NamedSharding)``;
and an undivided dimension raising ``ValueError`` naming the tensor and
the axis.  No process group is needed: a ``Mesh`` built for a rank
computes that rank's coordinates and slices.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding

from singa_tpu import tensor as jtensor
from singa_tpu.parallel import sharding as jshd

from singa_tpu_torch.parallel import sharding as shd

MESHES = [(2, 2, 2, 1, 1), (1, 4, 1, 2, 1), (2, 1, 4, 1, 1),
          (1, 1, 1, 4, 2), (8, 1, 1, 1, 1)]


def _jax_ranks(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("sizes", MESHES, ids=str)
def test_rank_coordinates_equal_the_jax_mesh_order(sizes):
    jm = jshd.create_mesh(*sizes)
    want = _jax_ranks(jm)
    assert jm.axis_names == shd.AXES
    for r in range(int(np.prod(sizes))):
        m = shd.Mesh(sizes, rank=r, device="cpu")
        np.testing.assert_array_equal(m.ranks, want)
        idx = tuple(int(i) for i in np.argwhere(want == r)[0])
        assert tuple(m.coords[a] for a in shd.AXES) == idx
        assert m.shape == dict(jm.shape)


def test_serve_meshes_equal_the_jax_meshes():
    for port, jax_mesh in (
            (shd.Mesh((4,), (shd.TP,), rank=0, device="cpu"),
             jshd.create_tp_mesh(4)),
            (shd.Mesh((2, 2), (shd.EP, shd.TP), rank=0, device="cpu"),
             jshd.create_ep_mesh(2, tp=2)),
            (shd.Mesh((4,), (shd.PP,), rank=0, device="cpu"),
             jshd.create_pp_mesh(4))):
        assert port.axis_names == tuple(jax_mesh.axis_names)
        np.testing.assert_array_equal(port.ranks, _jax_ranks(jax_mesh))
    # one process: meshes of one rank need no process group
    for m in (shd.create_mesh(device="cpu"), shd.create_tp_mesh(1, "cpu"),
              shd.create_ep_mesh(1, device="cpu"),
              shd.create_pp_mesh(1, "cpu")):
        assert m.size == 1 and m.group(m.axis_names[0]) is None
    for bad in (lambda: shd.create_mesh(dp=16, tp=16, device="cpu"),
                lambda: shd.create_tp_mesh(0), lambda: shd.create_pp_mesh(2),
                lambda: shd.create_ep_mesh(2, tp=0)):
        with pytest.raises(ValueError):
            bad()


def _same(a, b):
    return tuple(a) == tuple(b)


@pytest.mark.parametrize("sizes", MESHES[:3], ids=str)
def test_plan_specs_equal_the_jax_plan(sizes):
    rules = [(r"\.ln\d\.", (None,)), (r"fc1\.W$", (None, "model"))]
    port = shd.ShardingPlan(shd.Mesh(sizes, rank=0, device="cpu"),
                            rules=[(p, shd.P(*s)) for p, s in rules])
    jax_plan = jshd.ShardingPlan(jshd.create_mesh(*sizes),
                                 rules=[(p, jshd.P(*s)) for p, s in rules])
    assert port.axis_size("model") == jax_plan.axis_size("model")
    assert port.world == jax_plan.world
    own = torch.zeros(4, 8)
    own.partition_spec = shd.P(None, "model")
    jown = jtensor.Tensor((4, 8))
    jown.partition_spec = jshd.P(None, "model")
    names = ["M.blocks0.ln1.scale", "M.blocks0.mlp.fc1.W", "M.head.b",
             "__opt__M.blocks0.mlp.fc1.W:momentum", "__opt__M.w:momentum"]
    pspecs = {"M.w": shd.P("model", None)}
    jspecs = {"M.w": jshd.P("model", None)}
    for n in names:
        t, jt = torch.zeros(4, 8), jtensor.Tensor((4, 8))
        assert _same(port.spec_for_state(n, t, pspecs),
                     jax_plan.spec_for_state(n, jt, jspecs)), n
        assert _same(port.spec_for_state(n, own),
                     jax_plan.spec_for_state(n, jown)), n
    for shape in [(), (8,), (8, 16), (6, 16), (8, 12, 3), (3, 5)]:
        a = np.zeros(shape, np.float32)
        for i in range(2):
            assert _same(port.spec_for_input(a, i),
                         jax_plan.spec_for_input(a, i)), shape
    for ndim in (2, 3, 4):
        for model_last in (False, True):
            for seq_dim in (1, 2):
                assert _same(port.act_spec(ndim, model_last, seq_dim),
                             jax_plan.act_spec(ndim, model_last, seq_dim))
    explicit = [shd.P("data"), shd.P()]
    port2 = shd.ShardingPlan(port.mesh, input_specs=explicit)
    assert port2.spec_for_input(np.zeros((3, 3)), 0) == shd.P("data")


SLICE_CASES = [
    ((2, 2, 2, 1, 1), (8, 6, 4), ("data", None, "model")),
    ((2, 2, 2, 1, 1), (8, 6), (("data", "model"), None)),
    ((2, 2, 2, 1, 1), (4, 8, 2), (None, ("seq", "data"), "model")),
    ((1, 4, 1, 2, 1), (8, 4), ("pipe", "model")),
    ((1, 1, 1, 4, 2), (8, 2, 3), ("pipe", "expert")),
    ((2, 1, 4, 1, 1), (2, 8), ()),
]


@pytest.mark.parametrize("sizes,shape,spec", SLICE_CASES, ids=str)
def test_slices_equal_the_jax_shards(sizes, shape, spec):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    jm = jshd.create_mesh(*sizes)
    arr = jax.device_put(x, NamedSharding(jm, jshd.P(*spec)))
    shards = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
    assert len(shards) == np.prod(sizes)
    for r, want in shards.items():
        m = shd.Mesh(sizes, rank=r, device="cpu")
        got = shd.shard_array(x, m, shd.P(*spec))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"rank {r}")
        assert shd.global_shape(got.shape, m, shd.P(*spec)) == shape


def test_undivided_dimension_raises_naming_tensor_and_axis():
    m = shd.Mesh((1, 2, 1, 1, 1), rank=1, device="cpu")
    with pytest.raises(ValueError, match=r"wte\.W: dimension 0 of size "
                                         r"50257 .* model of size 2"):
        shd.shard_array(np.zeros((50257, 4), np.float32), m,
                        shd.P("model", None), name="GPT2LMHead.wte.W")
    with pytest.raises(ValueError, match="data x model of size 4"):
        shd.shard_array(np.zeros((6,)), shd.Mesh((2, 2, 1, 1, 1), rank=0,
                                                 device="cpu"),
                        shd.P(("data", "model")), name="x")
    # the JAX package fails in device_put on the same layout
    with pytest.raises(ValueError):
        jax.device_put(np.zeros((50257, 4), np.float32),
                       NamedSharding(jshd.create_mesh(tp=2),
                                     jshd.P("model", None)))


def test_world_one_gather_and_constrain_are_identities():
    m = shd.create_mesh(device="cpu")
    plan = shd.ShardingPlan(m)
    x = torch.arange(12.0).reshape(3, 4)
    assert shd.gather_array(x, m, shd.P("model", None)) is x
    assert plan.gather(x, shd.P()) is x
    assert shd.constrain(x, plan, plan.act_spec(2)) is x
    assert not shd.plan_active()
    with shd._PlanActive():
        assert shd.plan_active()
    assert plan.seq_offset(16) == 0
    assert repr(shd.P("data", None)) == "P('data', None)"
