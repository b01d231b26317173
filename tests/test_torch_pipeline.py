"""GPipe on the port (``singa_tpu_torch/parallel/pipeline.py``) against the
JAX package's ``gpipe_spmd`` and its serial layer stack.

One W = 4 gloo group on the CPU (``tests/torch_dist_worker.py`` with
``tests/torch_shard_scenarios.py``) runs every case: ``gpipe_spmd`` at
pp = 4 and at pp = 2 (a (data 2, pipe 2) mesh) on an 8-layer tanh stack,
its output and the gradients of ``sum(y · w)`` against the JAX
``gpipe_spmd`` under ``shard_map`` (float32 atol 1e-5); and
``tests/test_pipeline.py``'s ``PipeLM`` at pp = 4 and at (dp 2, pp 2),
two SGD steps from the JAX package's zip against the JAX serial stack
(which ``tests/test_pipeline.py`` holds equal to the JAX pipeline):
losses rtol 2e-4, states rtol 2e-3 / atol 2e-4, as there.  The JAX
``test_pipeline_validation`` errors and the batch checks raise here too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.parallel.pipeline import gpipe_spmd as jgpipe

import torch_shard_scenarios as scen
from singa_tpu_torch import opt
from singa_tpu_torch.parallel import sharding as shd
from singa_tpu_torch.parallel.pipeline import PipelinedTransformer
from test_pipeline import PipeLM as JPipeLM

WORLD = 4
#: (dp, tp, sp, pp) meshes of the W = 4 group
MESHES = {"pp4": (1, 1, 1, 4), "dp2_pp2": (2, 1, 1, 2)}
LAYERS, M, MB, D = 8, 4, 3, 5
B, S, STEPS = 8, 6, 2
SGD = dict(lr=0.1)


def _gpipe_data():
    rng = np.random.RandomState(0)
    return dict(W=(0.5 * rng.randn(LAYERS, D, D)).astype(np.float32),
                b=(0.1 * rng.randn(LAYERS, D)).astype(np.float32),
                x=rng.randn(M, MB, D).astype(np.float32),
                w=rng.randn(M, MB, D).astype(np.float32))


def _jax_gpipe(pp, d):
    mesh = Mesh(np.asarray(jax.devices()[:pp]), ("pipe",))

    def stage(p, h):
        def layer(h_, wb):
            return jnp.tanh(h_ @ wb[0] + wb[1]), None

        return jax.lax.scan(layer, h, (p["W"], p["b"]))[0]

    f = jax.shard_map(
        lambda w_, b_, x_: jgpipe(stage, {"W": w_, "b": b_}, x_, "pipe"),
        mesh=mesh, in_specs=(P("pipe"), P("pipe"), P()), out_specs=P(),
        check_vma=False)
    w = jnp.asarray(d["w"])

    def loss(wt, bt, x):
        y = f(wt, bt, x)
        return jnp.sum(y * w), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True))(
        jnp.asarray(d["W"]), jnp.asarray(d["b"]), jnp.asarray(d["x"]))
    return dict(y=np.asarray(y), dW=np.asarray(g[0]), db=np.asarray(g[1]),
                dx=np.asarray(g[2]))


def _serial(d):
    """The 8-layer stack on every microbatch in float64: the function the
    pipeline computes, and its gradients."""
    wt, bt, x = (torch.from_numpy(d[n]).double().requires_grad_()
                 for n in ("W", "b", "x"))
    h = x
    for i in range(LAYERS):
        h = torch.tanh(h @ wt[i] + bt[i])
    (h * torch.from_numpy(d["w"]).double()).sum().backward()
    return dict(y=h.detach().numpy(), dW=wt.grad.numpy(), db=bt.grad.numpy(),
                dx=x.grad.numpy())


def _batches():
    rng = np.random.RandomState(0)
    return (rng.randint(0, scen.P_VOCAB, (STEPS, B, S)).astype(np.int32),
            rng.randint(0, scen.P_VOCAB, (STEPS, B, S)).astype(np.int32))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    d = _gpipe_data()
    np.savez(tmp / "gpipe.npz", **d)
    xs, ys = _batches()
    np.savez(tmp / "lm.npz", xs=xs, ys=ys)
    jdev = jdevice.get_default_device()
    jdev.SetRandSeed(3)
    m = JPipeLM(plan=None)
    m.set_optimizer(jopt.SGD(**SGD))
    m.compile([jtensor.from_numpy(xs[0], jdev)], is_train=True,
              use_graph=True)
    m.save_states(str(tmp / "pipe_jax.zip"))
    scenarios = []
    for name, mesh in MESHES.items():
        scenarios.append(dict(kind="pipe", name=f"gpipe_{name}", mesh=mesh,
                              data=str(tmp / "gpipe.npz")))
        scenarios.append(dict(kind="train", name=f"lm_{name}", model="pipe",
                              mesh=mesh, sgd=SGD, steps=STEPS,
                              zip=str(tmp / "pipe_jax.zip"),
                              data=str(tmp / "lm.npz")))
    procs = scen.launch(tmp, WORLD, scenarios)
    try:
        jax_gpipe = {name: _jax_gpipe(mesh[3], d)
                     for name, mesh in MESHES.items()}
        losses = [float(jtensor.to_numpy(m(jtensor.from_numpy(xs[i], jdev),
                                           jtensor.from_numpy(ys[i],
                                                              jdev))[1]))
                  for i in range(STEPS)]
        states = {f"state/{k}": np.asarray(jtensor.to_numpy(v))
                  for k, v in m.get_states().items()}
    finally:
        scen.join(tmp, procs)
    out = dict(serial=_serial(d), jax_gpipe=jax_gpipe,
               losses=np.asarray(losses), states=states)
    for sc in scenarios:
        out[sc["name"]] = scen.load_ranks(tmp, sc["name"], WORLD)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gpipe_spmd_equals_the_jax_gpipe(group, mesh):
    """Every rank's output (the last stage's, broadcast) and gradients of
    the stacked W, b and of the input equal the JAX ``gpipe_spmd``'s and
    the serial stack's."""
    want = group["jax_gpipe"][mesh]
    serial = group["serial"]
    for r, got in enumerate(group[f"gpipe_{mesh}"]):
        np.testing.assert_allclose(got["y"], want["y"], rtol=0, atol=1e-5,
                                   err_msg=f"rank {r} y")
        for k in ("y", "dW", "db", "dx"):
            np.testing.assert_allclose(got[k], serial[k], rtol=0, atol=1e-5,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_pipelined_transformer_equals_the_serial_stack(group, mesh):
    """``PipeLM`` over the pipeline: two steps' losses and the gathered
    states (the stacked (L, ...) weights whole) equal the JAX serial
    stack's from the same zip."""
    for r, got in enumerate(group[f"lm_{mesh}"]):
        np.testing.assert_allclose(got["losses"], group["losses"],
                                   rtol=2e-4, err_msg=f"rank {r}")
        for k, v in group["states"].items():
            np.testing.assert_allclose(got[k], v, rtol=2e-3, atol=2e-4,
                                       err_msg=f"rank {r} {k}")


def test_pipeline_validation():
    """``tests/test_pipeline.py``'s error: layers the pipe axis does not
    divide; and a batch the microbatches (or their data split) do not
    divide."""
    plan = shd.ShardingPlan(shd.Mesh((1, 1, 1, 4, 1), rank=0, device="cpu"))
    with pytest.raises(ValueError, match="not divisible by pipe-axis"):
        PipelinedTransformer(3, scen.P_HEADS, scen.P_INTER, plan=plan)
    m = scen.PipeLM(plan, num_microbatches=4)
    m.set_optimizer(opt.SGD(lr=0.1))
    with pytest.raises(ValueError, match="num_microbatches"):
        m.compile([torch.zeros((6, S), dtype=torch.int32)],
                  is_train=False)
    plan2 = shd.ShardingPlan(shd.Mesh((2, 1, 1, 2, 1), rank=0,
                                      device="cpu"))
    m = scen.PipeLM(plan2, num_microbatches=4)
    m.set_sharding_plan(plan2)
    with pytest.raises(ValueError, match="data-axis"):
        m.compile([torch.zeros((12, S), dtype=torch.int32)],
                  is_train=False)
