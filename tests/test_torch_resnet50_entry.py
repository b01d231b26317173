"""ResNet-50's eval forward at ``__graft_entry__.entry()``'s shapes (batch
8 x 3 x 224 x 224, 1000 classes) in the port against the JAX package,
from one ``save_states`` zip.

The JAX model is built without running it (``compile`` under
``jax.eval_shape``), its states set from a numpy seed (convolution and fc
weights at their He / Glorot scales, BN scales, biases and running
statistics away from 1/0/0/1, so the eval path's folded statistics
matter), and saved with ``Model.save_states``; the port's model loads
that zip.  The same numpy image batch goes through the JAX forward
(jitted, as ``entry()`` hands it out) and the port's.  Tolerance: logits
atol 1e-4 x max(1, max |logit|), float32 through 16 bottleneck blocks
summed in other orders (XLA's and oneDNN's convolutions), as
tests/test_torch_resnet.py holds the eval logits at 64 x 64.  The test
takes ~20 s on the CPU (one XLA compile of the forward, two forwards of
8 x 224² images).
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from singa_tpu import device as jdevice
from singa_tpu import tensor as jtensor
from singa_tpu.models.resnet import resnet50 as jresnet50
from singa_tpu_torch import device
from singa_tpu_torch.models.resnet import resnet50

ENTRY_SHAPE = (8, 3, 224, 224)


def _jax_model():
    m = jresnet50(num_classes=1000)
    dev = jdevice.get_default_device()
    key = dev._rng_key
    try:
        jax.eval_shape(
            lambda a: m.compile([jtensor.Tensor(data=a)], is_train=False,
                                use_graph=False) or 0,
            jax.ShapeDtypeStruct(ENTRY_SHAPE, jnp.float32))
    finally:
        dev._rng_key = key
    return m


def _seeded_states(shapes, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for k, shape in sorted(shapes.items()):
        if k.endswith(".W") and len(shape) == 4:      # conv (O, I, kh, kw)
            fan_in = int(np.prod(shape[1:]))
            v = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif k.endswith(".W"):                         # fc (in, out)
            v = rng.randn(*shape) * np.sqrt(1.0 / shape[0])
        elif k.endswith(("running_var", ".scale")):
            v = rng.uniform(0.5, 1.5, shape)
        else:                                          # biases, means
            v = 0.1 * rng.randn(*shape)
        out[k] = v.astype(np.float32)
    return out


def test_resnet50_entry_forward_matches_jax_from_one_zip(tmp_path):
    jm = _jax_model()
    states = _seeded_states({k: tuple(v.shape)
                             for k, v in jm.get_states().items()})
    jm.set_states(states)
    path = str(tmp_path / "resnet50.zip")
    jm.save_states(path)

    cpu = device.create_cpu_device()
    tm = resnet50(num_classes=1000)
    tm.compile([torch.zeros((1, 3, 32, 32))], is_train=False)
    tm.load_states(path)
    got_states = {k: v.detach().numpy() for k, v in tm.get_states().items()}
    assert set(got_states) == set(states) and len(states) == 267
    for k, v in states.items():
        np.testing.assert_array_equal(got_states[k], v, err_msg=k)

    x = np.random.RandomState(1).randn(*ENTRY_SHAPE).astype(np.float32)
    jm.eval()
    dev = jdevice.get_default_device()
    key = dev._rng_key
    try:
        want = np.asarray(jax.jit(
            lambda a: jm.forward(jtensor.Tensor(data=a)).data)(x))
    finally:
        dev._rng_key = key
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(cpu.torch_device)).numpy()
    assert got.shape == (8, 1000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))
