"""Checkpoints between the two packages: the port's
``Model.save_states``/``load_states`` (``singa_tpu_torch/model.py``)
against the JAX package's zip (``singa_tpu/model.py:337-448``).

For every zoo model (small widths and inputs), the JAX model's states,
set from a numpy seed (``_fill``), with SGD momentum state for every
parameter, a
step counter and aux values, go JAX zip → port → port zip → JAX, and
every array arrives bit for bit; each ``.npy`` of the port's zip is the
JAX package's byte for byte.  The JAX models are built without running
them: ``compile`` under ``jax.eval_shape`` makes the parameters'
shapes, and ``set_states`` then puts concrete arrays in them.

Also: bf16 states (the JAX package writes a bf16 array as its raw bits
under the ``.npy`` descr ``<V2``, which the port reads as bf16 and
writes the same; the JAX package itself cannot read such a file back,
``TypeError``), ``async_save`` between graph-mode steps holding the
state of the save's moment, the ``checkpoint.write``/``checkpoint.read``
fault sites with and without a ``RetryPolicy``, and unknown or missing
names raising.  Everything is compared exactly: a checkpoint copies.
"""

import importlib
import os
import zipfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu_torch import device, model, opt, tensor
from singa_tpu_torch.models.mlp import MLP
from singa_tpu_torch.observe.registry import registry
from singa_tpu_torch.resilience import faults
from singa_tpu_torch.resilience.retry import (RetryBudgetExceededError,
                                              RetryPolicy)

#: (module, class, kwargs, input shape): the zoo at small widths
ZOO = {
    "mlp": ("mlp", "MLP", dict(data_size=4, perceptron_size=8,
                               num_classes=3), (2, 4)),
    "cnn": ("cnn", "CNN", dict(num_classes=10), (2, 1, 28, 28)),
    "alexnet": ("alexnet", "AlexNet", dict(num_classes=10),
                (1, 3, 63, 63)),
    "vgg11_bn": ("vgg", "vgg11", dict(num_classes=10, hidden=16,
                                      batch_norm=True), (2, 3, 32, 32)),
    "mobilenet_v2": ("mobilenet", "mobilenet_v2",
                     dict(num_classes=10, width_mult=0.25), (2, 3, 32, 32)),
    "xception": ("xceptionnet", "Xception", dict(num_classes=10),
                 (1, 3, 71, 71)),
    "unet": ("unet", "UNet", dict(num_classes=2, base_channels=4, depth=2),
             (2, 3, 16, 16)),
}


@pytest.fixture(autouse=True)
def _restore_jax_training_flag():
    prev = jautograd.training
    yield
    jautograd.set_training(prev)


def _cpu():
    return device.create_cpu_device()


def jax_shaped(m, shape, dtype=jnp.float32):
    """``m.compile`` without running the model: the parameters get their
    shapes under ``jax.eval_shape`` (the device key, which the
    initializers split there, is put back)."""
    dev = jdevice.get_default_device()
    key = dev._rng_key
    try:
        jax.eval_shape(
            lambda a: m.compile([jtensor.Tensor(data=a)], is_train=True,
                                use_graph=False) or 0,
            jax.ShapeDtypeStruct(shape, dtype))
    finally:
        dev._rng_key = key
    return m


def _zoo_pair(name):
    mod, cls, kw, shape = ZOO[name]
    jm = getattr(importlib.import_module(f"singa_tpu.models.{mod}"), cls)(**kw)
    jm.set_optimizer(jopt.SGD(lr=0.1, momentum=0.9))
    jax_shaped(jm, shape)
    tm = getattr(importlib.import_module(f"singa_tpu_torch.models.{mod}"),
                 cls)(**kw)
    tm.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    tm.compile([tensor.from_numpy(np.zeros(shape, np.float32), _cpu())],
               is_train=True)
    return jm, tm


def _fill(rng, shape):
    """Seeded values for one tensor: gaussian, or past 2^16 elements
    gaussian at every 61st element and zero between (AlexNet's and
    Xception's fixed widths hold tens of millions of elements, which the
    zip's deflate packs slowly when every one is random); a misplaced
    element still shows."""
    size = int(np.prod(shape))
    if size <= 2 ** 16:
        return rng.randn(*shape).astype(np.float32)
    out = np.zeros(size, np.float32)
    out[::61] = rng.randn(len(out[::61]))
    return out.reshape(shape)


def _seeded_states(jm, seed):
    """Model states, momentum for every parameter, a step counter, aux."""
    rng = np.random.RandomState(seed)
    states = {k: _fill(rng, v.shape) for k, v in jm.get_states().items()}
    opt_states = {f"{k}:momentum": _fill(rng, v.shape)
                  for k, v in jm.get_params().items()}
    opt_states["__step_counter__"] = np.asarray(7.0, np.float32)
    aux = {"epoch": np.int64(3), "lr_history": np.arange(4.0)}
    return states, opt_states, aux


def _npy_files(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_zip_round_trips_jax_port_jax_bit_for_bit(name, tmp_path):
    jm, tm = _zoo_pair(name)
    params = jm.get_params()
    # every JAX parameter is named, so its optimizer state names are the
    # state names (no param_<i> or id() suffix, singa_tpu/opt.py:125-133)
    assert all(t.name == k for k, t in params.items())
    assert set(jm.get_states()) == set(tm.get_states())
    states, opt_states, aux = _seeded_states(jm, seed=len(name))
    jm.set_states(states)
    jm.optimizer.set_states(opt_states)
    jzip, tzip = tmp_path / "jax.zip", tmp_path / "port.zip"
    jm.save_states(str(jzip), aux_states=aux)

    got_aux = tm.load_states(str(jzip))
    assert set(got_aux) == set(aux)
    for k, v in aux.items():
        assert np.array_equal(got_aux[k], v) and got_aux[k].dtype == \
            np.asarray(v).dtype
    for k, v in tm.get_states().items():
        assert np.array_equal(v.detach().numpy(), states[k]), k
    for k, v in tm.optimizer.get_states().items():
        assert np.array_equal(v, opt_states[k]), k

    tm.save_states(str(tzip), aux_states=got_aux)
    assert _npy_files(tzip) == _npy_files(jzip)

    jm2, _ = _zoo_pair(name)
    assert set(jm2.load_states(str(tzip))) == set(aux)
    for k, v in jm2.get_states().items():
        assert np.array_equal(jtensor.to_numpy(v), states[k]), k
    for k, v in jm2.optimizer.get_states().items():
        assert np.array_equal(np.asarray(v), opt_states[k]), k


def test_bf16_states_read_as_the_jax_package_writes_them(tmp_path):
    """bf16 parameters (a bf16 input, no amp): the JAX zip's ``<V2``
    arrays load into the port as bf16 with the same bits, and the port
    writes the same ``.npy`` bytes.  The JAX package cannot load its own
    bf16 zip (``jnp.asarray`` refuses a void array)."""
    x = np.ones((2, 4), np.float32)
    jm = _jax_bf16_mlp(x)
    rng = np.random.RandomState(2)
    bits = {k: rng.randn(*v.shape).astype(ml_dtypes.bfloat16)
            for k, v in jm.get_states().items()}
    jm.set_states(bits)
    assert all(v.dtype == jnp.bfloat16 for v in
               (t.data for t in jm.get_states().values()))
    jzip, tzip = tmp_path / "jax.zip", tmp_path / "port.zip"
    jm.save_states(str(jzip))
    assert all(b"'descr': '<V2'" in data for n, data in
               _npy_files(jzip).items() if not n.startswith("__opt__"))

    tm = MLP(data_size=4, perceptron_size=8, num_classes=3)
    tm.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    tm.compile([tensor.from_numpy(x, _cpu()).to(torch.bfloat16)])
    assert all(v.dtype == torch.bfloat16 for v in tm.get_states().values())
    tm.load_states(str(jzip))
    for k, v in tm.get_states().items():
        assert np.array_equal(v.detach().view(torch.int16).numpy(),
                              bits[k].view(np.int16)), k
    tm.save_states(str(tzip))
    port_files = _npy_files(tzip)
    for n, data in _npy_files(jzip).items():
        assert port_files[n] == data, n
    with pytest.raises(TypeError):
        jm.load_states(str(jzip))


def _jax_bf16_mlp(x):
    from singa_tpu.models.mlp import MLP as JMLP

    jm = JMLP(data_size=4, perceptron_size=8, num_classes=3)
    jm.set_optimizer(jopt.SGD(lr=0.1, momentum=0.9))
    return jax_shaped(jm, x.shape, jnp.bfloat16)


def _mlp(use_graph=True, seed=0):
    cpu = _cpu()
    cpu.SetRandSeed(seed)
    m = MLP(data_size=6, perceptron_size=16, num_classes=4)
    m.set_optimizer(opt.SGD(lr=opt.ExponentialDecay(0.1, 2, 0.5),
                            momentum=0.9))
    rng = np.random.RandomState(seed)
    x = tensor.from_numpy(rng.randn(8, 6).astype(np.float32), cpu)
    y = tensor.from_numpy(rng.randint(0, 4, 8).astype(np.int32), cpu)
    m.compile([x], is_train=True, use_graph=use_graph)
    return m, x, y


def test_async_save_between_graph_steps_holds_the_saved_moment(tmp_path):
    """Save asynchronously between two graph-mode steps and step again at
    once: the file holds the state of the save's moment; a fresh model
    loaded from it then takes the same next step, bit for bit."""
    m, x, y = _mlp()
    for _ in range(3):
        m(x, y)
    moment = {k: v.detach().clone() for k, v in
              m.persistent_tensors().items()}
    path = tmp_path / "async.zip"
    handle = m.save_states(str(path), aux_states={"step": 3},
                           async_save=True)
    _, loss_next = m(x, y)
    handle.wait()
    assert handle.done()
    fresh, _, _ = _mlp(use_graph=True, seed=1)
    assert fresh.load_states(str(path))["step"] == 3
    for k, v in fresh.persistent_tensors().items():
        assert torch.equal(v, moment[k]), k
    _, loss_fresh = fresh(x, y)
    assert loss_fresh.item() == loss_next.item()
    for k, v in fresh.persistent_tensors().items():
        assert torch.equal(v, m.persistent_tensors()[k]), k


def test_zip_layout_names_and_file_mode(tmp_path):
    m, x, y = _mlp(use_graph=False)
    m(x, y)
    path = tmp_path / "c.zip"
    m.save_states(str(path), aux_states={"epoch": 1})
    names = set(_npy_files(path))
    assert names == {f"{k}.npy" for k in m.get_states()} | {
        f"__opt__{k}.npy" for k in m.optimizer.state_tensors()} | {
        "__aux__epoch.npy"}
    assert "__opt____step_counter__.npy" in names
    assert os.stat(path).st_mode & 0o777 == model._ckpt_mode(str(tmp_path))
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_write_fault_raises_without_retry_and_is_retried_with_it(tmp_path):
    m, x, y = _mlp(use_graph=False)
    m(x, y)
    path = tmp_path / "c.zip"
    with faults.injected("checkpoint.write", faults.FailOnce()) as pol:
        with pytest.raises(faults.FaultInjected):
            m.save_states(str(path))
    assert pol.fired == 1 and not path.exists()
    assert not os.listdir(tmp_path)
    retries = registry().counter("resilience.retries",
                                 site="checkpoint.write")
    before = retries.value
    with faults.injected("checkpoint.write", faults.FailOnce()):
        m.save_states(str(path), retry=RetryPolicy(max_attempts=3,
                                                   base_delay_s=0.0,
                                                   seed=0))
    assert retries.value == before + 1
    fresh, _, _ = _mlp(use_graph=False, seed=1)
    fresh.load_states(str(path))
    for k, v in fresh.get_states().items():
        assert torch.equal(v, m.get_states()[k]), k
    with faults.injected("checkpoint.write",
                         faults.FailRate(1.0, transient=True)):
        with pytest.raises(RetryBudgetExceededError):
            m.save_states(str(path), retry=RetryPolicy(
                max_attempts=2, base_delay_s=0.0, seed=0))
    with faults.injected("checkpoint.write",
                         faults.FailOnce(transient=False)):
        with pytest.raises(faults.FaultInjected):
            m.save_states(str(path), retry=RetryPolicy(seed=0))


def test_async_write_fault_is_raised_by_wait_and_counted(tmp_path):
    m, x, y = _mlp()
    m(x, y)
    failures = registry().counter("checkpoint.async_failures")
    before = failures.value
    with faults.injected("checkpoint.write", faults.FailOnce()):
        handle = m.save_states(str(tmp_path / "c.zip"), async_save=True)
        with pytest.raises(faults.FaultInjected):
            handle.wait()
    assert failures.value == before + 1


def test_read_fault_raises(tmp_path):
    m, x, y = _mlp(use_graph=False)
    path = tmp_path / "c.zip"
    m.save_states(str(path))
    with faults.injected("checkpoint.read", faults.FailOnce()):
        with pytest.raises(faults.FaultInjected):
            m.load_states(str(path))


def _rewrite(src, dst, drop=(), add=None):
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for n in zin.namelist():
            if n not in drop:
                zout.writestr(n, zin.read(n))
        for n, data in (add or {}).items():
            zout.writestr(n, data)


@pytest.mark.parametrize("case", ["extra_state", "missing_state",
                                  "opt_state_of_no_param",
                                  "opt_state_of_unknown_slot"])
def test_unknown_or_missing_names_raise(case, tmp_path):
    m, x, y = _mlp(use_graph=False)
    m(x, y)
    good = tmp_path / "good.zip"
    m.save_states(str(good))
    files = _npy_files(good)
    w = files["MLP.linear1.W.npy"]
    bad = tmp_path / "bad.zip"
    if case == "extra_state":
        _rewrite(good, bad, add={"MLP.linear3.W.npy": w})
    elif case == "missing_state":
        _rewrite(good, bad, drop={"MLP.linear2.b.npy"})
    elif case == "opt_state_of_no_param":
        _rewrite(good, bad, add={"__opt__MLP.linear9.W:momentum.npy": w})
    else:
        _rewrite(good, bad, add={"__opt__MLP.linear1.W:m.npy": w})
    fresh, _, _ = _mlp(use_graph=False, seed=1)
    with pytest.raises(KeyError):
        fresh.load_states(str(bad))
