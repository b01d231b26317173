"""GPT-2 training in the port (``singa_tpu_torch``) against the JAX
package, from the same weights.

``GPT2Config.tiny(dropout=0.0, attn_impl="flash")`` is built in both
packages; the JAX model's ``get_states()`` is carried into the port by
``Model.set_states``.  The JAX side runs eagerly (``use_graph=False``)
with its Pallas flash kernels in interpret mode; the port's flash op runs
its plain version on the CPU.

Tolerances: logits atol 1e-4 and each step's loss rtol 1e-4 in float32
(the two packages sum in different orders); final weights and optimizer
states atol 1e-5 after three steps (Adam's weights by the rule in
``test_training_steps_match_jax``); the bf16 amp forward atol 5e-2 on
logits of magnitude ~1 (bf16 keeps 8 mantissa bits, 2^-8 ≈ 0.4%, and
the two frameworks round activations at different points).
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)
import torch

from singa_tpu import amp as jamp
from singa_tpu import autograd as jautograd
from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu_torch import amp, device, opt, tensor
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

B, S = 2, 64


@pytest.fixture(autouse=True)
def _restore_jax_training_flag():
    """JAX's Model.train/eval set a process-wide flag; leave it as found."""
    prev = jautograd.training
    yield
    jautograd.set_training(prev)


def _batch(seed=0, ignore_half=False):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 256, (B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    if ignore_half:
        labels[:, ::2] = -1
    return ids, labels


def _pair(make_opt=None):
    """(jax model, port model) with the port holding the JAX weights."""
    ids, _ = _batch()
    jdevice.get_default_device().SetRandSeed(0)
    jm = JGPT2LMHead(JGPT2Config.tiny(dropout=0.0, attn_impl="flash"))
    cpu = device.create_cpu_device()
    tm = GPT2LMHead(GPT2Config.tiny(dropout=0.0, attn_impl="flash"))
    if make_opt is not None:
        jo, to = make_opt()
        jm.set_optimizer(jo)
        tm.set_optimizer(to)
    jm.compile([jtensor.from_numpy(ids)], is_train=True, use_graph=False)
    tm.compile([tensor.from_numpy(ids, cpu)], is_train=True)
    tm.set_states({k: jtensor.to_numpy(v)
                   for k, v in jm.get_states().items()})
    return jm, tm, cpu


def _logits(jm, tm, cpu, ids):
    jm.eval()
    tm.eval()
    jl = jtensor.to_numpy(jm(jtensor.from_numpy(ids)))
    with torch.no_grad():
        tl = tensor.to_numpy(tm(tensor.from_numpy(ids, cpu)))
    return jl, tl


def _steps(jm, tm, cpu, ids, labels, n):
    jm.train()
    tm.train()
    out = []
    for _ in range(n):
        _, jl = jm(jtensor.from_numpy(ids), jtensor.from_numpy(labels))
        _, tl = tm(tensor.from_numpy(ids, cpu),
                   tensor.from_numpy(labels, cpu))
        out.append((float(jtensor.to_numpy(jl)), tl.item()))
    return out


def test_state_names_and_shapes_match_jax():
    jm, tm, _ = _pair()
    js = {k: v.shape for k, v in jm.get_states().items()}
    ts = {k: tuple(v.shape) for k, v in tm.get_states().items()}
    assert ts == js
    assert "GPT2LMHead.transformer.blocks0.attn.q_proj.W" in ts
    assert "GPT2LMHead.transformer.blocks1.mlp.fc1.b" in ts
    assert "GPT2LMHead.transformer.ln_f.scale" in ts
    assert "GPT2LMHead.transformer.wte.W" in ts
    assert "GPT2LMHead.transformer.wpe.W" in ts


def test_set_states_rejects_unknown_and_missing_names():
    jm, tm, _ = _pair()
    states = {k: jtensor.to_numpy(v) for k, v in jm.get_states().items()}
    with pytest.raises(KeyError, match="unknown"):
        tm.set_states(dict(states, **{"GPT2LMHead.nope": np.zeros(1)}))
    states.pop("GPT2LMHead.transformer.wpe.W")
    with pytest.raises(KeyError, match="missing"):
        tm.set_states(states)


def test_logits_match_jax():
    jm, tm, cpu = _pair()
    ids, _ = _batch(1)
    jl, tl = _logits(jm, tm, cpu, ids)
    assert tl.shape == (B, S, 256)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_training_steps_match_jax(name):
    """Three steps from the same weights: losses rtol 1e-4, optimizer
    states atol 1e-5.  Weights under SGD: every element within atol
    1e-5.  Weights under Adam, one rule for every parameter: every
    element within 3·lr, the most three bias-corrected Adam steps move a
    coordinate; and at least 99.9% of the elements whose gradient is
    resolved within atol 1e-5.  Resolved means a second moment above
    float rounding (√v > ε = 1e-8, from the JAX optimizer's state).
    Where it is not (a key bias's gradient is zero in exact arithmetic,
    √v ~ 1e-11 here), Adam divides rounding noise by its own size, and
    the packages' different rounding gives steps of up to lr each."""
    lr = {"sgd": 0.1, "adam": 1e-3}[name]

    def make_opt():
        if name == "sgd":
            return (jopt.SGD(lr=lr, momentum=0.9),
                    opt.SGD(lr=lr, momentum=0.9))
        return jopt.Adam(lr=lr), opt.Adam(lr=lr)

    jm, tm, cpu = _pair(make_opt)
    ids, labels = _batch(2)
    for jl, tl in _steps(jm, tm, cpu, ids, labels, 3):
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
    js, ts = jm.get_states(), tm.get_states()
    jos, tos = jm.optimizer.get_states(), tm.optimizer.get_states()
    n_off = n_resolved = 0
    for k, v in js.items():
        got, want = tensor.to_numpy(ts[k]), jtensor.to_numpy(v)
        if name == "sgd":
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=k)
            continue
        np.testing.assert_allclose(got, want, atol=3 * lr, err_msg=k)
        resolved = np.sqrt(jos[f"{k}:v"]) > 1e-8
        n_off += int(np.sum(np.abs(got - want)[resolved] > 1e-5))
        n_resolved += int(resolved.sum())
    assert n_off <= 1e-3 * n_resolved, (
        f"{n_off} of {n_resolved} resolved weight elements off by more "
        f"than 1e-5")
    assert set(tos) == set(jos)
    for k, v in jos.items():
        np.testing.assert_allclose(tos[k], v, atol=1e-5, err_msg=k)


def test_ignore_index_loss_matches_jax():
    """Half the labels at −1: the loss is the mean cross-entropy over the
    valid positions only, in both packages."""
    jm, tm, cpu = _pair(lambda: (jopt.SGD(lr=0.1), opt.SGD(lr=0.1)))
    ids, labels = _batch(3, ignore_half=True)
    jl, tl = _logits(jm, tm, cpu, ids)
    logp = tl - np.log(np.exp(tl).sum(-1, keepdims=True))
    valid = labels >= 0
    want = -logp[valid, labels[valid]].mean()
    ((j_loss, t_loss),) = _steps(jm, tm, cpu, ids, labels, 1)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4)
    np.testing.assert_allclose(t_loss, want, rtol=1e-4)


def test_tied_head_gradient_reaches_wte():
    """With tied weights the LM head's gradient lands in wte: rows of
    tokens absent from the batch move only through the head, and move by
    the same amount in both packages."""
    jm, tm, cpu = _pair(lambda: (jopt.SGD(lr=0.1), opt.SGD(lr=0.1)))
    ids, labels = _batch(4)
    name = "GPT2LMHead.transformer.wte.W"
    before = tensor.to_numpy(tm.get_states()[name])
    _steps(jm, tm, cpu, ids, labels, 1)
    t_delta = tensor.to_numpy(tm.get_states()[name]) - before
    j_delta = jtensor.to_numpy(jm.get_states()[name]) - before
    absent = np.setdiff1d(np.arange(256), ids)
    assert absent.size > 0
    assert np.abs(t_delta[absent]).max() > 0
    np.testing.assert_allclose(t_delta, j_delta, atol=1e-6)


def test_amp_bf16_forward_matches_jax():
    jm, tm, cpu = _pair()
    ids, _ = _batch(5)
    jamp.enable()
    amp.enable()
    try:
        jl, tl = _logits(jm, tm, cpu, ids)
    finally:
        jamp.enable(False)
        amp.enable(False)
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, atol=5e-2, rtol=0)
