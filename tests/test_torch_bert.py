"""The port's BERT (``singa_tpu_torch/models/bert.py``,
``singa_tpu_torch/ops/attention.py``) against the JAX package's
(``singa_tpu/models/bert.py``, ``singa_tpu/ops/attention.py``).

``BertConfig.tiny`` (2 layers, hidden 64, 4 heads, vocab 1000), dropout
0, batch 2 x 24 ids from a numpy seed, the port's initial weights carried
into the JAX model.  On the CPU the port's flash path runs the kernels'
plain versions and the JAX flash path its Pallas kernels in interpret
mode, as its own tests run them.  Float32 throughout:

* MLM logits and the gradients of the MLM loss with respect to every
  parameter, fused and ``use_flash=True``, without and with a ragged
  ``attention_mask`` (the port's flash path takes it as the kernels'
  key-mask row): logits atol 1e-4, gradients atol 1e-5 (two encoder
  blocks of float32 sums in other orders; the logits are O(1), the
  gradients O(1e-2));
* the fused and flash paths of the port agree on the same weights;
* ``BertConfig.base()``: the parameter count (the trunk's published
  109,482,240; 133,545,786 with the MLM head) and every state name and
  shape equal the JAX model's, from shapes only (the JAX model
  compiled under ``jax.eval_shape``, the port's on torch's ``meta``
  device);
* two MLM SGD(0.1, momentum 0.9) steps, JAX in graph mode, each from
  the JAX state: losses rtol 1e-5, weights atol 1e-5;
* ``scaled_dot_product_attention`` and ``layer.MultiHeadAttention``
  (GQA too) against the JAX package's;
* a ``plan`` the layers cannot take (heads the model axis does not
  divide) raises ``ValueError``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import bert as jbert
from singa_tpu.ops import attention as jattn
from singa_tpu_torch import device, layer, opt, tensor
from singa_tpu_torch import device as tdevice
from singa_tpu_torch.models import bert as tbert
from singa_tpu_torch.ops import attention as tattn
from singa_tpu_torch.parallel import tensor_parallel

B, S = 2, 24
ATOL_LOGITS = 1e-4
ATOL_GRAD = 1e-5


@pytest.fixture(autouse=True)
def _restore_jax_training_flag():
    prev = jautograd.training
    yield
    jautograd.set_training(prev)


def _batch(seed=0, vocab=1000):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S)).astype(np.int32)
    labels = rng.randint(0, vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[0, 17:] = 0  # row 0 padded past 17 keys, row 1 whole
    return ids, labels, mask


def _cfg(use_flash):
    return dict(hidden_dropout=0.0, attn_dropout=0.0, use_flash=use_flash)


def _models(use_flash, use_graph=False, seed=0, lr=0.1, momentum=0.0):
    """(JAX model, port model): the port's initial weights in both."""
    ids, _, _ = _batch(seed)
    cpu = device.create_cpu_device()
    cpu.SetRandSeed(seed)
    tm = tbert.create_model("tiny", **_cfg(use_flash))
    tm.set_optimizer(opt.SGD(lr=lr, momentum=momentum))
    tm.compile([tensor.from_numpy(ids, cpu)], is_train=True,
               use_graph=use_graph)
    jm = jbert.create_model("tiny", **_cfg(use_flash))
    jm.set_optimizer(jopt.SGD(lr=lr, momentum=momentum))
    jm.compile([jtensor.from_numpy(ids)], is_train=True, use_graph=use_graph)
    states = {k: v.detach().numpy().copy()
              for k, v in tm.get_states().items()}
    assert set(jm.get_states()) == set(states)
    jm.set_states(states)
    return jm, tm


def _jax_logits_and_grads(jm, ids, labels, mask):
    jautograd.set_training(True)
    params = {id(v): k for k, v in jm.get_params().items()}
    logits = jm.forward(jtensor.from_numpy(ids), None,
                        None if mask is None else jtensor.from_numpy(mask))
    v = logits.shape[-1]
    loss = jm.softmax_cross_entropy(
        jautograd.reshape(logits, (B * S, v)),
        jtensor.from_numpy(labels.reshape(-1)))
    grads = {params[id(p)]: jtensor.to_numpy(g)
             for p, g in jautograd.backward(loss) if id(p) in params}
    return jtensor.to_numpy(logits), grads


def _port_logits_and_grads(tm, ids, labels, mask):
    tm.train()
    logits = tm.forward(torch.from_numpy(ids), None,
                        None if mask is None else torch.from_numpy(mask))
    loss = tm.softmax_cross_entropy(logits.reshape(B * S, -1),
                                    torch.from_numpy(labels.reshape(-1)))
    names = {id(p): k for k, p in tm.get_params().items()}
    loss.backward()
    grads = {names[id(p)]: p.grad.numpy() for p in tm.parameters()
             if p.grad is not None}
    return logits.detach().numpy(), grads


@pytest.mark.parametrize("use_flash", [False, True], ids=["fused", "flash"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "ragged"])
def test_tiny_logits_and_gradients_match_jax(use_flash, masked):
    jm, tm = _models(use_flash)
    ids, labels, mask = _batch(1)
    mask = mask if masked else None
    want, want_g = _jax_logits_and_grads(jm, ids, labels, mask)
    got, got_g = _port_logits_and_grads(tm, ids, labels, mask)
    assert got.shape == (B, S, 1000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_LOGITS)
    # the pooler takes no part in the MLM loss: no gradient on either side
    assert set(got_g) == set(want_g) and len(got_g) == len(
        tm.get_params()) - 2
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], rtol=0,
                                   atol=ATOL_GRAD, err_msg=k)


def test_fused_and_flash_paths_agree_under_a_ragged_mask():
    _, fused = _models(False)
    _, flash = _models(True)
    flash.set_states({k: v.detach() for k, v in fused.get_states().items()})
    ids, _, mask = _batch(2)
    fused.eval()
    flash.eval()
    with torch.no_grad():
        a = fused(torch.from_numpy(ids), None, torch.from_numpy(mask))
        b = flash(torch.from_numpy(ids), None, torch.from_numpy(mask))
        seq, pooled = flash.bert.forward(torch.from_numpy(ids), None,
                                         torch.from_numpy(mask))
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                               atol=ATOL_LOGITS)
    assert seq.shape == (B, S, 64) and pooled.shape == (B, 64)
    assert np.abs(pooled.numpy()).max() <= 1.0


def _jax_shaped(m, shape):
    dev = jdevice.get_default_device()
    key = dev._rng_key
    try:
        jax.eval_shape(
            lambda a: m.compile([jtensor.Tensor(data=a)], is_train=True)
            or 0, jax.ShapeDtypeStruct(shape, jnp.int32))
    finally:
        dev._rng_key = key
    return m


class _MetaDevice:
    generator = None

    def EnableGraph(self, on):
        pass


def test_base_parameter_count_and_state_names_equal_jax(monkeypatch):
    real = tdevice.device_of

    def device_of(t):
        return _MetaDevice() if t.device.type == "meta" else real(t)

    for mod in (tdevice, layer, tensor_parallel):
        monkeypatch.setattr(mod, "device_of", device_of)
    tm = tbert.create_model("base")
    tm.compile([torch.zeros((1, 512), dtype=torch.int32, device="meta")],
               is_train=True)
    jm = _jax_shaped(jbert.create_model("base"), (1, 512))
    ts = {k: tuple(v.shape) for k, v in tm.get_states().items()}
    assert ts == {k: tuple(v.shape) for k, v in jm.get_states().items()}
    count = sum(p.numel() for p in tm.get_params().values())
    assert count == sum(int(np.prod(v.shape))
                        for v in jm.get_params().values())
    # the trunk is BERT-base's published 110M (109,482,240 with the
    # pooler); the MLM head's untied decoder adds 23.5M
    trunk = sum(p.numel() for k, p in tm.get_params().items()
                if k.startswith("BertForMaskedLM.bert."))
    assert trunk == 109_482_240 and count == 133_545_786


@pytest.mark.parametrize("use_flash", [False, True], ids=["fused", "flash"])
def test_two_mlm_sgd_steps_match_jax(use_flash):
    jm, tm = _models(use_flash, use_graph=True, seed=3, momentum=0.9)
    ids, labels, _ = _batch(4)
    cpu = device.create_cpu_device()
    for step in range(2):
        tm.set_states({k: jtensor.to_numpy(v)
                       for k, v in jm.get_states().items()})
        tm.optimizer.set_states(jm.optimizer.get_states())
        _, jl = jm(jtensor.from_numpy(ids), jtensor.from_numpy(labels))
        _, tl = tm(tensor.from_numpy(ids, cpu),
                   tensor.from_numpy(labels, cpu))
        np.testing.assert_allclose(tl.item(), float(jtensor.to_numpy(jl)),
                                   rtol=1e-5, err_msg=f"loss, step {step}")
        js = jm.get_states()
        for k, v in tm.get_states().items():
            np.testing.assert_allclose(v.detach().numpy(),
                                       jtensor.to_numpy(js[k]),
                                       atol=ATOL_GRAD,
                                       err_msg=f"{k}, step {step}")


@pytest.mark.parametrize("use_flash", [False, True], ids=["fused", "flash"])
def test_scaled_dot_product_attention_matches_jax(use_flash):
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, 3, 20, 16).astype(np.float32) for _ in range(3))
    mask = np.where(rng.rand(2, 1, 1, 20) < 0.3, -1e9, 0.0).astype(
        np.float32)
    want = jtensor.to_numpy(jattn.scaled_dot_product_attention(
        *(jtensor.from_numpy(a) for a in (q, k, v, mask)),
        use_flash=use_flash))
    got = tattn.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v, mask)), use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    # remat recomputes the scores in the backward: the same gradient
    grads = []
    for remat in (False, True):
        rq = torch.from_numpy(q).requires_grad_(True)
        tattn.scaled_dot_product_attention(
            rq, torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(mask), use_flash=use_flash,
            remat=remat).sum().backward()
        grads.append(rq.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_multi_head_attention_layer_matches_jax(kv_heads):
    rng = np.random.RandomState(6)
    x = rng.randn(2, 10, 32).astype(np.float32)
    assert layer.MultiHeadAttention is tattn.MultiHeadAttention
    tm = layer.MultiHeadAttention(4, num_kv_heads=kv_heads)
    tm(torch.from_numpy(x))
    jm = jattn.MultiHeadAttention(4, num_kv_heads=kv_heads)
    jm(jtensor.from_numpy(x))
    # a layer outside a model has no hierarchical names: copy each
    # projection's W and b across by attribute
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        for p in ("W", "b"):
            src = getattr(getattr(tm, proj), p).detach().numpy()
            dst = getattr(getattr(jm, proj), p)
            assert dst.shape == src.shape, (proj, p)
            dst.data = jnp.asarray(src)
    want = jtensor.to_numpy(jm(jtensor.from_numpy(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_a_plan_raises():
    """A plan BERT's layers cannot take raises as the JAX package's does:
    4 heads over a model axis of 3 (planned training itself is held
    against the JAX package in ``test_torch_sharded_training.py``)."""
    from singa_tpu_torch.parallel import sharding

    plan = sharding.ShardingPlan(
        sharding.Mesh((1, 3, 1, 1, 1), rank=0, device="cpu"))
    with pytest.raises(ValueError, match="model-axis size 3"):
        tbert.create_model("tiny", plan=plan)
