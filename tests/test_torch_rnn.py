"""The port's recurrent ops and char-RNN (``singa_tpu_torch/ops/rnn.py``,
``singa_tpu_torch/models/char_rnn.py``) against the JAX package's
(``singa_tpu/ops/rnn.py``, ``singa_tpu/models/char_rnn.py``).

* ``rnn_forward`` for LSTM, GRU and the vanilla tanh and relu cells,
  1-2 layers, uni- and bidirectional, ``batch_first`` both ways, on the
  same packed weight, initial states and input (numpy seeds): outputs,
  ``hy``/``cy`` and the gradients of a random projection of all three
  with respect to x, hx, cx and the packed weight, float32, atol 1e-5
  (sums of the same products in other orders; the port also takes every
  step's input product in one matmul over the sequence).
* ``RNNHandle.slices`` and ``weights_size`` equal the JAX package's.
* ``CharRNN`` (every cell): a ``save_states`` zip written by either
  package loads into the other bit for bit.
* Two SGD(0.1) steps of ``CharRNN`` from one state, JAX in graph mode,
  each from the JAX state: losses rtol 1e-5, weights atol 1e-5.
* The layers re-exported by ``layer``, and ``use_pallas`` accepted.
"""

import numpy as np
import pytest

import torch

from singa_tpu import autograd as jautograd
from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import char_rnn as jchar
from singa_tpu.ops import rnn as jrnn
from singa_tpu_torch import device, layer, opt, tensor
from singa_tpu_torch.models import char_rnn as tchar
from singa_tpu_torch.ops import rnn as trnn

ATOL = 1e-5

#: (mode, layers, bidirectional, batch_first)
CASES = [
    ("lstm", 1, False, False),
    ("lstm", 2, True, True),
    ("lstm", 2, False, True),
    ("gru", 1, False, True),
    ("gru", 2, True, False),
    ("vanilla_tanh", 1, True, False),
    ("vanilla_tanh", 2, False, True),
    ("vanilla_relu", 1, False, False),
    ("vanilla_relu", 2, True, True),
]


@pytest.fixture(autouse=True)
def _restore_jax_training_flag():
    prev = jautograd.training
    yield
    jautograd.set_training(prev)


def _inputs(mode, layers, bidir, batch_first, seed=0, t=5, b=3, i=4, h=6):
    rng = np.random.RandomState(seed)
    handle = trnn.RNNHandle(i, h, layers, mode, bidir)
    d = handle.num_directions
    x = rng.randn(*((b, t, i) if batch_first else (t, b, i)))
    hx, cx = (0.5 * rng.randn(layers * d, b, h) for _ in range(2))
    w = rng.uniform(-0.4, 0.4, handle.weights_size)
    y_shape = (b, t, d * h) if batch_first else (t, b, d * h)
    gy = rng.randn(*y_shape)
    gh, gc = (rng.randn(layers * d, b, h) for _ in range(2))
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return handle, [f32(a) for a in (x, hx, cx, w)], [f32(a) for a in
                                                      (gy, gh, gc)]


def _jax_run(mode, layers, bidir, batch_first, arrays, cot):
    jautograd.set_training(True)
    dev = jdevice.get_default_device()
    handle = jrnn.RNNHandle(arrays[0].shape[-1], arrays[1].shape[-1],
                            layers, mode, bidir)
    ts = []
    for a in arrays:
        t = jtensor.from_numpy(a, dev)
        t.requires_grad = t.stores_grad = True
        ts.append(t)
    y, hy, cy = jrnn.rnn_forward(*ts, handle, batch_first=batch_first)
    outs = [jtensor.to_numpy(t) for t in (y, hy, cy)]
    loss = None
    for t, g in zip((y, hy, cy), cot):
        part = jautograd.reduce_sum(jautograd.mul(
            t, jtensor.from_numpy(g, dev)))
        loss = part if loss is None else jautograd.add(loss, part)
    grads = dict(jautograd.backward(loss))
    return outs, [jtensor.to_numpy(grads[t]) for t in ts]


@pytest.mark.parametrize("mode,layers,bidir,batch_first", CASES)
def test_rnn_forward_and_gradients_match_jax(mode, layers, bidir,
                                             batch_first):
    handle, arrays, cot = _inputs(mode, layers, bidir, batch_first)
    want, want_grads = _jax_run(mode, layers, bidir, batch_first, arrays,
                                cot)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    outs = trnn.rnn_forward(*ts, handle, batch_first=batch_first)
    loss = sum((o * torch.from_numpy(g)).sum() for o, g in zip(outs, cot))
    loss.backward()
    for name, got, w in zip(("y", "hy", "cy"), outs, want):
        assert got.shape == w.shape, name
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=0,
                                   atol=ATOL, err_msg=name)
    for name, t, w in zip(("x", "hx", "cx", "W"), ts, want_grads):
        # cx takes no part in the modes without a cell state: no gradient
        got = np.zeros_like(w) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("mode", sorted(trnn._GATES))
@pytest.mark.parametrize("i,h,layers,bidir", [(4, 6, 1, False),
                                              (7, 5, 3, True),
                                              (100, 256, 2, False)])
def test_handle_layout_equals_jax(mode, i, h, layers, bidir):
    t = trnn.RNNHandle(i, h, layers, mode, bidir, use_pallas=True)
    j = jrnn.RNNHandle(i, h, layers, mode, bidir, use_pallas=True)
    assert t.slices == j.slices
    assert t.weights_size == j.weights_size


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown rnn mode"):
        trnn.RNNHandle(4, 6, mode="lstm2")


def test_layer_reexports_the_recurrent_layers():
    assert layer.LSTM is trnn.LSTM and layer.GRU is trnn.GRU
    assert layer.RNN is trnn.RNN and layer.CudnnRNN is trnn.CudnnRNN
    assert issubclass(layer.CudnnRNN, layer.LSTM)
    with pytest.raises(AttributeError):
        layer.NoSuchLayer  # noqa: B018


@pytest.mark.parametrize("cls,mode", [("LSTM", "lstm"), ("GRU", "gru"),
                                      ("RNN", "vanilla_tanh")])
def test_layer_returns_sequences_and_states(cls, mode):
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(2, 7, 3).astype(np.float32))
    m = getattr(layer, cls)(5, num_layers=2, batch_first=True,
                            use_pallas=True)
    y, state = m(x)
    assert m.handle.mode == mode and y.shape == (2, 7, 5)
    hy = state[0] if mode == "lstm" else state
    assert hy.shape == (2, 2, 5)
    np.testing.assert_array_equal(y[:, -1].detach().numpy(),
                                  hy[-1].detach().numpy())
    last = getattr(layer, cls)(5, batch_first=True, return_sequences=False)
    h, _ = last(x)
    assert h.shape == (1, 2, 5)


def test_relu_rnn_mode():
    m = layer.RNN(4, nonlinearity="relu")
    y, _ = m(torch.ones(3, 2, 5))
    assert m.handle.mode == "vanilla_relu" and (y >= 0).all()


# ------------------------------------------------------------- char-RNN

VOCAB, HIDDEN, B, T = 11, 8, 3, 6


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (B, T + 1))
    x = tchar.one_hot(ids[:, :-1], VOCAB)
    np.testing.assert_array_equal(x, jchar.one_hot(ids[:, :-1], VOCAB))
    return x, ids[:, 1:].astype(np.int32)


def _models(cell, use_graph=False, seed=0):
    """(JAX model, port model, x, y): the port's initial weights carried
    into the JAX model."""
    x, y = _batch(seed)
    cpu = device.create_cpu_device()
    cpu.SetRandSeed(seed)
    tm = tchar.create_model(vocab_size=VOCAB, hidden_size=HIDDEN,
                            num_layers=2, seq_length=T, cell=cell)
    tm.set_optimizer(opt.SGD(lr=0.1))
    tm.compile([tensor.from_numpy(x, cpu)], is_train=True,
               use_graph=use_graph)
    jm = jchar.create_model(vocab_size=VOCAB, hidden_size=HIDDEN,
                            num_layers=2, seq_length=T, cell=cell)
    jm.set_optimizer(jopt.SGD(lr=0.1))
    jm.compile([jtensor.from_numpy(x)], is_train=True, use_graph=use_graph)
    states = {k: v.detach().numpy().copy()
              for k, v in tm.get_states().items()}
    assert set(jm.get_states()) == set(states)
    jm.set_states(states)
    return jm, tm, x, y


@pytest.mark.parametrize("cell", ["lstm", "gru", "vanilla_tanh",
                                  "vanilla_relu"])
def test_char_rnn_zips_load_across_both_ways(cell, tmp_path):
    jm, tm, _, _ = _models(cell)
    rng = np.random.RandomState(3)
    states = {k: rng.randn(*v.shape).astype(np.float32)
              for k, v in tm.get_states().items()}
    jm.set_states(states)
    jm.save_states(str(tmp_path / "jax.zip"))
    tm.load_states(str(tmp_path / "jax.zip"))
    got = {k: v.detach().numpy() for k, v in tm.get_states().items()}
    assert set(got) == set(states)
    for k in states:
        np.testing.assert_array_equal(got[k], states[k], err_msg=k)
    tm.set_states({k: v + 1.0 for k, v in states.items()})
    tm.save_states(str(tmp_path / "port.zip"))
    jm.load_states(str(tmp_path / "port.zip"))
    for k, v in jm.get_states().items():
        np.testing.assert_array_equal(jtensor.to_numpy(v), states[k] + 1.0,
                                      err_msg=k)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_char_rnn_two_sgd_steps_match_jax(cell):
    jm, tm, x, y = _models(cell, use_graph=True, seed=1)
    cpu = device.create_cpu_device()
    for step in range(2):
        tm.set_states({k: jtensor.to_numpy(v)
                       for k, v in jm.get_states().items()})
        _, jl = jm(jtensor.from_numpy(x), jtensor.from_numpy(y))
        _, tl = tm(tensor.from_numpy(x, cpu), tensor.from_numpy(y, cpu))
        np.testing.assert_allclose(tl.item(), float(jtensor.to_numpy(jl)),
                                   rtol=1e-5, err_msg=f"loss, step {step}")
        js = jm.get_states()
        for k, v in tm.get_states().items():
            np.testing.assert_allclose(v.detach().numpy(),
                                       jtensor.to_numpy(js[k]), atol=ATOL,
                                       err_msg=f"{k}, step {step}")


def test_char_rnn_eval_logits_match_jax():
    jm, tm, x, _ = _models("lstm", seed=2)
    jm.eval()
    want = jtensor.to_numpy(jm.forward(jtensor.from_numpy(x)))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (B * T, VOCAB)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_dropout_between_layers_only_while_training():
    """``dropout`` acts between layers while the layer trains (zeroing
    some of the first layer's outputs changes the second's), never in
    eval, and never after the last layer."""
    rng = np.random.RandomState(7)
    x = torch.tensor(rng.randn(5, 3, 4).astype(np.float32))
    m = layer.LSTM(6, num_layers=2, dropout=0.5)
    one = layer.LSTM(6, num_layers=1, dropout=0.5)
    m.eval()
    one.eval()
    with torch.no_grad():
        y_eval = m(x)[0]
        y1 = one(x)[0]
        m.train()
        one.train()
        assert not torch.equal(m(x)[0], y_eval)
        assert torch.equal(one(x)[0], y1)
        m.eval()
        assert torch.equal(m(x)[0], y_eval)
