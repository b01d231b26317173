"""The port's mixture of experts (``singa_tpu_torch/parallel/moe.py``),
MoE GPT-2 training and MoE decode and serving, against the JAX package.

Training holds the port's ``MoEFFN`` against the JAX ``MoEFFN`` (with
capacity, so tokens drop); decode holds ``gpt2_decode._moe_ffn`` against
the JAX ``_moe_ffn`` (capacity-free, nothing drops): never one against
the other.  Weights carry across by ``get_states`` / ``set_states`` or a
``save_states`` zip.

Tolerances: float32 atol 1e-5 for layer outputs, routing tensors,
parameters and decode logits (the packages sum the same terms in other
orders; values O(1)), and rtol 1e-5 beside it for the layer test's
parameters after an SGD(lr=1) step (each gradient a sum over the
tokens; entries up to ~4); the layer test's loss, a sum of 256
products, atol 1e-4; GPT-2 logits atol 1e-4 (a 256-way vocabulary
product over 64 features after two blocks); greedy token streams equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import gpt2_decode as jgd
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu.parallel import moe as jmoe
from singa_tpu.serve import GenerationRequest as JRequest
from singa_tpu.serve import PagedConfig as JPagedConfig
from singa_tpu_torch import device, opt
from singa_tpu_torch.models import gpt2_decode as gd
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.parallel import moe
from singa_tpu_torch.serve import GenerationRequest, PagedConfig

ATOL = 1e-5
B, S, D, E, F = 2, 8, 16, 4, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


# ------------------------------------------------------------- routing


def _probs(seed, n=40, e=E, skew=0.0):
    rng = np.random.RandomState(seed)
    z = rng.randn(n, e).astype(np.float32)
    z[:, 0] += skew  # most tokens prefer expert 0: capacity drops
    z = np.exp(z - z.max(-1, keepdims=True))
    return (z / z.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("skew,cap", [(0.0, 40), (3.0, 6)],
                         ids=["ample", "drops"])
def test_dispatch_and_load_equal_jax(top_k, skew, cap):
    """Dispatch, combine and aux of ``_top1/_top2_dispatch`` (also
    batched over a group axis, as the layer calls them) and
    ``dispatch_load`` equal the JAX package's."""
    p = _probs(top_k, skew=skew)
    jf = jmoe._top2_dispatch if top_k == 2 else jmoe._top1_dispatch
    tf = moe._top2_dispatch if top_k == 2 else moe._top1_dispatch
    want = jax.jit(jf, static_argnums=1)(jnp.asarray(p), cap)
    got = tf(torch.from_numpy(p), cap)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATOL, rtol=0)
    grouped = tf(torch.from_numpy(p.reshape(2, 20, E)), cap)
    for g, w in zip(grouped, jax.jit(jax.vmap(jf, in_axes=(0, None)),
                                     static_argnums=1)(
            jnp.asarray(p.reshape(2, 20, E)), cap)):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATOL, rtol=0)
    kept, dropped = moe.dispatch_load(got[0], top_k)
    jkept, jdropped = jmoe.dispatch_load(want[0], top_k)
    np.testing.assert_array_equal(_np(kept), np.asarray(jkept))
    assert int(dropped) == int(jdropped)
    assert (int(dropped) > 0) == (skew > 0)


# ------------------------------------------------------- the FFN layer


#: the layers under test: (top_k, capacity_factor, groups); 0.5 drops
LAYERS = [(k, cf, g) for k in (1, 2)
          for cf, g in ((4.0, None), (0.5, None), (0.5, 2))]
#: the layers trained on the aux loss alone: top-1 and top-2, with drops
AUX_ONLY = (1, 4)
NAMES = ("Wg", "W1", "b1", "W2", "b2")


def _layer_id(i):
    k, cf, g = LAYERS[i]
    return f"top{k}_" + ("ample" if cf > 1 else "drops") + \
        (f"_groups{g}" if g else "")


@pytest.fixture(scope="module")
def layer_runs():
    """Every layer of ``LAYERS`` on one input, in both packages, from the
    port's weights: its output, the gradients of ``sum(y · r) + 0.5 ·
    aux`` for x and each parameter, and those of the aux loss alone.  The
    JAX layers run inside one ``jax.jit`` of ``jax.grad`` (the tape's
    VJPs are ``jax.vjp`` of the same function)."""
    rng = np.random.RandomState(1)
    x = rng.randn(B, S, D).astype(np.float32)
    r = rng.randn(B, S, D).astype(np.float32)
    cpu = device.create_cpu_device()
    cpu.SetRandSeed(0)
    tx = torch.from_numpy(x).requires_grad_()
    tr = torch.from_numpy(r)
    port, ws = [], []
    for k, cf, g in LAYERS:
        m = moe.MoEFFN(E, F, top_k=k, capacity_factor=cf, groups=g)
        m(tx)
        ps = [getattr(m, n) for n in NAMES]
        ws.append([_np(p).copy() for p in ps])
        y = m(tx)
        aux = 0.5 * m.last_aux_loss
        grads = torch.autograd.grad((y * tr).sum() + aux, [tx] + ps,
                                    retain_graph=True)
        gaux = torch.autograd.grad(aux, ps, allow_unused=True)
        port.append(dict(y=_np(y), gx=_np(grads[0]),
                         gw=[_np(t) for t in grads[1:]],
                         gaux=[np.zeros(p.shape, np.float32) if t is None
                               else _np(t) for p, t in zip(ps, gaux)]))
    jlayers, dev = [], jdevice.get_default_device()
    for k, cf, g in LAYERS:
        m = jmoe.MoEFFN(E, F, top_k=k, capacity_factor=cf, groups=g)
        m.initialize(jtensor.from_numpy(x))
        jlayers.append(m)

    def run(all_ws, xa, ra):
        out = []
        for m, w in zip(jlayers, all_ws):
            for n, a in zip(NAMES, w):
                getattr(m, n).data = a
            y = m.forward(jtensor._wrap(xa, dev)).data
            out.append((y, m.last_aux_loss.data))
        return out

    def loss(all_ws, xa, ra):
        return sum(jnp.sum(y * ra) + 0.5 * aux
                   for y, aux in run(all_ws, xa, ra))

    def aux_loss(all_ws, xa, ra):
        return sum(0.5 * aux for _, aux in run(all_ws, xa, ra))

    @jax.jit
    def ref(all_ws, xa, ra):
        ys = [y for y, _ in run(all_ws, xa, ra)]
        gw, gx = jax.grad(loss, argnums=(0, 1))(all_ws, xa, ra)
        return ys, gw, gx, jax.grad(aux_loss)(all_ws, xa, ra)

    jws = [[jnp.asarray(a) for a in w] for w in ws]
    ys, gw, gx, gaux = ref(jws, jnp.asarray(x), jnp.asarray(r))
    return dict(port=port, jax_y=[np.asarray(y) for y in ys],
                jax_gw=[[np.asarray(a) for a in w] for w in gw],
                jax_gx=np.asarray(gx),
                jax_gaux=[[np.asarray(a) for a in w] for w in gaux])


@pytest.mark.parametrize("i", range(len(LAYERS)), ids=_layer_id)
def test_moe_ffn_forward_and_gradients_equal_jax(layer_runs, i):
    """A layer's output (capacity ample, tokens dropped, two routing
    groups) and the gradients of ``sum(y · r) + 0.5 · aux`` for each
    parameter equal the JAX layer's."""
    run, got = layer_runs, layer_runs["port"][i]
    np.testing.assert_allclose(got["y"], run["jax_y"][i], atol=ATOL, rtol=0)
    for n, g, w in zip(NAMES, got["gw"], run["jax_gw"][i]):
        assert np.abs(w).max() > 0, n
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=1e-5, err_msg=n)


def test_moe_ffn_input_gradient_equals_jax(layer_runs):
    """The input's gradient, summed over the layers that all read it."""
    got = sum(p["gx"] for p in layer_runs["port"])
    np.testing.assert_allclose(got, layer_runs["jax_gx"], atol=ATOL,
                               rtol=1e-5)


@pytest.mark.parametrize("i", AUX_ONLY, ids=["top1", "top2"])
def test_aux_loss_gradient_reaches_the_router_alone(layer_runs, i):
    """The load-balance loss's gradient (tokens dropped) is the
    router's alone, and equals the JAX package's."""
    got, want = layer_runs["port"][i]["gaux"], layer_runs["jax_gaux"][i]
    for n, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=1e-5, err_msg=n)
        assert (np.abs(w).max() > 0) == (n == "Wg"), n


def test_moe_remat_recomputes_the_same_gradients():
    """``remat=True`` (the layer recomputed in the backward) gives the
    output and gradients of the layer that keeps its dispatch tensors."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(B, S, D).astype(np.float32))
    out = []
    for remat in (False, True):
        device.create_cpu_device().SetRandSeed(0)
        m = moe.MoEFFN(E, F, capacity_factor=0.5, remat=remat)
        xi = x.clone().requires_grad_()
        y = m(xi)
        loss = (y * y).sum() + m.last_aux_loss
        gs = torch.autograd.grad(loss, [xi] + [getattr(m, n)
                                               for n in NAMES])
        out.append([_np(y)] + [_np(g) for g in gs])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_moe_plan_and_top_k_refused():
    """A plan with an expert (or model, or seq) axis longer than 1 is
    refused: expert-parallel training is not ported; top_k past 2
    too."""
    from singa_tpu_torch.parallel import sharding

    for sizes in ((1, 1, 1, 1, 2), (1, 2, 1, 1, 1), (1, 1, 2, 1, 1)):
        plan = sharding.ShardingPlan(
            sharding.Mesh(sizes, rank=0, device="cpu"))
        with pytest.raises(NotImplementedError, match="plan"):
            moe.MoEFFN(E, F, plan=plan)
    with pytest.raises(ValueError, match="top_k"):
        moe.MoEFFN(E, F, top_k=3)


# -------------------------------------------------------- MoE GPT-2


def _cfg(cls, **kw):
    return cls.tiny(dropout=0.0, moe_every=2, **kw)


def _jax_shaped(m, ids, is_train):
    """``m.compile`` without running the model: the parameters get their
    shapes under ``jax.eval_shape`` (the device key is put back), and
    ``set_states`` or ``load_states`` then gives them values."""
    dev = jdevice.get_default_device()
    key = dev._rng_key
    try:
        jax.eval_shape(
            lambda a: m.compile([jtensor.Tensor(data=a)], is_train=is_train,
                                use_graph=is_train) or 0,
            jax.ShapeDtypeStruct(ids.shape, jnp.int32))
    finally:
        dev._rng_key = key
    return m


@pytest.fixture(scope="module")
def gpt(tmp_path_factory):
    """A tiny MoE GPT-2 (block 1 a 8-expert top-2 MoE) in both packages,
    SGD(0.1, 0.9) on both: the port's initial weights set into the JAX
    model, whose zip the port model then loads."""
    zpath = tmp_path_factory.mktemp("moe") / "jax.zip"
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, (3, 2, 16)).astype(np.int32)
    labels = np.roll(ids, -1, axis=2).astype(np.int32)
    labels[:, :, ::5] = -1
    cpu = device.create_cpu_device()
    cpu.SetRandSeed(0)
    tm = GPT2LMHead(_cfg(GPT2Config))
    tm.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    tm.compile([torch.from_numpy(ids[0])], is_train=True, use_graph=True)
    jm = JGPT2LMHead(_cfg(JGPT2Config))
    jm.set_optimizer(jopt.SGD(lr=0.1, momentum=0.9))
    _jax_shaped(jm, ids[0], True)
    jm.set_states({k: _np(v) for k, v in tm.get_states().items()})
    jm.save_states(str(zpath))
    tm.load_states(str(zpath))
    return dict(jm=jm, tm=tm, ids=ids, labels=labels, zip=zpath)


def test_moe_gpt2_state_names_and_zip_round_trip(gpt, tmp_path):
    """The MoE block's states carry the JAX names and layouts, and a zip
    goes JAX → port → zip → JAX bit for bit."""
    jm, tm = gpt["jm"], gpt["tm"]
    js = {k: np.asarray(jtensor.to_numpy(v))
          for k, v in jm.get_states().items()}
    ts = {k: _np(v) for k, v in tm.get_states().items()}
    assert set(js) == set(ts)
    mlp = "GPT2LMHead.transformer.blocks1.mlp."
    assert {k[len(mlp):]: v.shape for k, v in ts.items()
            if k.startswith(mlp)} == {
        "Wg": (64, 8), "W1": (8, 64, 128), "b1": (8, 128),
        "W2": (8, 128, 64), "b2": (8, 64)}
    back = tmp_path / "port.zip"
    tm.save_states(str(back))
    jm2 = _jax_shaped(JGPT2LMHead(_cfg(JGPT2Config)), gpt["ids"][0], False)
    jm2.load_states(str(back))
    for k, v in jm2.get_states().items():
        np.testing.assert_array_equal(np.asarray(jtensor.to_numpy(v)),
                                      js[k], err_msg=k)


def test_moe_gpt2_logits_equal_jax(gpt):
    jm, tm = gpt["jm"], gpt["tm"]
    x = gpt["ids"][0]
    jm.eval()
    tm.eval()
    try:
        want = np.asarray(jax.jit(lambda a: jm.forward(
            jtensor._wrap(a)).data)(jnp.asarray(x)))
        with torch.no_grad():
            got = _np(tm(torch.from_numpy(x)))
    finally:
        jm.train()
        tm.train()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_moe_gpt2_sgd_steps_equal_jax(gpt):
    """Two SGD steps from one zip (the loss with the weighted aux loss
    of the MoE block): losses and every state after each step; the second
    step starts from the JAX package's state (chained steps drift)."""
    jm, tm, ids, labels = gpt["jm"], gpt["tm"], gpt["ids"], gpt["labels"]
    for i in (1, 2):
        _, jl = jm(jtensor.from_numpy(ids[i]), jtensor.from_numpy(labels[i]))
        _, tl = tm(torch.from_numpy(ids[i]), torch.from_numpy(labels[i]))
        np.testing.assert_allclose(float(tl.detach()),
                                   float(jtensor.to_numpy(jl)), rtol=1e-5)
        js = {k: np.asarray(jtensor.to_numpy(v))
              for k, v in jm.get_states().items()}
        for k, v in tm.get_states().items():
            np.testing.assert_allclose(_np(v), js[k], atol=ATOL, rtol=0,
                                       err_msg=f"step {i} {k}")
        tm.set_states(js)
    assert len(tm.transformer.aux_losses()) == 1


# -------------------------------------------------------------- decode


@pytest.mark.parametrize("top_k", [1, 2])
def test_decode_moe_ffn_equals_jax(top_k):
    rng = np.random.RandomState(3)
    h = rng.randn(3, 5, D).astype(np.float32)
    p = dict(moe_wg=rng.randn(D, E), moe_w1=rng.randn(E, D, F) * 0.2,
             moe_b1=rng.randn(E, F) * 0.1, moe_w2=rng.randn(E, F, D) * 0.2,
             moe_b2=rng.randn(E, D) * 0.1)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want = jax.jit(jgd._moe_ffn, static_argnums=2)(
        jnp.asarray(h), {k: jnp.asarray(v) for k, v in p.items()}, top_k)
    got = gd._moe_ffn(torch.from_numpy(h),
                      {k: torch.from_numpy(v) for k, v in p.items()}, top_k)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=0)
    w = gd._moe_weights(torch.softmax(torch.from_numpy(h[..., :E]), -1),
                        top_k)
    assert torch.all((w > 0).sum(-1) == top_k)


@pytest.fixture(scope="module")
def served(gpt):
    """Eval-mode copies of the two packages' MoE models and their decode
    weights."""
    jm = _jax_shaped(JGPT2LMHead(_cfg(JGPT2Config)), gpt["ids"][0], False)
    jm.load_states(str(gpt["zip"]))
    tm = GPT2LMHead(_cfg(GPT2Config))
    tm.compile([torch.from_numpy(gpt["ids"][0])], is_train=False)
    tm.load_states(str(gpt["zip"]))
    return jm, tm


def test_moe_prefill_and_decode_step_equal_jax(served):
    jm, tm = served
    jp, tp = jgd.extract_params(jm), gd.extract_params(tm)
    assert "moe_wg" in tp["blocks"][1] and "w1" in tp["blocks"][0]
    cfg = tm.cfg
    ids = np.random.RandomState(5).randint(0, 256, (2, 9)).astype(np.int32)
    jh, jk, jv = jax.jit(jgd.prefill, static_argnums=(2, 3))(
        jp, jnp.asarray(ids), cfg.n_head, cfg.layer_norm_eps)
    th, tk, tv = gd.prefill(tp, torch.from_numpy(ids), cfg.n_head,
                            cfg.layer_norm_eps)
    for j, t in ((jh, th), (jk, tk), (jv, tv)):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=ATOL, rtol=0)


def _work(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, rng.randint(3, 20)).astype(np.int32),
             int(rng.randint(2, 12))) for _ in range(n)]


def test_moe_greedy_generate_equals_jax(served):
    jm, tm = served
    prompts = [p for p, _ in _work(6, 3)]
    for got, want in zip(tm.generate(prompts, max_new_tokens=7,
                                     temperature=0.0),
                         jm.generate(prompts, max_new_tokens=7,
                                     temperature=0.0)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.fixture(scope="module")
def jax_streams(served):
    """Greedy streams of the JAX paged engine on the MoE model."""
    jm, _ = served
    work = _work(7, 5)
    eng = jm.serve(max_slots=3, paged=JPagedConfig(block_size=8,
                                                   num_blocks=64))
    hs = [eng.submit(JRequest(p, max_new_tokens=n, temperature=0.0))
          for p, n in work]
    eng.run_until_complete(max_steps=2000)
    want = [np.asarray(h.result().tokens) for h in hs]
    eng.close()
    return work, want


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slots"])
def test_moe_engine_greedy_streams_equal_the_jax_engine(served, jax_streams,
                                                        paged):
    """The port's engine serves the MoE model on the paged and the slot
    arena; its greedy streams equal the JAX paged engine's and the port's
    offline ``generate``."""
    _, tm = served
    work, want = jax_streams
    kw = dict(paged=PagedConfig(block_size=8, num_blocks=64)) if paged \
        else {}
    teng = tm.serve(max_slots=3, **kw)
    ths = [teng.submit(GenerationRequest(p, max_new_tokens=n,
                                         temperature=0.0))
           for p, n in work]
    teng.run_until_complete(max_steps=2000)
    got = [h.result().tokens for h in ths]
    teng.close()
    for g, w, (p, n) in zip(got, want, work):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            g, tm.generate(p, max_new_tokens=n, temperature=0.0))
