"""Captured steps in the port (``singa_tpu_torch/graphs.py``): graph-mode
training (``Model.compile(use_graph=True)``, ``train_n_batches``) and the
serve engine's captured decode steps, against the JAX package's graph
mode, on the CPU.

The CPU has no CUDA graphs, so the port's graph runner and the engine's
per-width step entries run the step function itself through the same
keys, static buffers and counters (the graphs themselves are held on the
card: ``tests/test_torch_graphs_cuda.py`` and ``chip_smoke.py``).  The
models carry the JAX weights across by ``set_states``; data comes from
numpy seeds.

Tolerances: the MLP of ``tests/test_model.py``, six steps, loss rtol
2e-4 and parameters rtol 2e-3 / atol 2e-5 against the JAX package (the
tolerances of its own graph-equals-eager test; the two packages sum in
float32 in other orders); the port's graph mode against its eager mode
bit for bit (on the CPU both run the same ops).  The sampling noise's χ²
gate: α = 0.001 over at most 15 degrees of freedom (37.70), the gate of
``tests/test_spec_serve.py``; everything is seeded, so it cannot flake.

The capturability guard runs one GPT-2 training step and one engine
decode step under a ``TorchDispatchMode`` that fails on any op that
reads a device value on the host or has a data-dependent shape: the ops
a CUDA graph cannot capture.  Only the kernels' plain versions, which the
card never runs, are exempt.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from singa_tpu import autograd as jautograd
from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models.mlp import MLP as JMLP
from singa_tpu.observe.registry import registry as jregistry
from singa_tpu_torch import device, opt, tensor
from singa_tpu_torch.models import gpt2_decode as gd
from singa_tpu_torch.models.mlp import MLP
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.observe.registry import registry
from singa_tpu_torch.ops import bottleneck as tbk
from singa_tpu_torch.ops import flash_attention as tfa
from singa_tpu_torch.ops import paged_attention as tpa
from singa_tpu_torch.serve import (GenerationRequest, PagedConfig,
                                   jit_cache_size)

import chip_smoke

CHI2_CRIT = 37.70  # α = 0.001, df = 15


@pytest.fixture(autouse=True)
def _restore_jax_training_flag():
    """JAX's Model.train/eval set a process-wide flag; leave it as found."""
    prev = jautograd.training
    yield
    jautograd.set_training(prev)


OPTS = {"sgd_momentum": lambda m: m.SGD(lr=0.05, momentum=0.9),
        "adam": lambda m: m.Adam(lr=1e-2)}


def _data(n=32, seed=0, k=None):
    rng = np.random.RandomState(seed)
    lead = () if k is None else (k,)
    return (rng.randn(*lead, n, 10).astype(np.float32),
            rng.randint(0, 10, size=lead + (n,)).astype(np.int32))


def _jax_mlp(use_graph, make_opt, seed=0):
    jdevice.get_default_device().SetRandSeed(seed)
    m = JMLP(data_size=10, perceptron_size=16, num_classes=10)
    m.set_optimizer(make_opt(jopt))
    m.compile([jtensor.from_numpy(_data()[0])], is_train=True,
              use_graph=use_graph)
    return m


def _port_mlp(use_graph, make_opt, states):
    m = MLP(data_size=10, perceptron_size=16, num_classes=10)
    m.set_optimizer(make_opt(opt))
    m.compile([tensor.from_numpy(_data()[0], device.create_cpu_device())],
              is_train=True, use_graph=use_graph)
    m.set_states(states)
    return m


def _trio(name, seed=0):
    """(JAX graph-mode MLP, port eager MLP, port graph-mode MLP), all
    holding the JAX model's initial weights."""
    jm = _jax_mlp(True, OPTS[name], seed)
    states = {k: jtensor.to_numpy(v) for k, v in jm.get_states().items()}
    return (jm, _port_mlp(False, OPTS[name], states),
            _port_mlp(True, OPTS[name], states))


def _jt(a):
    return jtensor.from_numpy(a)


def _tt(a):
    return tensor.from_numpy(a, device.create_cpu_device())


def _params_close(jm, tm):
    js, ts = jm.get_states(), tm.get_states()
    assert set(js) == set(ts)
    for k, v in js.items():
        np.testing.assert_allclose(tensor.to_numpy(ts[k]),
                                   jtensor.to_numpy(v), rtol=2e-3,
                                   atol=2e-5, err_msg=k)


# --------------------------------------------------------- graph training


@pytest.mark.parametrize("name", sorted(OPTS))
def test_graph_equals_eager_and_the_jax_graph_mode(name):
    """``tests/test_model.py::test_graph_equals_eager`` held across the
    packages: six steps of the port's graph mode equal its eager mode bit
    for bit and the JAX package's graph mode within its tolerance, losses
    and parameters, with SGD momentum and with Adam (whose bias
    correction reads the device step counter)."""
    jm, te, tg = _trio(name)
    x, y = _data(seed=3)
    for i in range(6):
        _, jl = jm(_jt(x), _jt(y))
        _, el = te(_tt(x), _tt(y))
        _, gl = tg(_tt(x), _tt(y))
        assert gl.item() == el.item(), f"graph != eager at step {i}"
        np.testing.assert_allclose(gl.item(), float(jtensor.to_numpy(jl)),
                                   rtol=2e-4, err_msg=f"step {i}")
    _params_close(jm, tg)
    for k, v in te.get_states().items():
        assert torch.equal(v, tg.get_states()[k]), k


def _counts(reg):
    return tuple(reg.counter(n).value for n in
                 ("graph.cache_hit", "graph.cache_miss", "train.steps"))


def test_cache_counts_equal_the_jax_runners():
    """The same calls give the same ``graph.cache_hit``,
    ``graph.cache_miss`` and ``train.steps`` counts in both packages: a
    new batch size is a miss (``tests/test_model.py:76``), and so is the
    first call after ``set_optimizer``."""
    jm, _, tg = _trio("sgd_momentum")
    j0, t0 = _counts(jregistry()), _counts(registry())
    calls = [32, 32, 32, 16, 16, "swap", 16, 32]
    for c in calls:
        if c == "swap":
            jm.set_optimizer(jopt.SGD(lr=0.01))
            tg.set_optimizer(opt.SGD(lr=0.01))
            continue
        x, y = _data(n=c, seed=c)
        _, jl = jm(_jt(x), _jt(y))
        _, tl = tg(_tt(x), _tt(y))
        assert tl.shape == () and np.isfinite(tl.item())
    jd = tuple(a - b for a, b in zip(_counts(jregistry()), j0))
    td = tuple(a - b for a, b in zip(_counts(registry()), t0))
    assert td == jd == (3, 4, 7)


@pytest.mark.parametrize("name", sorted(OPTS))
def test_step_counter_after_graph_steps_equals_the_jax_packages(name):
    jm, _, tg = _trio(name)
    x, y = _data(seed=5)
    for _ in range(4):
        jm(_jt(x), _jt(y))
        tg(_tt(x), _tt(y))
    js, ts = jm.optimizer.get_states(), tg.optimizer.get_states()
    assert float(ts["__step_counter__"]) == float(
        js["__step_counter__"]) == 4.0
    for k, v in js.items():
        np.testing.assert_allclose(ts[k], v, rtol=2e-3, atol=2e-5,
                                   err_msg=k)


def test_train_n_batches_equals_k_single_steps():
    """Stacked mode: K slices, K replays, the same losses and parameters
    as K single graph steps, and as the JAX package's scan over them."""
    k = 4
    jm, t1, t2 = _trio("sgd_momentum", seed=11)
    t1.compile([_tt(_data()[0])], is_train=True, use_graph=True)
    xs, ys = _data(k=k, seed=3)
    singles = [t1(_tt(xs[i]), _tt(ys[i]))[1].item() for i in range(k)]
    _, losses = t2.train_n_batches(_tt(xs), _tt(ys))
    _, jlosses = jm.train_n_batches(_jt(xs), _jt(ys))
    assert tuple(losses.shape) == (k,)
    assert losses.tolist() == singles
    np.testing.assert_allclose(losses.numpy(),
                               np.asarray(jtensor.to_numpy(jlosses)),
                               rtol=2e-4)
    for key, v in t1.get_states().items():
        assert torch.equal(v, t2.get_states()[key]), key
    _params_close(jm, t2)


def test_train_n_batches_output_stacking():
    _, _, tg = _trio("sgd_momentum")
    xs, ys = _data(k=3)
    out, losses = tg.train_n_batches(_tt(xs), _tt(ys))
    assert tuple(out.shape) == (3, 32, 10)
    assert tuple(losses.shape) == (3,)


def test_train_n_batches_requires_graph_and_training_mode():
    _, te, tg = _trio("sgd_momentum")
    xs, ys = _data(k=2)
    with pytest.raises(ValueError, match="use_graph"):
        te.train_n_batches(_tt(xs), _tt(ys))
    tg.eval()
    with pytest.raises(ValueError, match="training mode"):
        tg.train_n_batches(_tt(xs), _tt(ys))


def test_train_n_batches_mismatched_lead_dim():
    _, _, tg = _trio("sgd_momentum")
    xs, _ = _data(k=2)
    _, ys = _data(k=3)
    with pytest.raises(ValueError, match="leading steps dim"):
        tg.train_n_batches(_tt(xs), _tt(ys))


def test_train_n_batches_repeat_mode():
    """``n_steps=K`` with per-step inputs: the same batch K times, equal
    to K single graph steps and to the JAX package's repeat mode."""
    k = 4
    jm, t1, t2 = _trio("adam", seed=13)
    t1.compile([_tt(_data()[0])], is_train=True, use_graph=True)
    x, y = _data(seed=2)
    singles = [t1(_tt(x), _tt(y))[1].item() for _ in range(k)]
    _, losses = t2.train_n_batches(_tt(x), _tt(y), n_steps=k)
    _, jlosses = jm.train_n_batches(_jt(x), _jt(y), n_steps=k)
    assert losses.tolist() == singles
    np.testing.assert_allclose(losses.numpy(),
                               np.asarray(jtensor.to_numpy(jlosses)),
                               rtol=2e-4)


def test_outputs_are_fresh_tensors():
    """A later step does not rewrite what an earlier one returned (the
    static outputs are copied out, as the JAX step returns new
    arrays)."""
    _, _, tg = _trio("sgd_momentum")
    x, y = _data(seed=4)
    first = [tg(_tt(x), _tt(y)) for _ in range(3)]
    losses = [l.item() for _, l in first]
    assert len(set(losses)) == 3
    assert not first[1][1].requires_grad


# -------------------------------------------------- capturability guard


_SYNCING = {"aten::nonzero", "aten::_local_scalar_dense", "aten::item",
            "aten::masked_select", "aten::is_nonzero", "aten::argwhere",
            "aten::_unique2", "aten::unique_consecutive",
            "aten::repeat_interleave", "aten::lift_fresh"}
_INDEXING = {"aten::index", "aten::index_put", "aten::index_put_",
             "aten::_index_put_impl_"}


class _CaptureGuard(TorchDispatchMode):
    """Records every op a CUDA graph could not capture: a host read of a
    device value, a data-dependent output shape (``nonzero``, boolean
    masks), or a tensor made from host data (a host-to-device copy on
    the card).  Ops inside the kernels' plain versions are exempt."""

    def __init__(self):
        super().__init__()
        self.exempt = 0
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if not self.exempt:
            flat = [a for a in args if isinstance(a, (list, tuple))]
            bool_index = name in _INDEXING and any(
                isinstance(t, torch.Tensor) and t.dtype == torch.bool
                for lst in flat for t in lst)
            if name in _SYNCING or bool_index:
                self.bad.append(name)
        return func(*args, **(kwargs or {}))


@pytest.fixture
def guard(monkeypatch):
    g = _CaptureGuard()
    for mod, name in ((tfa, "flash_fwd_plain"), (tfa, "flash_bwd_dq_plain"),
                      (tfa, "flash_bwd_dkv_plain"), (tpa, "paged_attn_plain"),
                      (tbk, "megakernel_block_plain")):
        fn = getattr(mod, name)

        def exempt(*a, _fn=fn, **k):
            g.exempt += 1
            try:
                return _fn(*a, **k)
            finally:
                g.exempt -= 1

        monkeypatch.setattr(mod, name, exempt)
    return g


def test_guard_catches_what_capture_cannot_take(guard):
    x = torch.arange(6.0)
    with guard:
        x[x > 2] = 0.0
        torch.nonzero(x)
        float(x.sum())
    assert {"aten::index_put_", "aten::nonzero",
            "aten::_local_scalar_dense"} <= set(guard.bad)


def test_gpt2_training_step_is_capturable(guard):
    """The captured call of a graph-mode GPT-2 step (flash attention,
    Adam, labels with ignored positions) runs no op a graph cannot
    take."""
    cpu = device.create_cpu_device()
    cpu.SetRandSeed(0)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, (2, 32)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    labels[:, ::3] = -1
    m = GPT2LMHead(GPT2Config.tiny(dropout=0.1, attn_impl="flash"))
    m.set_optimizer(opt.Adam(lr=1e-3))
    m.compile([tensor.from_numpy(ids, cpu)], is_train=True, use_graph=True)
    x, y = tensor.from_numpy(ids, cpu), tensor.from_numpy(labels, cpu)
    m(x, y)                      # the eager first call of the key
    before = tfa.flash_fwd.launches
    with guard:
        _, loss = m(x, y)        # the call that captures, then replays
    assert guard.bad == [], guard.bad
    assert np.isfinite(loss.item())
    assert tfa.flash_fwd.launches == before  # plain versions on the CPU


@pytest.fixture(scope="module")
def tiny():
    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0))
    device.create_cpu_device().SetRandSeed(0)
    m.compile([tensor.from_numpy(np.zeros((1, 8), np.int32),
                                 device.create_cpu_device())],
              is_train=False)
    return m


def _work(seed, n, sampled=True):
    rng = np.random.RandomState(seed)
    return [dict(prompt=rng.randint(0, 256, rng.randint(3, 30))
                 .astype(np.int32), n_new=int(rng.randint(2, 12)),
                 temperature=(0.9 if sampled and i % 2 else 0.0),
                 seed=int(rng.randint(0, 10 ** 6))) for i in range(n)]


def _submit(eng, work):
    return [eng.submit(GenerationRequest(
        w["prompt"], max_new_tokens=w["n_new"],
        temperature=w["temperature"], seed=w["seed"])) for w in work]


def test_engine_decode_step_is_capturable(tiny, guard, monkeypatch):
    eng = tiny.serve(max_slots=4, paged=PagedConfig(block_size=8,
                                                    num_blocks=64))
    orig = eng._decode_once

    def guarded():
        with guard:
            orig()

    monkeypatch.setattr(eng, "_decode_once", guarded)
    _submit(eng, _work(1, 6))
    eng.run_until_complete(max_steps=200)
    assert eng.stats.decode_steps > 0
    assert guard.bad == [], guard.bad
    eng.close()


@pytest.mark.parametrize("cache_dtype", [None, "int8"], ids=["dense", "int8"])
def test_slot_arena_decode_step_is_capturable(tiny, guard, monkeypatch,
                                              cache_dtype):
    """The slot arena's step (every slot through the dense
    ``decode_step``, dead slots clamped) and the int8 writes run no op a
    graph cannot take."""
    eng = tiny.serve(max_slots=4, cache_dtype=cache_dtype)
    orig = eng._decode_once

    def guarded():
        with guard:
            orig()

    monkeypatch.setattr(eng, "_decode_once", guarded)
    _submit(eng, _work(1, 6))
    eng.run_until_complete(max_steps=200)
    assert eng.stats.decode_steps > 0
    assert guard.bad == [], guard.bad
    eng.close()


# ---------------------------------------------------------- serve capture


@pytest.mark.parametrize("capture", [True, False], ids=["captured", "eager"])
def test_engine_equals_generate(tiny, capture):
    """Greedy and sampled float32 streams of the captured-path engine (and
    of ``capture=False``) equal offline ``generate`` at each request's
    seed."""
    work = _work(2, 7)
    eng = tiny.serve(max_slots=4, paged=PagedConfig(block_size=8,
                                                    num_blocks=64),
                     capture=capture)
    hs = _submit(eng, work)
    eng.run_until_complete(max_steps=300)
    for h, w in zip(hs, work):
        want = tiny.generate(w["prompt"], max_new_tokens=w["n_new"],
                             temperature=w["temperature"], seed=w["seed"])
        np.testing.assert_array_equal(h.result().tokens, want)
    assert set(eng._steps) <= {4, 2, 1} and (len(eng._steps) > 0) == capture
    assert eng.paged_arena.blocks_used == 0
    eng.close()


@pytest.mark.parametrize("capture", [True, False], ids=["captured", "eager"])
def test_pressured_engine_equals_generate(tiny, capture):
    """A pool too small for every slot: priority-0 requests decode a few
    steps, then priority-1 ones preempt them (KV swapped to host memory)
    and all resume; every float32 stream, greedy and sampled, equals
    offline ``generate``, captured and eager."""
    work = _work(5, 8)
    eng = tiny.serve(max_slots=4, scheduler="priority",
                     paged=PagedConfig(block_size=4, num_blocks=12),
                     capture=capture)

    def submit(i):
        w = work[i]
        return eng.submit(GenerationRequest(
            w["prompt"], max_new_tokens=w["n_new"],
            temperature=w["temperature"], seed=w["seed"],
            priority=int(i >= 4)))

    hs = [submit(i) for i in range(4)]
    for _ in range(2):
        eng.step()
    hs += [submit(i) for i in range(4, 8)]
    eng.run_until_complete(max_steps=500)
    assert eng.paged_arena.snapshot()["preemptions"] > 0
    for h, w in zip(hs, work):
        want = tiny.generate(w["prompt"], max_new_tokens=w["n_new"],
                             temperature=w["temperature"], seed=w["seed"])
        np.testing.assert_array_equal(h.result().tokens, want)
    assert eng.paged_arena.blocks_used == 0
    eng.close()


def test_census_is_flat_after_warm_up(tiny):
    """``jit_cache_size()`` counts one prepared step per decode width an
    open engine has used; once every width has been used it does not
    grow, and closing the engine releases its steps."""
    base = jit_cache_size()
    eng = tiny.serve(max_slots=4, paged=PagedConfig(block_size=8,
                                                    num_blocks=64))
    _submit(eng, _work(3, 9))
    eng.run_until_complete(max_steps=300)
    warm = jit_cache_size() - base
    assert warm == len(eng._steps) == 3  # widths 4, 2 and 1
    _submit(eng, _work(4, 12))
    eng.run_until_complete(max_steps=400)
    assert jit_cache_size() - base == warm
    eng.close()
    assert jit_cache_size() == base


def test_decode_inputs_round_trip_through_the_staging_buffer():
    """One staged copy carries every field of a step: 64-bit seeds in two
    int32 halves (negative and past 2^32 too), temperatures as float32
    bits, and the tables; a narrower width reads the first lanes."""
    from singa_tpu_torch.serve.paged import DecodeInputs, seeds

    inp = DecodeInputs(4, 3, torch.device("cpu"))
    sd = np.array([5, 2 ** 40 + 7, -3, 2 ** 31 + 1])
    temps = np.array([0.9, 0.0, 1.5, 0.25], np.float32)
    tables = np.arange(12, dtype=np.int32).reshape(4, 3)
    inp.stage(np.array([1, 2, 3, 4]), np.array([9, 8, 7, 6]),
              np.array([True, False, True, True]), sd, temps, tables)
    inp.load()
    v = inp.view(4)
    assert seeds(v).tolist() == sd.tolist()
    assert v["temps"].numpy().tolist() == temps.tolist()
    assert v["toks"].tolist() == [1, 2, 3, 4]
    assert v["live"].tolist() == [1, 0, 1, 1]
    assert torch.equal(v["tables"], torch.from_numpy(tables))
    two = inp.view(2)
    assert two["pos"].tolist() == [9, 8] and two["tables"].shape == (2, 3)
    assert two["pos"].data_ptr() == v["pos"].data_ptr()


# -------------------------------------------------------------- sampling


def _chi2(counts, p):
    n = counts.sum()
    live = p > 0
    assert counts[~live].sum() == 0, "a filtered-out token was drawn"
    e = n * p[live]
    return float(((counts[live] - e) ** 2 / e).sum())


@pytest.mark.parametrize("filters", [dict(), dict(top_k=6),
                                     dict(top_p=0.8)],
                         ids=["plain", "top_k", "top_p"])
def test_batched_noise_draws_the_filtered_softmax(filters):
    """4000 rows of one 16-token distribution, one seed a row, in one
    batched draw: a χ² goodness-of-fit against the filtered softmax."""
    n, vocab, temp = 4000, 16, 0.8
    logit = np.random.RandomState(7).randn(vocab).astype(np.float32)
    logits = torch.from_numpy(np.tile(logit, (n, 1)))
    toks = gd._sample(logits, np.full(n, temp), np.arange(n) * 7919 + 3,
                      np.full(n, 40), **filters).numpy()
    filt = gd._filter_logits(torch.from_numpy(logit)[None], temp,
                             filters.get("top_p"), filters.get("top_k", 0))
    p = torch.softmax(filt[0].double(), -1).numpy()
    chi2 = _chi2(np.bincount(toks, minlength=vocab), p)
    assert chi2 < CHI2_CRIT, chi2


def test_noise_depends_on_seed_position_and_token_only():
    """A row's noise is the same alone and in a batch of 8, and changes
    with its seed, its position and the vocabulary index."""
    seeds = torch.tensor([5, 2 ** 40 + 5, 5, 9, -3, 5, 77, 5])
    pos = torch.tensor([10, 10, 11, 10, 10, 10, 10, 10])
    batch = gd._gumbel(seeds, pos, 64)
    for i in range(8):
        alone = gd._gumbel(seeds[i:i + 1], pos[i:i + 1], 64)
        assert torch.equal(alone[0], batch[i])
    assert torch.equal(batch[0], batch[5]) and torch.equal(batch[0],
                                                           batch[7])
    for i in (1, 2, 3, 4, 6):
        assert not torch.equal(batch[0], batch[i])
    assert len(set(batch[0].tolist())) == 64
    assert torch.isfinite(batch).all()


def test_greedy_rows_ignore_the_noise():
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(6, 50).astype(np.float32))
    temps = np.array([0.0, 1.0, 0.0, 0.5, 0.0, 2.0])
    toks = gd._sample(logits, temps, np.arange(6), np.arange(6))
    greedy = logits.argmax(-1)
    assert torch.equal(toks[temps == 0], greedy[temps == 0])


# ------------------------------------------------ paged bound on the device


@pytest.mark.parametrize("seed,name,kw", [
    pytest.param(seed, name, kw, id=name)
    for seed, (name, kw) in enumerate(chip_smoke.paged_edge_cases())
    if name in ("b8_partial_last_block", "dead_slots_all_trash", "window",
                "long_beside_short", "d1024_g6")])
def test_table_width_bound_equals_the_live_bound(monkeypatch, seed, name,
                                                 kw):
    """Reading the tables to their width gives, bit for bit, what reading
    them to the longest slot's block count gives (the JAX engine's
    ``n_blk``): a block with no live lane leaves the online softmax's
    state exactly as it was."""
    monkeypatch.setattr(chip_smoke, "DEVICE", torch.device("cpu"))
    a = chip_smoke.paged_inputs(dtype=torch.float32, seed=seed, **kw)
    block = a["pool_k"].shape[2]
    n_blk = max(-(-int(p) // block) for p in a["p_limit"])
    assert n_blk < a["tables"].shape[1]
    cut = dict(a, tables=a["tables"][:, :n_blk].contiguous())
    assert torch.equal(tpa.paged_attn_plain(**a),
                       tpa.paged_attn_plain(**cut))
