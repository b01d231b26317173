"""Captured steps on the card: CUDA graphs of the training step and of
the serve engine's decode step, against the same steps run eagerly.

Every test is marked ``cuda`` and skips without a GPU.  On a machine with
one (from the repo root; ``--noconftest`` because ``tests/conftest.py``
imports JAX):

    python -m pytest tests/test_torch_graphs_cuda.py -m cuda --noconftest -q

A replay runs the kernels of the eager step in the same order on the
same memory, so float32 results agree to the bit; the test allows the
float32 tolerance of ``chip_smoke.py`` (rtol 1e-5) in case cuBLAS picks
another algorithm under capture.
"""

import numpy as np
import pytest
import torch

from singa_tpu_torch.ops import flash_attention as tfa
from singa_tpu_torch.ops import paged_attention as tpa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs exist only there")
    return torch.device("cuda")


def _tiny_pair(dropout=0.0, lr=0.1):
    from singa_tpu_torch import device, opt, tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    dev = device.create_cuda_gpu()
    ids = np.random.RandomState(1).randint(0, 256, (2, 64)).astype(np.int32)
    x = tensor.from_numpy(ids, dev)
    y = tensor.from_numpy(np.roll(ids, -1, axis=1).astype(np.int32), dev)
    models = []
    for use_graph in (False, True):
        dev.SetRandSeed(0)
        m = GPT2LMHead(GPT2Config.tiny(dropout=dropout, attn_impl="flash"))
        m.set_optimizer(opt.Adam(lr=lr))
        m.compile([x], is_train=True, use_graph=use_graph)
        if models:
            m.set_states(models[0].get_states())
        models.append(m)
    return models, x, y


@pytest.mark.cuda
def test_captured_training_equals_eager(cuda_device):
    """Five steps through the flash kernels, eager and graph mode from the
    same weights: equal losses and weights, and the flash launches of the
    replayed steps credited (3 kernels x 2 layers a step)."""
    (eager, graph), x, y = _tiny_pair()
    le = [eager(x, y)[1].item() for _ in range(5)]
    before = [f.launches for f in (tfa.flash_fwd, tfa.flash_bwd_dq,
                                   tfa.flash_bwd_dkv)]
    lg = [graph(x, y)[1].item() for _ in range(5)]
    moved = [f.launches - b for f, b in zip(
        (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv), before)]
    assert moved == [5 * graph.cfg.n_layer] * 3
    np.testing.assert_allclose(lg, le, rtol=1e-5)
    assert graph._graph_runner._entries and all(
        e.step.captured for e in graph._graph_runner._entries.values())
    for k, v in eager.get_states().items():
        torch.testing.assert_close(graph.get_states()[k], v, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.cuda
def test_a_replayed_step_never_syncs_with_the_host(cuda_device):
    """After a signature's eager first call and its capture, a call copies
    its inputs, replays and copies the outputs out without a host
    synchronisation (``torch.cuda.set_sync_debug_mode("error")`` raises
    on one)."""
    (_, graph), x, y = _tiny_pair()
    graph(x, y)
    graph(x, y)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, loss = graph(x, y)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert np.isfinite(loss.item())


@pytest.mark.cuda
def test_replays_draw_fresh_dropout_masks(cuda_device):
    """With lr 0, replays of one batch differ under dropout 0.1 (the
    device generator is registered with the graph) and agree without
    dropout."""
    for p, differ in ((0.1, True), (0.0, False)):
        (_, graph), x, y = _tiny_pair(dropout=p, lr=0.0)
        losses = [graph(x, y)[1].item() for _ in range(4)]
        assert (len(set(losses[1:])) == 3) == differ, (p, losses)


@pytest.mark.cuda
def test_captured_decode_equals_eager_decode(cuda_device):
    """The engine's captured decode steps give the eager engine's tokens
    (greedy and sampled, float32), launch ``paged_attn`` once a layer a
    step, and hold at most one graph per width bucket."""
    from singa_tpu_torch import device, tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from singa_tpu_torch.serve import (GenerationRequest, PagedConfig,
                                       jit_cache_size)

    dev = device.create_cuda_gpu()
    dev.SetRandSeed(0)
    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0, n_embd=128, n_head=2))
    m.compile([tensor.from_numpy(np.zeros((1, 8), np.int32), dev)],
              is_train=False)
    rng = np.random.RandomState(2)
    work = [(rng.randint(0, 256, rng.randint(3, 40)).astype(np.int32),
             int(rng.randint(2, 20)), t, int(rng.randint(0, 999)))
            for t in (0.0, 0.9, 0.0, 0.9, 0.0, 0.9, 0.0)]
    streams = {}
    for capture in (True, False):
        eng = m.serve(max_slots=4, paged=PagedConfig(block_size=8,
                                                     num_blocks=32),
                      capture=capture)
        before = tpa.paged_attn.launches
        hs = [eng.submit(GenerationRequest(p, max_new_tokens=n,
                                           temperature=t, seed=s))
              for p, n, t, s in work]
        eng.run_until_complete(max_steps=500)
        assert tpa.paged_attn.launches - before == \
            m.cfg.n_layer * eng.stats.decode_steps
        if capture:
            assert 0 < len(eng._steps) <= 3 and jit_cache_size() >= len(
                eng._steps)
            assert all(s.captured for s in eng._steps.values())
        streams[capture] = [h.result().tokens for h in hs]
        eng.close()
    for a, b in zip(streams[True], streams[False]):
        np.testing.assert_array_equal(a, b)
