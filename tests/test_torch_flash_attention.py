"""The port's flash attention (``singa_tpu_torch.ops.flash_attention``)
against the JAX package's Pallas flash kernels.

On the CPU the port's wrappers run their plain PyTorch versions and the
JAX kernels run in Pallas interpret mode, as tests/test_attention.py runs
them.  The same numpy inputs, made from a seed, go through both.

Tolerances (float32 throughout): O and lse atol 2e-5; gradients of q, k
and v atol 1e-4.  Both sides sum in float32 in different orders (one
full-row softmax in the port's plain version, online blocks in the
kernel), so they agree to a few float32 ulps of the O(1..10) values.

The CUDA kernels themselves cannot run on the CPU:
tests/test_torch_kernels_cuda.py holds them against the plain versions on
a GPU, and ``chip_smoke.py`` does so at GPT-2 small's shape.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from singa_tpu.ops.pallas import flash_attention as jfa
from singa_tpu_torch.ops import flash_attention as tfa

B, H = 2, 2
ATOL_OUT = 2e-5
ATOL_GRAD = 1e-4


def _inputs(s, d, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, s, d).astype(np.float32) for _ in range(3))
    # cotangents of o and of lse (nonzero dlse exercises δ = rowsum − dlse)
    go = rng.randn(B, H, s, d).astype(np.float32)
    glse = rng.randn(B, H, s).astype(np.float32)
    return (q, k, v), go, glse


def _jax_run(qkv, go, glse, mask, causal, window):
    """o, lse (None with a window: the JAX lse entry point takes none) and
    the gradients of sum(o·go) + sum(lse·glse) through the JAX kernels."""
    m = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        if window is not None:
            o = jfa.flash_attention(q, k, v, m, causal=causal, window=window)
            return o, None
        return jfa.flash_attention_lse(q, k, v, m, causal=causal)

    def loss(q, k, v):
        o, lse = f(q, k, v)
        out = jnp.sum(o * go)
        if lse is not None:
            out = out + jnp.sum(lse * glse)
        return out

    args = [jnp.asarray(a) for a in qkv]
    o, lse = f(*args)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return (np.asarray(o), None if lse is None else np.asarray(lse),
            [np.asarray(g) for g in grads])


def _torch_run(qkv, go, glse, mask, causal, window):
    q, k, v = (torch.tensor(a, requires_grad=True) for a in qkv)
    m = None if mask is None else torch.from_numpy(mask)
    o, lse = tfa.flash_attention_lse(q, k, v, m, causal=causal,
                                     window=window)
    loss = (o * torch.from_numpy(go)).sum()
    if window is None:
        loss = loss + (lse * torch.from_numpy(glse)).sum()
    grads = torch.autograd.grad(loss, (q, k, v))
    return (o.detach().numpy(), lse.detach().numpy(),
            [g.numpy() for g in grads])


def _key_mask(s, start):
    mask = np.zeros((B, 1, 1, s), np.float32)
    mask[:, :, :, start:] = -1e9
    return mask


def _general_mask(shape, seed=5):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _dead_row_mask(s):
    """Batch row 0 has every key masked to -inf: l = 0, so O = 0 and
    lse = NEG_INF in both packages (non-causal, S a multiple of 128, so
    JAX pads no tail keys)."""
    mask = np.zeros((B, 1, 1, s), np.float32)
    mask[0] = -np.inf
    return mask


CASES = {
    "causal": dict(s=128, d=64, causal=True),
    "non_causal": dict(s=128, d=64),
    "key_mask": dict(s=256, d=64, mask=_key_mask(256, 200)),
    "key_mask_causal": dict(s=128, d=64, mask=_key_mask(128, 100),
                            causal=True),
    "neg_inf_row": dict(s=128, d=64, mask=_dead_row_mask(128)),
    "general_mask_m1": dict(s=128, d=64, mask=_general_mask((128, 128)),
                            causal=True),
    "general_mask_mB": dict(s=128, d=64,
                            mask=_general_mask((B, 1, 128, 128))),
    "general_mask_mH": dict(s=128, d=64,
                            mask=_general_mask((1, H, 128, 128))),
    "general_mask_mBH": dict(s=128, d=64,
                             mask=_general_mask((B, H, 128, 128))),
    "window": dict(s=256, d=64, causal=True, window=80),
    "unaligned_s200": dict(s=200, d=64, causal=True),
    "unaligned_s200_non_causal": dict(s=200, d=64),
    "d96": dict(s=128, d=96, causal=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_matches_jax(name):
    kw = dict(CASES[name])
    s, d = kw.pop("s"), kw.pop("d")
    mask, causal = kw.pop("mask", None), kw.pop("causal", False)
    window = kw.pop("window", None)
    qkv, go, glse = _inputs(s, d, seed=sorted(CASES).index(name))
    jo, jlse, jgrads = _jax_run(qkv, go, glse, mask, causal, window)
    to, tlse, tgrads = _torch_run(qkv, go, glse, mask, causal, window)
    np.testing.assert_allclose(to, jo, atol=ATOL_OUT, rtol=0)
    if jlse is not None:
        np.testing.assert_allclose(tlse, jlse, atol=ATOL_OUT, rtol=0)
    for t, j, n in zip(tgrads, jgrads, "qkv"):
        np.testing.assert_allclose(t, j, atol=ATOL_GRAD, rtol=0,
                                   err_msg=f"d{n}")


WIDE = {
    "d640_causal": dict(s=64, d=640, causal=True),
    "d1024_key_mask": dict(s=48, d=1024, mask=_key_mask(48, 40)),
}


@pytest.mark.parametrize("name", sorted(WIDE))
def test_wide_heads_match_jax(name):
    """Heads past 512, which the card runs on the 8-row rung and the
    JAX kernel pads: the plain versions agree with it there too."""
    kw = dict(WIDE[name])
    s, d = kw.pop("s"), kw.pop("d")
    mask, causal = kw.pop("mask", None), kw.pop("causal", False)
    qkv, go, glse = _inputs(s, d, seed=100 + sorted(WIDE).index(name))
    jo, jlse, jgrads = _jax_run(qkv, go, glse, mask, causal, None)
    to, tlse, tgrads = _torch_run(qkv, go, glse, mask, causal, None)
    np.testing.assert_allclose(to, jo, atol=ATOL_OUT, rtol=0)
    if jlse is not None:
        np.testing.assert_allclose(tlse, jlse, atol=ATOL_OUT, rtol=0)
    for t, j, n in zip(tgrads, jgrads, "qkv"):
        np.testing.assert_allclose(t, j, atol=ATOL_GRAD, rtol=0,
                                   err_msg=f"d{n}")


def test_dead_row_gives_zero_output_and_floor_lse():
    qkv, _, _ = _inputs(128, 64, seed=0)
    o, lse = tfa.flash_attention_lse(
        *(torch.from_numpy(a) for a in qkv),
        torch.from_numpy(_dead_row_mask(128)))
    assert torch.all(o[0] == 0)
    assert torch.all(lse[0] == tfa.NEG_INF)
    assert torch.all(lse[1] > tfa.NEG_INF)


def test_neg_inf_floor_row_is_uniform():
    """A row masked only to the finite floor (−1e30) attends uniformly,
    exactly as the Pallas kernel does."""
    (q, k, v), _, _ = _inputs(128, 64, seed=1)
    mask = np.full((B, 1, 1, 128), -1e30, np.float32)
    o = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            torch.from_numpy(mask))
    want = np.broadcast_to(v.mean(axis=2, keepdims=True), v.shape)
    np.testing.assert_allclose(o.numpy(), want, atol=1e-5)
    jo = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL_OUT)


def test_window_requires_causal():
    qkv, _, _ = _inputs(128, 64, seed=0)
    q, k, v = (torch.from_numpy(a) for a in qkv)
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(q, k, v, window=32)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, k, v, causal=True, window=0)


def test_untileable_mask_raises():
    qkv, _, _ = _inputs(128, 64, seed=0)
    q, k, v = (torch.from_numpy(a) for a in qkv)
    with pytest.raises(ValueError, match="broadcastable"):
        tfa.flash_attention(q, k, v, torch.zeros(3, 1, 128, 128))


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors no kernel is launched: the counters stay put."""
    before = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    qkv, _, _ = _inputs(64, 32, seed=2)
    q, k, v = (torch.tensor(a, requires_grad=True) for a in qkv)
    tfa.flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == before


def test_plain_backward_matches_autograd_of_plain_forward():
    """The explicit dQ/dK/dV formulas equal torch autograd of the plain
    forward (o and lse both carrying a cotangent)."""
    (q, k, v), go, glse = _inputs(96, 48, seed=3)
    args = dict(kmask=None, qmask=None, qmap=None, scale=48 ** -0.5,
                causal=True, window=None)
    qt, kt, vt = (torch.tensor(a.reshape(B * H, 96, 48), requires_grad=True)
                  for a in (q, k, v))
    o, lse = tfa.flash_fwd_plain(qt, kt, vt, **args)
    go_t = torch.from_numpy(go.reshape(B * H, 96, 48))
    glse_t = torch.from_numpy(glse.reshape(B * H, 96))
    want = torch.autograd.grad((o * go_t).sum() + (lse * glse_t).sum(),
                               (qt, kt, vt))
    delta = (go_t * o.detach()).sum(-1) - glse_t
    bwd = (go_t, lse.detach(), delta)
    plain = (qt.detach(), kt.detach(), vt.detach())
    dq = tfa.flash_bwd_dq_plain(*plain, *args.values(), *bwd)
    dk, dv = tfa.flash_bwd_dkv_plain(*plain, *args.values(), *bwd)
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-5)
