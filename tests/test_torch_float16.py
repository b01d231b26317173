"""float16 through the port's kernels' plain paths, against the JAX
package, on the CPU (the kernels themselves are held against these plain
versions in float16 on the card: tests/test_torch_kernels_cuda.py,
``chip_smoke.py``, and through the emulator:
tests/test_torch_kernels_emulated.py).

* ``flash_attention_lse`` in float16 (the port's plain versions, which
  round p and dS to float16 where the kernels do) against the JAX
  package's Pallas flash kernels in float16 in interpret mode: O within
  2e-3 (one float16 rounding, 2^-11 relative, of values below 4), lse
  within 1e-4 (float32 in both), the gradients of q, k and v within 1e-2
  (sums of up to S terms of p and dS, both rounded to float16 at the
  same points, summed in other orders, then rounded to float16),
  causal, under a key mask and under a general mask;
* a tiny GPT-2 with ``attn_impl="flash"`` under
  ``amp.set_compute_dtype("float16")``: logits within 2e-2 of the JAX
  package's under its float16 amp, from the same weights (two blocks of
  float16 activations, logits O(1));
* ``paged_attn_plain`` in float16 against ``_paged_attn`` on the same
  float16 inputs at every ``chip_smoke.paged_edge_cases()`` case: within
  2e-3 (both sum in float32; the JAX function returns its float32 sums,
  the port rounds them to float16 once: one float16 ulp of values below
  4);
* the wrapper's checks take float16 q and pools (dtype code 4) and
  float16 q on int8 pools (code 5), as the C entry reads them.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
from singa_tpu import amp as jamp
from singa_tpu import autograd as jautograd
from singa_tpu import tensor as jtensor
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu.models.gpt2_decode import _paged_attn
from singa_tpu.ops.pallas import flash_attention as jfa
from singa_tpu_torch import amp, device, tensor
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.ops import flash_attention as tfa
from singa_tpu_torch.ops import paged_attention as pa

F16 = torch.float16


@pytest.fixture(autouse=True)
def _restore_flags():
    prev = jautograd.training
    yield
    jautograd.set_training(prev)
    amp.set_compute_dtype(None)
    jamp.set_compute_dtype(None)


def _masks(kind, b, h, s, rng):
    if kind == "key":
        m = np.zeros((b, 1, 1, s), np.float32)
        m[0, ..., s // 2:] = -1e9
        return m
    if kind == "general":
        return rng.randn(b, h, s, s).astype(np.float32)
    return None


@pytest.mark.parametrize("kind,causal", [(None, True), ("key", False),
                                         ("general", True)])
def test_flash_attention_lse_in_float16_matches_jax(kind, causal):
    b, h, s, d = 2, 2, 96, 32
    rng = np.random.RandomState(11)
    qkv = [rng.randn(b, h, s, d).astype(np.float16) for _ in range(3)]
    go = rng.randn(b, h, s, d).astype(np.float16)
    glse = rng.randn(b, h, s).astype(np.float32)
    mask = _masks(kind, b, h, s, rng)
    m = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        o, lse = jfa.flash_attention_lse(q, k, v, m, causal=causal)
        return (jnp.sum(o.astype(jnp.float32) * go.astype(np.float32))
                + jnp.sum(lse * glse)), (o, lse)

    (_, (jo, jlse)), jg = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(
        *[jnp.asarray(a) for a in qkv])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in qkv]
    o, lse = tfa.flash_attention_lse(
        *ts, None if mask is None else torch.from_numpy(mask),
        causal=causal)
    assert o.dtype == F16 and lse.dtype == torch.float32
    ((o.float() * torch.from_numpy(go).float()).sum()
     + (lse * torch.from_numpy(glse)).sum()).backward()
    np.testing.assert_allclose(o.detach().float().numpy(),
                               np.asarray(jo, np.float32), rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                               rtol=0, atol=1e-4)
    for name, t, g in zip("qkv", ts, jg):
        assert t.grad.dtype == F16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(g, np.float32), rtol=0,
                                   atol=1e-2, err_msg=f"d{name}")


def test_tiny_gpt2_flash_under_float16_amp_matches_jax():
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 256, (2, 32)).astype(np.int32)
    jm = JGPT2LMHead(JGPT2Config.tiny(dropout=0.0, attn_impl="flash"))
    jm.compile([jtensor.from_numpy(ids)], is_train=True, use_graph=False)
    cpu = device.create_cpu_device()
    tm = GPT2LMHead(GPT2Config.tiny(dropout=0.0, attn_impl="flash"))
    tm.compile([tensor.from_numpy(ids, cpu)], is_train=True)
    tm.set_states({k: jtensor.to_numpy(v)
                   for k, v in jm.get_states().items()})
    jm.eval()
    tm.eval()
    jamp.set_compute_dtype("float16")
    amp.set_compute_dtype("float16")
    want = np.asarray(jtensor.to_numpy(jm(jtensor.from_numpy(ids))),
                      np.float32)
    with torch.no_grad():
        got = tm(tensor.from_numpy(ids, cpu))
    assert got.dtype == F16
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def _jax_paged(a):
    trash = a["pool_k"].shape[0] - 1
    block = a["pool_k"].shape[2]
    n_blk = max(-(-int(p) // block) for p in a["p_limit"])
    j = {k: jnp.asarray(a[k].numpy()) for k in
         ("q", "pool_k", "pool_v", "tables", "k_cur", "v_cur", "cur_mask")}
    blk_lo = a["blk_lo"]
    return np.stack([np.asarray(_paged_attn(
        j["q"][s], j["pool_k"], j["pool_v"], j["tables"][s],
        jnp.int32(int(a["p_limit"][s])), jnp.int32(n_blk), block, trash,
        j["k_cur"][s], j["v_cur"][s], j["cur_mask"], a["scale"],
        window=a["window"],
        blk_lo=None if blk_lo is None else jnp.int32(blk_lo)))
        for s in range(a["q"].shape[0])])


@pytest.mark.parametrize("seed,name,kw", [
    pytest.param(seed, name, kw, id=name)
    for seed, (name, kw) in enumerate(chip_smoke.paged_edge_cases())])
def test_paged_attn_plain_in_float16_matches_jax(seed, name, kw,
                                                 monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", torch.device("cpu"))
    a = chip_smoke.paged_inputs(dtype=F16, seed=seed, **kw)
    got = pa.paged_attn_plain(**a)
    want = _jax_paged(a)
    assert got.dtype == F16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=0, atol=2e-3)


@pytest.mark.parametrize("quant,code", [(False, 4), (True, 5)],
                         ids=["float16_pools", "int8_pools"])
def test_cuda_checks_take_float16(quant, code, monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", torch.device("cpu"))
    a = chip_smoke.paged_inputs(lens=[9, 4], block=8, d=64, n_kv=2, g=3,
                                nq=2, dtype=F16, seed=0, quant=quant)
    assert pa._check_cuda(a["q"], a["pool_k"], a["pool_v"], a["tables"],
                          a["p_limit"], a["k_cur"], a["v_cur"],
                          a["cur_mask"], a["blk_lo"]) == code
    out = pa.paged_attn(**a)
    assert out.dtype == F16 and torch.isfinite(out.float()).all()
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        pa._check_cuda(a["q"].double(), a["pool_k"], a["pool_v"],
                       a["tables"], a["p_limit"], a["k_cur"], a["v_cur"],
                       a["cur_mask"], a["blk_lo"])
