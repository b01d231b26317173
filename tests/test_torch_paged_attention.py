"""The port's paged decode attention (``ops/paged_attention.py``) against
the JAX package's ``_paged_attn`` (``singa_tpu/models/gpt2_decode.py``).

``paged_attn_plain``, the plain version the kernel is held against on
the card, runs slot by slot against the JAX function on the inputs of
``chip_smoke.paged_edge_cases()`` (made with numpy from a seed): block
sizes 1 to 32, a partial final block, ``pos`` on a block boundary,
all-trash (dead) and one-block tables, GQA g = 3, D = 128, Q = 4 with a
tril ``cur_mask``, windows with and without ``blk_lo``, 1000-lane slots,
a long slot beside short ones, head dims 16, 20, 40, 80, 256, 640 and
1024, and GQA groups of more query rows than one launch holds (32 rows
at D = 64, 6 heads at D = 1024).  The port reads the tables to their
width (the kernel narrows that to the live blocks on the device); the
JAX function gets its engine's ``n_blk``, the longest slot's blocks.
float32, atol 1e-5: both sum the same float32 terms in another order
over at most 1000 lanes of values O(1).  The trash block holds
``chip_smoke.PAGED_TRASH_VALUE``, so a lane read unmasked moves an output
by O(10).  The wrapper's checks, which guard the kernel on the card, are
called directly on CPU tensors.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)
import jax.numpy as jnp
import torch

import chip_smoke
from singa_tpu.models.gpt2_decode import _paged_attn
from singa_tpu_torch.ops import paged_attention as pa

ATOL = 1e-5


@pytest.fixture(autouse=True)
def cpu_inputs(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", torch.device("cpu"))


def _jax_paged(a, window, blk_lo):
    """``_paged_attn`` slot by slot on the same inputs: (S, n_kv, g, Q, D)."""
    trash = a["pool_k"].shape[0] - 1
    block = a["pool_k"].shape[2]
    # the JAX engine's n_blk (singa_tpu/serve/paged.py:450)
    n_blk = max(-(-int(p) // block) for p in a["p_limit"])
    j = {k: jnp.asarray(a[k].numpy()) for k in
         ("q", "pool_k", "pool_v", "tables", "k_cur", "v_cur", "cur_mask")}
    out = []
    for s in range(a["q"].shape[0]):
        out.append(np.asarray(_paged_attn(
            j["q"][s], j["pool_k"], j["pool_v"], j["tables"][s],
            jnp.int32(int(a["p_limit"][s])), jnp.int32(n_blk), block,
            trash, j["k_cur"][s], j["v_cur"][s], j["cur_mask"], a["scale"],
            window=window,
            blk_lo=None if blk_lo is None else jnp.int32(blk_lo))))
    return np.stack(out)


CASES = [pytest.param(seed, name, kw, id=name)
         for seed, (name, kw) in enumerate(chip_smoke.paged_edge_cases())]


@pytest.mark.parametrize("seed,name,kw", CASES)
def test_plain_matches_jax(seed, name, kw):
    a = chip_smoke.paged_inputs(dtype=torch.float32, seed=seed, **kw)
    got = pa.paged_attn_plain(**a).numpy()
    want = _jax_paged(a, a["window"], a["blk_lo"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["window", "window_q4_g3"])
def test_window_without_blk_lo_matches_jax(name):
    """The window alone masks: reading from block 0 (``blk_lo`` None)
    gives what starting at the first in-window block gives."""
    seed, kw = next((i, kw) for i, (n, kw)
                    in enumerate(chip_smoke.paged_edge_cases()) if n == name)
    a = chip_smoke.paged_inputs(dtype=torch.float32, seed=seed, **kw)
    assert a["blk_lo"] > 0
    with_lo = pa.paged_attn_plain(**a)
    a["blk_lo"] = None
    got = pa.paged_attn_plain(**a).numpy()
    np.testing.assert_allclose(got, _jax_paged(a, a["window"], None),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, with_lo.numpy(), rtol=0, atol=ATOL)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    a = chip_smoke.paged_inputs(dtype=torch.float32, seed=0,
                                **chip_smoke.paged_edge_cases()[1][1])
    before = pa.paged_attn.launches
    assert torch.equal(pa.paged_attn(**a), pa.paged_attn_plain(**a))
    assert pa.paged_attn.launches == before


def test_bf16_plain_returns_the_pool_dtype():
    a = chip_smoke.paged_inputs(dtype=torch.bfloat16, seed=3,
                                **chip_smoke.paged_edge_cases()[3][1])
    out = pa.paged_attn_plain(**a)
    assert out.dtype == torch.bfloat16 and out.shape == a["q"].shape
    ref = pa.paged_attn_plain(**{k: (v.float() if torch.is_tensor(v)
                                     and v.is_floating_point() else v)
                                 for k, v in a.items()})
    # one bf16 rounding of outputs below 4
    assert (out.float() - ref).abs().max().item() <= 2 ** -6


def test_dead_slot_attends_only_its_current_lane():
    """All-trash table, p_limit 0, Q = 1: the output is v_cur exactly."""
    a = chip_smoke.paged_inputs(dtype=torch.float32, seed=4,
                                **chip_smoke.paged_edge_cases()[4][1])
    out = pa.paged_attn_plain(**a)
    for s in (0, 2):
        assert torch.equal(out[s, :, 0, 0], a["v_cur"][s, :, 0])


@pytest.mark.parametrize("change,err", [
    (dict(pool_k=torch.zeros(5, 2, 8, 64, dtype=torch.int8)), TypeError),
    (dict(d=1040), ValueError),
    (dict(nq=17), ValueError),
    (dict(tables_dtype=torch.int64), ValueError),
    (dict(blk_lo=99), ValueError),
    (dict(d=200, nq=5), ValueError),
])
def test_cuda_checks_refuse_what_the_kernel_does_not_take(change, err):
    """Past D = 1024, past 16 query positions (4 at D > 128), int8 pools
    and malformed tables raise, naming the limit."""
    kw = dict(lens=[9, 4], block=8, d=change.get("d", 64), n_kv=2,
              g=change.get("g", 1), nq=change.get("nq", 1))
    a = chip_smoke.paged_inputs(dtype=torch.float32, seed=0, **kw)
    if "pool_k" in change:
        a["pool_k"] = a["pool_v"] = change["pool_k"]
    if "tables_dtype" in change:
        a["tables"] = a["tables"].to(change["tables_dtype"])
    if "blk_lo" in change:
        a["blk_lo"] = change["blk_lo"]
    with pytest.raises(err):
        pa._check_cuda(a["q"], a["pool_k"], a["pool_v"], a["tables"],
                       a["p_limit"], a["k_cur"], a["v_cur"], a["cur_mask"],
                       a["blk_lo"])


@pytest.mark.parametrize("d,g,nq", [(16, 1, 1), (40, 3, 1), (96, 4, 4),
                                    (256, 2, 2), (512, 4, 1), (13, 1, 1),
                                    (640, 1, 1), (1024, 6, 1), (64, 8, 4),
                                    (200, 5, 4)])
def test_cuda_checks_take_every_head_dim_up_to_512(d, g, nq):
    """Every head dim up to ``MAX_HEAD_DIM`` (1024), and any GQA group:
    more query rows than a launch holds run in groups of heads."""
    a = chip_smoke.paged_inputs(lens=[9, 4], block=8, d=d, n_kv=2, g=g,
                                nq=nq, dtype=torch.bfloat16, seed=0)
    assert pa._check_cuda(a["q"], a["pool_k"], a["pool_v"], a["tables"],
                          a["p_limit"], a["k_cur"], a["v_cur"],
                          a["cur_mask"], a["blk_lo"]) == 1
