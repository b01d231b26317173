"""Ring and zigzag attention on the port (``singa_tpu_torch/parallel/
ring_attention.py``) against the JAX package's rings under ``shard_map``.

The port's rings run in spawned gloo groups of W = 2 and W = 4 on the CPU
(``tests/torch_dist_worker.py`` with ``tests/torch_shard_scenarios.py``),
one launch a world size for every case; each rank takes its block of the
global q, k, v, and the outputs and the gradients of ``sum(o · w)`` are
gathered back.  The JAX package's rings run on W of the 8 virtual CPU
devices, differentiated by ``jax.grad``.  Cases: the contiguous ring,
causal and not, with a ragged -1e9 key-padding mask that rotates with its
K/V, a -inf mask over a whole rank's keys and over every key of a batch
row (those rows come out 0, with zero gradients, never NaN), the flash
wrappers (their plain versions on the CPU), the zigzag repartition and
its inverse, the zigzag ring and both ``*_sharded`` wrappers.  float32,
atol 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from singa_tpu.parallel import ring_attention as jra

import torch_shard_scenarios as scen
from singa_tpu_torch.parallel import ring_attention as ra

ATOL = 1e-5
B, H, D = 2, 2, 8
WORLDS = (2, 4)

#: name -> port case; a case with ``ref`` is held against that case's JAX
#: run (the same function: the flash wrappers, or a ``*_sharded`` wrapper)
CASES = {
    "causal": dict(layout="contiguous", causal=True),
    "noncausal": dict(layout="contiguous", causal=False),
    "keymask": dict(layout="contiguous", causal=False, mask="ragged"),
    "keymask_causal": dict(layout="contiguous", causal=True, mask="ragged"),
    "inf_shard": dict(layout="contiguous", causal=False, mask="inf_shard"),
    "inf_rows": dict(layout="contiguous", causal=False, mask="inf_rows"),
    "flash_causal": dict(layout="contiguous", causal=True, use_flash=True,
                         ref="causal"),
    "flash_keymask": dict(layout="contiguous", causal=False, mask="ragged",
                          use_flash=True, ref="keymask"),
    "zigzag": dict(layout="zigzag", causal=True),
    "zigzag_flash": dict(layout="zigzag", causal=True, use_flash=True,
                         ref="zigzag"),
    "zigzag_sharded": dict(layout="zigzag_sharded", causal=True,
                           ref="zigzag"),
    "sharded": dict(layout="sharded", causal=False, ref="noncausal"),
    "sharded_causal": dict(layout="sharded", causal=True, ref="causal"),
}


def _arrays(world):
    s = 8 * world
    rng = np.random.RandomState(world)
    q, k, v, w = (rng.randn(B, H, s, D).astype(np.float32)
                  for _ in range(4))
    ragged = np.zeros((B, 1, 1, s), np.float32)
    ragged[1, ..., -3:] = -1e9
    inf_shard = np.zeros((B, 1, 1, s), np.float32)
    inf_shard[..., -8:] = -np.inf   # the last rank's keys, every row
    inf_rows = np.zeros((B, 1, 1, s), np.float32)
    inf_rows[1] = -np.inf           # every key of batch row 1
    return dict(q=q, k=k, v=v, w=w, ragged=ragged, inf_shard=inf_shard,
                inf_rows=inf_rows)


def _jax_fn(world, causal, zigzag):
    """The JAX package's ring as one jitted ``(q, k, v, mask, w) -> (o,
    (dq, dk, dv))`` of ``sum(o · w)``: the contiguous ring with a key mask
    (zeros for none), or the zigzag ring (no mask)."""
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("seq",))
    spec, mspec = P(None, None, "seq", None), P(None, None, None, "seq")
    f = jax.shard_map(
        lambda q_, k_, v_, m_: jra.ring_self_attention(
            q_, k_, v_, "seq", causal=causal, kv_mask=m_),
        mesh=mesh, in_specs=(spec,) * 3 + (mspec,), out_specs=spec,
        check_vma=False)

    def loss(q, k, v, m, w):
        o = jra.zigzag_ring_attention_sharded(q, k, v, mesh=mesh) \
            if zigzag else f(q, k, v, m)
        return jnp.sum(o * w), o

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                      has_aux=True))


def _jax_all(world, d):
    """Every case's JAX output and gradients, three compiles: the
    contiguous ring causal and not (each case its mask) and zigzag."""
    fns = {}
    out = {}
    zero = np.zeros_like(d["ragged"])
    for name, case in CASES.items():
        if "ref" in case:
            continue
        key = (case["causal"], case["layout"] == "zigzag")
        if key not in fns:
            fns[key] = _jax_fn(world, *key)
        m = d[case["mask"]] if "mask" in case else zero
        (_, o), g = fns[key](*(jnp.asarray(d[n]) for n in "qkv"),
                             jnp.asarray(m), jnp.asarray(d["w"]))
        out[name] = dict(o=np.asarray(o), dq=np.asarray(g[0]),
                         dk=np.asarray(g[1]), dv=np.asarray(g[2]))
    return out


def _jax_repartition(world, x):
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("seq",))
    spec = P(None, None, "seq", None)
    fwd = jax.shard_map(lambda v: jra.zigzag_repartition(v, "seq"),
                        mesh=mesh, in_specs=(spec,), out_specs=spec,
                        check_vma=False)
    return np.asarray(fwd(jnp.asarray(x)))


def _group(tmp_path_factory, world):
    tmp = tmp_path_factory.mktemp(f"ring{world}")
    d = _arrays(world)
    np.savez(tmp / "data.npz", **d)
    cases = [dict(name=n, **{k: v for k, v in c.items() if k != "ref"})
             for n, c in CASES.items()]
    cases.append(dict(name="repartition", layout="repartition"))
    procs = scen.launch(tmp, world, [dict(kind="ring", name="ring",
                                          data=str(tmp / "data.npz"),
                                          cases=cases)])
    try:
        want = _jax_all(world, d)
        want["repartition"] = _jax_repartition(world, d["q"])
    finally:
        scen.join(tmp, procs)
    return dict(data=d, jax=want,
                ranks=scen.load_ranks(tmp, "ring", world))


@pytest.fixture(scope="module")
def ring2(tmp_path_factory):
    return _group(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def ring4(tmp_path_factory):
    return _group(tmp_path_factory, 4)


def _run(request, world):
    return request.getfixturevalue(f"ring{world}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_ring_equals_the_jax_ring(request, world, name):
    """Output and dQ/dK/dV of each case on every rank equal the JAX
    package's at float32 atol 1e-5."""
    run = _run(request, world)
    want = run["jax"][CASES[name].get("ref", name)]
    for r, got in enumerate(run["ranks"]):
        for part in ("o", "dq", "dk", "dv"):
            g = got[f"{name}/{part}"]
            assert np.isfinite(g).all(), (name, part, r)
            np.testing.assert_allclose(g, want[part], rtol=0, atol=ATOL,
                                       err_msg=f"{name} {part} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_fully_masked_rows_come_out_zero(request, world):
    """Rows whose every key is -inf: output 0 and no gradient into them,
    never NaN."""
    got = _run(request, world)["ranks"][0]
    assert np.all(got["inf_rows/o"][1] == 0.0)
    assert np.all(got["inf_rows/dq"][1] == 0.0)
    assert np.isfinite(got["inf_rows/o"]).all()


@pytest.mark.parametrize("world", WORLDS)
def test_zigzag_repartition_round_trips(request, world):
    """The repartition equals the global ``zigzag_order`` gather and the
    JAX package's repartition; its inverse gives the input back."""
    run = _run(request, world)
    x = run["data"]["q"]
    order = ra.zigzag_order(x.shape[2], world)
    np.testing.assert_array_equal(order, jra.zigzag_order(x.shape[2], world))
    for r, got in enumerate(run["ranks"]):
        np.testing.assert_array_equal(got["repartition/zigzag"],
                                      x[:, :, order], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["repartition/zigzag"],
                                      run["jax"]["repartition"])
        np.testing.assert_array_equal(got["repartition/back"], x)


def test_zigzag_order_and_balanced_work_equal_the_jax_package():
    for w in (2, 4, 8, 16, 64):
        np.testing.assert_array_equal(ra.zigzag_order(4 * w, w),
                                      jra.zigzag_order(4 * w, w))
        for layout in ("zigzag", "contiguous"):
            assert ra.ring_causal_half_pairs_per_rank(w, layout) == \
                jra.ring_causal_half_pairs_per_rank(w, layout)
        zz = ra.ring_causal_half_pairs_per_rank(w, "zigzag")
        assert len(set(zz)) == 1
        assert sum(zz) == sum(ra.ring_causal_half_pairs_per_rank(
            w, "contiguous"))
    with pytest.raises(ValueError):
        ra.zigzag_order(30, 4)
    with pytest.raises(ValueError):
        ra.ring_causal_half_pairs_per_rank(4, "striped")
