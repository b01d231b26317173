"""Expert-parallel serving on the port (``singa_tpu_torch/serve/ep.py``)
against the JAX package's ``serve(ep=)`` and the port's own
single-device engine.

One ep = 2 gloo group on the CPU (``tests/torch_serve_scenarios.py``)
runs every case on ``tests/test_ep_serve.py``'s 2-layer GPT-MoE (every
2nd block a 4-expert top-2 MoE) while the JAX references compute here:

* the layout: the port's per-rank slices of the decode weights, the
  stacked experts over ``ep`` (``shard_decode_params(ep_axis=)``), equal
  the JAX shards placed with ``decode_param_specs(ep_axis=)`` on the
  virtual mesh, exactly;
* float32 greedy streams of the ep = 2 paged engine equal the JAX ep = 2
  engine's from one ``save_states`` zip;
* against the port's single-device engine, token for token: cold (greedy
  and seeded mixed; paged and slot arena), int8, speculative with a
  dense draft, paged preempt-resume, warm prefix;
* the 2-D layout, ep = 2 × tp = 2 on a second group of four ranks
  (experts over ``ep``, the dense layers and the KV heads over ``tp``):
  cold and int8 streams against the single-device engine;
* a finite ``capacity_factor`` drops assignments, deterministically and
  counted; the per-expert load reaches the metrics and the stats and
  health sections; typed refusals before any metric; a supervisor
  restart past an injected ``serve.ep_dispatch`` fault.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding

from singa_tpu.models import gpt2_decode as jdecode
from singa_tpu.models.gpt2 import GPT2Config as JConfig
from singa_tpu.parallel.tensor_parallel import \
    decode_param_specs as jparam_specs
from singa_tpu.serve import PagedConfig as JPaged

import torch_serve_scenarios as scen
from singa_tpu_torch.models import gpt2_decode as tdecode
from singa_tpu_torch.parallel import sharding as shd
from singa_tpu_torch.parallel.tensor_parallel import shard_decode_params
from test_torch_tp_serve import _jax_model, _jax_run

WORLD = 2
MOE = dict(moe_every=2, moe_experts=4)
JAX_WORK = dict(seed=11, n=5, sampled=False)
ENGINE = dict(max_slots=2)

VARIANTS = [
    dict(id="jax", work=JAX_WORK, engine=ENGINE),
    dict(id="cold", work=dict(seed=0, n=6), engine=ENGINE),
    dict(id="slot", work=dict(seed=1, n=4), engine=dict(ENGINE, paged=None)),
    dict(id="int8", work=dict(seed=3, n=5),
         engine=dict(ENGINE, cache_dtype="int8")),
    dict(id="spec", work=dict(seed=4, n=5, n_lo=4, n_hi=12, sampled=False),
         engine=dict(max_slots=3, spec_k=3), draft=dict(n_layer=1)),
    dict(id="preempt",
         work=dict(seed=5, n=6, n_lo=12, n_hi=30, p_lo=4, p_hi=20),
         engine=dict(max_slots=4, paged=dict(num_blocks=10))),
    dict(id="warm", work=dict(warm=True, seed=6, n=5), two_pass=True,
         engine=dict(ENGINE, prefix_cache=dict(block_size=8,
                                               num_blocks=64))),
    dict(id="capacity", work=dict(seed=9, n=5, p_lo=16, p_hi=30),
         shard=dict(ep=2, capacity_factor=0.25), one=False, twice=True,
         engine=dict(ENGINE, paged=dict(num_blocks=48))),
]

REFUSALS = [
    dict(id="dense", engine=dict(ep=2)),
    dict(id="experts", cfg=dict(moe_every=2, moe_experts=3),
         engine=dict(ep=2)),
    dict(id="dense_tp", cfg=dict(MOE, n_head=4), engine=dict(
        ep=dict(ep=1, tp=3))),
    dict(id="cap_prefix", cfg=MOE, engine=dict(
        paged={}, prefix_cache=dict(block_size=8),
        ep=dict(ep=2, capacity_factor=1.0))),
    dict(id="ep_and_pp", cfg=MOE, engine=dict(paged={}, ep=2, pp=2)),
]

#: the (ep, tp) = (2, 2) layout, on a group of four ranks
EP_TP_SCENARIOS = [
    dict(name="ep_tp_parity", kind="parity", mode="ep",
         shard=dict(ep=2, tp=2), cfg=MOE, variants=[
             dict(id="cold", work=dict(seed=0, n=6), engine=ENGINE),
             dict(id="int8", work=dict(seed=3, n=5),
                  engine=dict(ENGINE, cache_dtype="int8"))]),
]

SCENARIOS = [
    dict(name="ep_parity", kind="parity", mode="ep", shard=2, cfg=MOE,
         variants=VARIANTS),
    dict(name="ep_refusals", kind="refusals", cases=REFUSALS),
    dict(name="ep_supervisor", kind="supervisor", mode="ep", shard=2,
         cfg=MOE, site="serve.ep_dispatch",
         work=dict(seed=7, n=6, n_lo=4, n_hi=10)),
    dict(name="ep_metrics", kind="metrics", mode="ep", shard=2, cfg=MOE,
         work=dict(seed=8, n=3)),
]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The rank groups' results (they start while the JAX model builds and
    wait for its zip) and the JAX ep = 2 engine's greedy streams."""
    tmp = tmp_path_factory.mktemp("ep_serve")
    zip_path = str(tmp / "jax.zip")
    tmp4 = tmp / "world4"
    tmp4.mkdir()
    for sc in SCENARIOS + EP_TP_SCENARIOS:
        sc.setdefault("zip", zip_path)
    procs = scen.launch(tmp, WORLD, SCENARIOS)
    procs4 = scen.launch(tmp4, 4, EP_TP_SCENARIOS)
    try:
        jm = _jax_model(JConfig.tiny(dropout=0.0, **MOE))
        scen.save_zip(jm, zip_path)
        ref = _jax_run(jm, scen.workload(**JAX_WORK), ep=2,
                       paged=JPaged(block_size=8, num_blocks=64), **ENGINE)
    finally:
        scen.join(tmp, procs)
        scen.join(tmp4, procs4)
    return dict(tmp=tmp, tmp4=tmp4, jax=ref, jm=jm, zip=zip_path)


def _res(group, name):
    return scen.results(group["tmp"], name)


def test_expert_slices_equal_jax_shards(group):
    """Each rank's slices of the MoE decode pytree, experts over ``ep``
    and the dense layers over ``tp`` = 1, equal the JAX shards."""
    jp = jdecode.extract_params(group["jm"])
    tp_ = tdecode.extract_params(scen.build(group["zip"], **MOE))
    mesh = JMesh(np.asarray(jax.devices()[:WORLD]).reshape(WORLD, 1),
                 ("ep", "tp"))
    spec = jparam_specs(jp, axis="tp", ep_axis="ep")
    placed = jax.tree.map(lambda a, s: jax.device_put(
        a, NamedSharding(mesh, s)), jp, spec)
    for r in range(WORLD):
        tmesh = shd.Mesh((WORLD, 1), ("ep", "tp"), rank=r, device="cpu")
        mine = shard_decode_params(tp_, tmesh, axis="tp", ep_axis="ep")
        dev = mesh.devices.flat[r]
        for blk, jblk in zip(mine["blocks"], placed["blocks"]):
            for k, v in jblk.items():
                if v is None or not hasattr(v, "addressable_shards"):
                    continue
                want = next(np.asarray(s.data) for s in v.addressable_shards
                            if s.device == dev)
                np.testing.assert_array_equal(blk[k].numpy(), want,
                                              err_msg=k)
        assert mine["blocks"][1]["moe_w1"].shape[0] == 2


def test_greedy_streams_equal_jax_ep2(group):
    res = _res(group, "ep_parity")["jax"]
    assert res["sharded"] == group["jax"]
    assert res["one"] == group["jax"]


@pytest.mark.parametrize("case", ["cold", "slot", "int8", "spec",
                                  "preempt", "warm"])
def test_streams_equal_single_device_engine(group, case):
    res = _res(group, "ep_parity")[case]
    assert res["sharded"] == res["one"]
    ep = res["snap"]["ep"]
    assert ep["shards"] == 2 and ep["experts_per_shard"] == 2
    assert ep["dropped_tokens"] == 0
    assert sum(ep["expert_tokens"]) > 0
    if case == "preempt":
        assert res["snap"]["paged"]["preemptions"] > 0
    if case == "warm":
        assert res["snap"]["prefix"]["hits"] > 0


@pytest.mark.parametrize("case", ["cold", "int8"])
def test_ep2_tp2_streams_equal_single_device_engine(group, case):
    """The 2-D layout: 2 experts a rank over ``ep``, the dense layers and
    the KV heads over ``tp`` (each rank's pool holds H_kv / 2 heads)."""
    res = scen.results(group["tmp4"], "ep_tp_parity")[case]
    assert res["sharded"] == res["one"]
    ep = res["snap"]["ep"]
    assert ep["shards"] == 2 and ep["dense_tp"] == 2
    assert ep["experts_per_shard"] == 2 and sum(ep["expert_tokens"]) > 0
    assert ep["kv_bytes_per_shard"] * 2 == \
        _res(group, "ep_parity")[case]["snap"]["ep"]["kv_bytes_per_shard"]


def test_capacity_drops_deterministic_and_counted(group):
    """A finite capacity_factor drops over-capacity assignments through
    the residual path: two fresh engines give the same streams and the
    same drop count, which is positive."""
    res = _res(group, "ep_parity")["capacity"]
    assert res["sharded"] == res["sharded2"]
    assert res["shard"]["dropped_tokens"] > 0
    assert res["shard"]["dropped_tokens"] == res["shard2"]["dropped_tokens"]
    assert res["shard"]["capacity_factor"] == 0.25


def test_expert_load_metrics_stats_and_health(group):
    res = _res(group, "ep_metrics")
    per_expert = [v for k, v in sorted(res["metrics"].items())
                  if k.startswith("serve.ep.expert_tokens")]
    assert len(per_expert) == 4 and sum(per_expert) > 0
    st = res["stats"]
    assert sorted(st["expert_tokens"]) == sorted(per_expert)
    assert st["load_imbalance"] is not None and st["load_imbalance"] >= 1
    h = res["health"]
    assert h["shards"] == 2 and sum(h["expert_tokens"]) >= sum(per_expert)
    assert h["load_imbalance"] is not None
    assert res["left"] == []


def test_refusals_typed_before_any_metric(group):
    res = _res(group, "ep_refusals")
    want = {
        "dense": ("ValueError", "on a dense model"),
        "experts": ("ValueError", "does not divide moe_experts"),
        "dense_tp": ("ValueError", "does not divide n_head"),
        "cap_prefix": ("ValueError", "capacity_factor AND a prefix_cache"),
        "ep_and_pp": ("ValueError", "not both"),
    }
    for case, (typ, msg) in want.items():
        got = res[case]
        assert got["type"] == typ and msg in got["msg"], (case, got)
        assert got["leaked"] == [], (case, got)


def test_supervisor_restart_past_ep_dispatch_fault(group):
    res = _res(group, "ep_supervisor")
    assert res["fired"] == 1 and res["restarts"] == 1
    done = 0
    for base, got in zip(res["base"], res["got"]):
        if "tokens" in got:
            assert got["tokens"] == base
            done += 1
        else:
            assert got["started"] is True
    assert done > 0
