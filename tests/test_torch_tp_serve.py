"""Tensor-parallel serving on the port (``singa_tpu_torch/serve/tp.py``,
``serve/shard.py``) against the JAX package's ``serve(tp=)`` and the
port's own single-device engine.

One tp = 2 gloo group on the CPU (``tests/torch_serve_scenarios.py``:
rank 0 the controller, rank 1 a mirror) runs every case while the JAX
references compute here:

* the layout: the port's per-rank slices of the decode weights
  (``shard_decode_params``) and of a KV leaf (``decode_cache_spec``)
  equal the JAX shards of the same arrays placed with the JAX specs on
  the virtual mesh, exactly;
* float32 greedy streams of the tp = 2 paged engine equal the JAX tp = 2
  engine's, from one ``save_states`` zip;
* ``tests/test_tp_serve.py``'s cases against the port's single-device
  engine, token for token: cold (greedy and seeded mixed, paged and slot
  arena), GQA, int8 (values and scales sharded on axis 2), speculative
  with a replicated draft, paged preempt-resume, warm prefix; and the
  ring-attention prefill against the serial prefill;
* typed refusals raised before any metric registers, a supervisor
  restart past an injected ``serve.tp_collective`` fault, and the
  ``serve.tp.*`` metrics with the stats and health sections.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding

from singa_tpu import tensor as jtensor
from singa_tpu.models import gpt2_decode as jdecode
from singa_tpu.models.gpt2 import GPT2Config as JConfig
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2
from singa_tpu.parallel.tensor_parallel import (
    decode_cache_spec as jcache_spec, decode_param_specs as jparam_specs)
from singa_tpu.serve import GenerationRequest as JRequest
from singa_tpu.serve import PagedConfig as JPaged

import torch_serve_scenarios as scen
from singa_tpu_torch.models import gpt2_decode as tdecode
from singa_tpu_torch.parallel import sharding as shd
from singa_tpu_torch.parallel.tensor_parallel import (decode_cache_spec,
                                                      shard_decode_params)

WORLD = 2
JAX_WORK = dict(seed=11, n=5, sampled=False)
ENGINE = dict(max_slots=2)

VARIANTS = [
    dict(id="jax", work=JAX_WORK, engine=ENGINE),
    dict(id="cold", work=dict(seed=0, n=7), engine=ENGINE),
    dict(id="slot", work=dict(seed=1, n=4), engine=dict(ENGINE, paged=None)),
    dict(id="gqa", model="gqa", cfg=dict(n_kv_head=2),
         work=dict(seed=2, n=5, n_lo=6, n_hi=14, p_lo=4, p_hi=16),
         engine=dict(max_slots=3)),
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
    dict(id="warm_slot", work=dict(warm=True, seed=6, n=5), two_pass=True,
         engine=dict(ENGINE, paged=None, prefix_cache=dict(
             block_size=8, num_blocks=64))),
    dict(id="int8_slot", work=dict(seed=3, n=5),
         engine=dict(ENGINE, paged=None, cache_dtype="int8")),
    dict(id="ring", work=dict(seed=7, n=4, p_lo=40, p_hi=100, n_lo=4,
                              n_hi=9),
         shard=dict(tp=2, ring_prefill=True, ring_min_tokens=32),
         engine=dict(max_slots=2), generate=True),
]

REFUSALS = [
    dict(id="tp3", engine=dict(tp=3)),
    dict(id="tp_moe", cfg=dict(moe_every=2, moe_experts=4),
         engine=dict(tp=2)),
    dict(id="ring_slot", engine=dict(paged=None, tp=dict(
        tp=2, ring_prefill=True))),
    dict(id="ring_prefix", engine=dict(paged={}, prefix_cache=dict(
        block_size=8), tp=dict(tp=2, ring_prefill=True))),
    dict(id="ring_int8", engine=dict(paged={}, cache_dtype="int8",
                                     tp=dict(tp=2, ring_prefill=True))),
    dict(id="ranks", engine=dict(tp=dict(tp=2, devices=(1, 0)))),
    dict(id="ep_and_tp", cfg=dict(moe_every=2, moe_experts=4),
         engine=dict(tp=2, ep=2)),
    dict(id="pp_and_tp", engine=dict(paged={}, tp=2, pp=2)),
]

SCENARIOS = [
    dict(name="tp_parity", kind="parity", mode="tp", shard=2,
         variants=VARIANTS),
    dict(name="tp_refusals", kind="refusals", cases=REFUSALS),
    dict(name="tp_supervisor", kind="supervisor", mode="tp", shard=2,
         site="serve.tp_collective",
         work=dict(seed=7, n=6, n_lo=4, n_hi=10)),
    dict(name="tp_metrics", kind="metrics", mode="tp", shard=2,
         work=dict(seed=8, n=3)),
    dict(name="tp_slices", kind="slices", mode="tp", shard=2),
    dict(name="tp_capture", kind="capture"),
]


def _jax_model(cfg=None):
    m = JGPT2(cfg or JConfig.tiny(dropout=0.0))
    m.compile([jtensor.from_numpy(np.zeros((1, 16), np.int32))],
              is_train=False, use_graph=False)
    return m


def _jax_run(m, work, **kw):
    eng = m.serve(**kw)
    hs = [eng.submit(JRequest(w["prompt"], max_new_tokens=w["n_new"],
                              temperature=w["temperature"], seed=w["seed"]))
          for w in work]
    eng.run_until_complete(max_steps=4000)
    out = [h.result().tokens.tolist() for h in hs]
    eng.close()
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The rank group's results (it starts while the JAX model builds and
    waits for its zip) and the JAX tp = 2 engine's greedy streams."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    zip_path = str(tmp / "jax.zip")
    for sc in SCENARIOS:
        sc.setdefault("zip", zip_path)
    procs = scen.launch(tmp, WORLD, SCENARIOS)
    try:
        jm = _jax_model()
        scen.save_zip(jm, zip_path)
        ref = _jax_run(jm, scen.workload(**JAX_WORK), tp=2,
                       paged=JPaged(block_size=8, num_blocks=64), **ENGINE)
    finally:
        scen.join(tmp, procs)
    return dict(tmp=tmp, jax=ref, jm=jm, zip=zip_path)


def _res(group, name):
    return scen.results(group["tmp"], name)


def test_param_and_cache_slices_equal_jax_shards(group):
    """``shard_decode_params`` / ``decode_cache_spec`` cut every rank the
    slice the JAX specs place on its device, exactly."""
    jm = group["jm"]
    tm = scen.build(group["zip"])
    jp = jdecode.extract_params(jm)
    tp_ = tdecode.extract_params(tm)
    mesh = JMesh(np.asarray(jax.devices()[:WORLD]), ("tp",))
    jspec = jparam_specs(jp, axis="tp")
    placed = jax.tree.map(lambda a, s: jax.device_put(
        a, NamedSharding(mesh, s)), jp, jspec)
    kv = np.random.RandomState(0).randn(2, 9, 4, 8, 16).astype(np.float32)
    jkv = jax.device_put(kv, NamedSharding(mesh, jcache_spec("tp")))
    for r in range(WORLD):
        tmesh = shd.Mesh((WORLD,), ("tp",), rank=r, device="cpu")
        mine = shard_decode_params(tp_, tmesh, axis="tp")

        def jshard(a):
            return next(np.asarray(s.data) for s in a.addressable_shards
                        if s.device == mesh.devices.flat[r])

        for k in ("wte", "wpe", "lnf_s", "lnf_b"):
            np.testing.assert_array_equal(mine[k].numpy(),
                                          jshard(placed[k]))
        for blk, jblk in zip(mine["blocks"], placed["blocks"]):
            for k, v in jblk.items():
                np.testing.assert_array_equal(blk[k].numpy(), jshard(v),
                                              err_msg=k)
        np.testing.assert_array_equal(
            shd.shard_array(kv, tmesh, decode_cache_spec("tp")).numpy(),
            jshard(jkv))


def test_greedy_streams_equal_jax_tp2(group):
    """float32 greedy streams of the port's tp = 2 paged engine equal the
    JAX tp = 2 engine's on the virtual mesh, from one zip."""
    res = _res(group, "tp_parity")["jax"]
    assert res["sharded"] == group["jax"]
    assert res["one"] == group["jax"]


@pytest.mark.parametrize("case", ["cold", "slot", "gqa", "int8",
                                  "int8_slot", "spec", "preempt", "warm",
                                  "warm_slot"])
def test_streams_equal_single_device_engine(group, case):
    """Each ``tests/test_tp_serve.py`` case: the tp = 2 streams equal the
    port's single-device engine's token for token (greedy and seeded
    sampling mixed in one pool where the workload samples)."""
    res = _res(group, "tp_parity")[case]
    assert res["sharded"] == res["one"]
    snap = res["snap"]
    assert snap["tp"]["shards"] == 2
    assert snap["tp"]["sharded_dispatches"] > 0
    if case == "spec":
        assert snap["spec"]["chunks"] > 0
    if case == "preempt":
        assert snap["paged"]["preemptions"] > 0
        assert snap["paged"]["swap_in"] > 0
        assert snap["paged"]["blocks_used"] == 0
    if case in ("warm", "warm_slot"):
        assert snap["prefix"]["hits"] > 0


def test_ring_prefill_equals_serial_prefill(group):
    """Cold admissions of >= ring_min_tokens tokens prefill by ring
    attention over the tp ranks; the streams equal the serial prefill's
    (and ``generate``'s, greedy)."""
    res = _res(group, "tp_parity")["ring"]
    assert res["shard"]["ring_prefills"] == 4
    assert res["sharded"] == res["one"]
    greedy = [i for i, w in enumerate(scen.workload(seed=7, n=4, p_lo=40,
                                                    p_hi=100, n_lo=4,
                                                    n_hi=9))
              if w["temperature"] == 0.0]
    for i in greedy:
        assert res["sharded"][i] == res["generate"][i]


def test_int8_scales_shard_on_axis_2(group):
    """Each rank's pool holds H_kv / tp heads: the values (L, N + 1, H/2,
    B, D) and the int8 scales (L, N + 1, H/2, B) alike."""
    res = _res(group, "tp_slices")
    assert res["pool_None"] == [[2, 65, 2, 8, 16]]
    assert res["pool_int8"] == [[2, 65, 2, 8, 16], [2, 65, 2, 8]]


def test_refusals_typed_before_any_metric(group):
    res = _res(group, "tp_refusals")
    want = {
        "tp3": ("ValueError", "does not divide n_head"),
        "tp_moe": ("NotImplementedError", "tp= on an MoE model"),
        "ring_slot": ("ValueError", "ring_prefill requires paged="),
        "ring_prefix": ("ValueError", "ring_prefill with a prefix_cache"),
        "ring_int8": ("ValueError", "ring_prefill with cache_dtype='int8'"),
        "ranks": ("ValueError", "must be the process group's ranks"),
        "ep_and_tp": ("ValueError", "ep= together with tp="),
        "pp_and_tp": ("ValueError", "pp= together with tp="),
    }
    for case, (typ, msg) in want.items():
        got = res[case]
        assert got["type"] == typ, (case, got)
        assert msg in got["msg"], (case, got)
        assert got["leaked"] == [], (case, got)


def test_gloo_engine_on_the_card_refuses_capture(group):
    """A sharded engine whose weights are on the card over a gloo group
    raises with ``capture=True``, naming ``capture=False``, which passes
    (its steps run eagerly)."""
    res = _res(group, "tp_capture")
    assert res["True"]["type"] == "RuntimeError"
    assert "cannot be captured" in res["True"]["msg"]
    assert "capture=False" in res["True"]["msg"]
    assert res["False"]["type"] is None and "'tp'" in res["False"]["msg"]


def test_supervisor_restart_past_tp_collective_fault(group):
    """An injected ``serve.tp_collective`` fault fails the sharded engine
    mid-decode; the supervisor rebuilds it on the same ranks (the worker
    rebuilds its mirror) and requeued streams equal the single-device
    engine's; nothing is wedged."""
    res = _res(group, "tp_supervisor")
    assert res["fired"] == 1 and res["restarts"] == 1
    done = 0
    for base, got in zip(res["base"], res["got"]):
        if "tokens" in got:
            assert got["tokens"] == base
            done += 1
        else:
            assert got["started"] is True
    assert done > 0
    assert res["health"]["shards"] == 2


def test_metrics_stats_and_health_sections(group):
    res = _res(group, "tp_metrics")
    m = res["metrics"]
    assert any(k.startswith("serve.tp.shards") and v == 2
               for k, v in m.items())
    assert any(k.startswith("serve.tp.collectives_per_step") and v == 4
               for k, v in m.items())
    assert any(k.startswith("serve.tp.kv_bytes_per_shard") and v > 0
               for k, v in m.items())
    st = res["stats"]
    assert st["shards"] == 2 and st["devices"] == [0, 1]
    assert st["sharded_dispatches"] > 0 and st["kv_bytes_per_shard"] > 0
    assert res["health"]["shards"] == 2
    assert res["health"]["sharded_dispatches"] >= st["sharded_dispatches"]
    assert res["left"] == []
