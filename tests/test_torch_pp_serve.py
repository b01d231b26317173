"""Pipeline-parallel serving on the port (``singa_tpu_torch/serve/pp.py``)
against the JAX package's ``serve(pp=)`` and the port's own
single-device engine.

One pp = 2 gloo group on the CPU (``tests/torch_serve_scenarios.py``)
runs every case while the JAX reference computes here:

* float32 greedy streams of the pp = 2 paged engine equal the JAX pp = 2
  engine's from one ``save_states`` zip;
* ``tests/test_pp_serve.py``'s cases against the port's single-device
  paged engine, token for token: cold (greedy and seeded mixed), one
  microbatch a lane (``microbatches=4``), GQA, int8, warm prefix, paged
  preempt-resume, the chunked-prefill budget;
* each stage holds its layers and its layer slice of the pool; typed
  refusals before any metric; a supervisor restart past an injected
  ``serve.pp_boundary`` fault; the ``serve.pp.*`` metrics with the stats
  and health sections.
"""

import pytest

from singa_tpu.serve import PagedConfig as JPaged

import torch_serve_scenarios as scen
from test_torch_tp_serve import _jax_model, _jax_run

WORLD = 2
JAX_WORK = dict(seed=11, n=5, sampled=False)
ENGINE = dict(max_slots=2)

VARIANTS = [
    dict(id="jax", work=JAX_WORK, engine=ENGINE),
    dict(id="cold", work=dict(seed=0, n=7), engine=dict(max_slots=4)),
    dict(id="microbatches", work=dict(seed=1, n=5), engine=dict(max_slots=4),
         shard=dict(stages=2, microbatches=4)),
    dict(id="gqa", model="gqa", cfg=dict(n_kv_head=2),
         work=dict(seed=2, n=5, n_lo=6, n_hi=14, p_lo=4, p_hi=16),
         engine=dict(max_slots=3)),
    dict(id="int8", work=dict(seed=3, n=5),
         engine=dict(ENGINE, cache_dtype="int8")),
    dict(id="warm", work=dict(warm=True, seed=6, n=5), two_pass=True,
         engine=dict(ENGINE, prefix_cache=dict(block_size=8,
                                               num_blocks=64))),
    dict(id="preempt",
         work=dict(seed=5, n=6, n_lo=12, n_hi=30, p_lo=4, p_hi=20),
         engine=dict(max_slots=4, paged=dict(num_blocks=10))),
    dict(id="budget", work=dict(seed=6, n=4, p_lo=20, p_hi=40, n_lo=3,
                                n_hi=7),
         engine=dict(ENGINE, paged=dict(num_blocks=48,
                                        prefill_token_budget=16))),
]

REFUSALS = [
    dict(id="slot", engine=dict(paged=None, pp=2)),
    dict(id="gather", engine=dict(paged=dict(kernel="gather"), pp=2)),
    dict(id="draft", engine=dict(paged={}, pp=2), draft=dict(n_layer=1)),
    dict(id="moe", cfg=dict(moe_every=2, moe_experts=4),
         engine=dict(paged={}, pp=2)),
    dict(id="layers", cfg=dict(n_layer=3), engine=dict(paged={}, pp=2)),
    dict(id="window", cfg=dict(attn_window=16), engine=dict(paged={},
                                                            pp=2)),
]

SCENARIOS = [
    dict(name="pp_parity", kind="parity", mode="pp", shard=2,
         variants=VARIANTS),
    dict(name="pp_refusals", kind="refusals", cases=REFUSALS),
    dict(name="pp_supervisor", kind="supervisor", mode="pp", shard=2,
         site="serve.pp_boundary",
         work=dict(seed=7, n=6, n_lo=4, n_hi=10)),
    dict(name="pp_metrics", kind="metrics", mode="pp", shard=2,
         work=dict(seed=8, n=3)),
    dict(name="pp_slices", kind="slices", mode="pp", shard=2),
]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The rank group's results (it starts while the JAX model builds and
    waits for its zip) and the JAX pp = 2 engine's greedy streams."""
    tmp = tmp_path_factory.mktemp("pp_serve")
    zip_path = str(tmp / "jax.zip")
    for sc in SCENARIOS:
        sc.setdefault("zip", zip_path)
    procs = scen.launch(tmp, WORLD, SCENARIOS)
    try:
        jm = _jax_model()
        scen.save_zip(jm, zip_path)
        ref = _jax_run(jm, scen.workload(**JAX_WORK), pp=2,
                       paged=JPaged(block_size=8, num_blocks=64), **ENGINE)
    finally:
        scen.join(tmp, procs)
    return dict(tmp=tmp, jax=ref)


def _res(group, name):
    return scen.results(group["tmp"], name)


def test_greedy_streams_equal_jax_pp2(group):
    res = _res(group, "pp_parity")["jax"]
    assert res["sharded"] == group["jax"]
    assert res["one"] == group["jax"]


@pytest.mark.parametrize("case", ["cold", "microbatches", "gqa", "int8",
                                  "warm", "preempt", "budget"])
def test_streams_equal_single_device_engine(group, case):
    res = _res(group, "pp_parity")[case]
    assert res["sharded"] == res["one"]
    pp = res["snap"]["pp"]
    assert pp["stages"] == 2 and pp["layers_per_stage"] == 1
    assert pp["boundary_hops"] > 0
    if case == "microbatches":
        assert pp["microbatches"] == 4
    if case == "preempt":
        assert res["snap"]["paged"]["preemptions"] > 0
    if case == "warm":
        assert res["snap"]["prefix"]["hits"] > 0
    if case == "budget":
        assert res["snap"]["budget_chunks"] > 0


def test_stage_holds_its_layers_and_pool_slice(group):
    """Stage 0 holds layer 0 of the 2 and the (1, N + 1, H_kv, B, D)
    layer slice of the pool (int8: of the values and the scales)."""
    res = _res(group, "pp_slices")
    assert res["blocks_None"] == 1
    assert res["pool_None"] == [[1, 65, 4, 8, 16]]
    assert res["pool_int8"] == [[1, 65, 4, 8, 16], [1, 65, 4, 8]]


def test_refusals_typed_before_any_metric(group):
    res = _res(group, "pp_refusals")
    want = {
        "slot": ("ValueError", "pp= requires paged="),
        "gather": ("ValueError", "requires PagedConfig(kernel='block')"),
        "draft": ("ValueError", "pp= with a speculative draft"),
        "moe": ("ValueError", "on an MoE model"),
        "layers": ("ValueError", "does not divide n_layer"),
        "window": ("NotImplementedError", "sliding-window model"),
    }
    for case, (typ, msg) in want.items():
        got = res[case]
        assert got["type"] == typ and msg in got["msg"], (case, got)
        assert got["leaked"] == [], (case, got)


def test_supervisor_restart_past_pp_boundary_fault(group):
    res = _res(group, "pp_supervisor")
    assert res["fired"] == 1 and res["restarts"] == 1
    done = 0
    for base, got in zip(res["base"], res["got"]):
        if "tokens" in got:
            assert got["tokens"] == base
            done += 1
        else:
            assert got["started"] is True
    assert done > 0


def test_metrics_stats_and_health_sections(group):
    res = _res(group, "pp_metrics")
    m = res["metrics"]
    assert any(k.startswith("serve.pp.stages") and v == 2
               for k, v in m.items())
    assert any(k.startswith("serve.pp.boundary_hops") and v > 0
               for k, v in m.items())
    st = res["stats"]
    assert st["stages"] == 2 and st["microbatches"] == 2
    assert st["kv_bytes_per_stage"] > 0 and st["boundary_hops"] > 0
    h = res["health"]
    assert h["stages"] == 2 and h["boundary_hops"] >= st["boundary_hops"]
    assert res["left"] == []
