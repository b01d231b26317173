"""Fleets of sharded replicas on the port (``ServeFleet(tp=|ep=|pp=,
replicas=2)``, ``serve/shard.py``'s rank groups) against the JAX
package's fleets of the same replicas on its 8-device virtual mesh
(``tests/test_tp_serve.py``, ``test_ep_serve.py``, ``test_pp_serve.py``).

One 3-rank gloo group on the CPU (``tests/torch_serve_scenarios.py``):
rank 0 runs both replicas' engines and holds each one's first shard,
rank 1 is replica 0's second shard and rank 2 replica 1's.  While it
runs, the JAX fleets compute here from the same ``save_states`` zips:

* the streams of a 2-replica ``tp=2``, ``ep=2`` (an MoE model) and
  ``pp=2`` fleet, greedy and seeded-sampled, equal the JAX fleet's;
* the replicas' rank groups are their own: the only rank they share is
  the controller, and each has its own device and control group;
* a fleet too wide for the process group raises the JAX message
  (``exceeds``) before any metric registers, and a sharded fleet
  refuses ``add_replica``;
* the layout puts replica ``i``'s shards on cards ``[i S, (i + 1) S)``,
  and a fleet over NCCL or with several cards is refused typed
  (``FleetLayoutError``): rank 0 would drive a card of every replica.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from singa_tpu.serve import PagedConfig as JPaged
from singa_tpu.serve import ServeFleet as JServeFleet
from singa_tpu.serve import GenerationRequest as JRequest
from singa_tpu.models.gpt2 import GPT2Config as JConfig

import torch_serve_scenarios as scen
from singa_tpu_torch.serve import shard
from singa_tpu_torch.serve.shard import FleetLayoutError, fleet_layout
from singa_tpu_torch.serve.tp import fleet_tp_configs
from test_torch_tp_serve import _jax_model

WORLD = 3
MOE = dict(moe_every=2, moe_experts=4)
WORK = dict(seed=8, n=8)
FLEETS = {
    "tp": dict(shard=2, wide=(5, 2)),
    "ep": dict(shard=dict(ep=2), cfg=MOE, wide=(3, dict(ep=2, tp=2))),
    "pp": dict(shard=2, wide=(5, 2)),
}


def _jax_fleet(m, mode, knob, work):
    f = JServeFleet(m, replicas=2, max_slots=2,
                    paged=JPaged(**scen.PAGED), **{mode: knob})
    try:
        hs = [f.submit(JRequest(w["prompt"], max_new_tokens=w["n_new"],
                                temperature=w["temperature"],
                                seed=w["seed"])) for w in work]
        f.run_until_complete(max_steps=4000)
        return [h.result().tokens.tolist() for h in hs]
    finally:
        f.close()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The rank group's results and the JAX fleets' streams."""
    from singa_tpu.serve.ep import EPConfig as JEPConfig

    tmp = tmp_path_factory.mktemp("sharded_fleet")
    zips = {"dense": str(tmp / "dense.zip"), "moe": str(tmp / "moe.zip")}
    scenarios = [dict(name=f"fleet_{mode}", kind="fleet", mode=mode,
                      shard=f["shard"], cfg=f.get("cfg", {}), work=WORK,
                      wide=f["wide"],
                      zip=zips["moe" if "cfg" in f else "dense"])
                 for mode, f in FLEETS.items()]
    procs = scen.launch(tmp, WORLD, scenarios)
    try:
        dense = _jax_model()
        scen.save_zip(dense, zips["dense"])
        moe = _jax_model(JConfig.tiny(dropout=0.0, **MOE))
        scen.save_zip(moe, zips["moe"])
        work = scen.workload(**WORK)
        ref = {"tp": _jax_fleet(dense, "tp", 2, work),
               "ep": _jax_fleet(moe, "ep", JEPConfig(ep=2), work),
               "pp": _jax_fleet(dense, "pp", 2, work)}
    finally:
        scen.join(tmp, procs)
    return dict(tmp=tmp, jax=ref)


@pytest.mark.parametrize("mode", sorted(FLEETS))
def test_fleet_streams_equal_the_jax_fleets(group, mode):
    """Greedy and seeded-sampled streams of the 2-replica fleet equal the
    JAX fleet's, and both replicas carry traffic."""
    res = scen.results(group["tmp"], f"fleet_{mode}")
    assert res["tokens"] == group["jax"][mode]
    assert all(v > 0 for v in res["routed"].values()), res["routed"]


@pytest.mark.parametrize("mode", sorted(FLEETS))
def test_replica_rank_groups_are_disjoint(group, mode):
    res = scen.results(group["tmp"], f"fleet_{mode}")
    r0, r1 = res["ranks"]
    assert r0[0] == r1[0] == 0
    assert set(r0) & set(r1) == {0}
    assert sorted(r0[1:] + r1[1:]) == [1, 2]
    assert res["distinct_device_groups"]
    assert res["distinct_control_groups"]
    assert res["devices"] == ["None", "None"]   # the CPU: no card


@pytest.mark.parametrize("mode", sorted(FLEETS))
def test_fleet_too_wide_for_the_group_is_refused(group, mode):
    """The JAX validation (``exceeds``), raised before any metric
    registers."""
    res = scen.results(group["tmp"], f"fleet_{mode}")["wide"]
    assert res["type"] == "ValueError", res
    assert "exceeds" in res["msg"]
    assert res["leaked"] == []


def test_live_sharded_fleet_refuses_add_replica(group):
    """``tests/test_autoscale.py``'s case at tp = 2: the fleet's rank
    groups were partitioned at construction."""
    res = scen.results(group["tmp"], "fleet_tp")["add_replica"]
    assert res["type"] == "ValueError"
    assert "sharded" in res["msg"]


def test_replicas_get_disjoint_cards():
    """Shard ``j`` of replica ``i`` on card ``i S + j`` when the host has
    ``R S`` cards; every shard on one card when it has one."""
    assert fleet_layout((2,), 2, 4) == [((0, 1), (2,), [0, 1]),
                                       ((0, 2), (2,), [2, 3])]
    assert fleet_layout((2, 2), 2, 8) == [
        ((0, 1, 2, 3), (2, 2), [0, 1, 2, 3]),
        ((0, 4, 5, 6), (2, 2), [4, 5, 6, 7])]
    assert fleet_layout((2,), 2, 1) == [((0, 1), (2,), [0, 0]),
                                       ((0, 2), (2,), [0, 0])]
    assert fleet_layout((2,), 3, 0)[2] == ((0, 3), (2,), [None, None])


@pytest.mark.parametrize("backend,cards", [("nccl", 1), ("nccl", 4),
                                           ("gloo", 4)])
def test_fleet_layouts_not_run_are_refused_typed(monkeypatch, backend,
                                                 cards):
    """A 3-rank group over NCCL, or a model on one of several cards, is
    refused before the layout goes to any worker."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 3)
    monkeypatch.setattr(dist, "get_backend", lambda *a, **k: backend)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    sent = []
    monkeypatch.setattr(shard, "_send", lambda *a, **k: sent.append(a))
    with pytest.raises(FleetLayoutError, match="Queue A item 1"):
        fleet_tp_configs(2, 2, cuda=True)
    assert issubclass(FleetLayoutError, NotImplementedError)
    assert sent == []
