"""Sharded training on the port (``singa_tpu_torch/parallel/sharding.py``,
the tensor-parallel layers under a plan, the ring, ``Model``'s planned
step) against the JAX package's steps.

The port runs one process per rank: a W = 4 gloo group on the CPU
(``tests/torch_dist_worker.py`` with ``tests/torch_shard_scenarios.py``)
takes every scenario in one launch.  Each builds a model under a
``ShardingPlan`` over (dp, tp, sp) = (1, 2, 2), (2, 1, 2) or (1, 4, 1),
loads the JAX package's initial ``save_states`` zip (every rank slices
it), feeds the global batch (every rank takes its slice) and takes two
graph-mode SGD steps; its losses and its gathered states are held
against the JAX package's serial steps from the same zip, which
``tests/test_parallel.py`` holds equal to the JAX planned steps.  Models:
the JAX test's ``TinyLM`` (``tests/test_parallel.py:24-48``), tiny GPT-2
and tiny BERT, no dropout.  Tolerances are ``tests/test_parallel.py``'s:
losses rtol 2e-4 / atol 2e-5, states rtol 2e-3 / atol 2e-4.
"""

import json
import zipfile

import numpy as np
import pytest

from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models.bert import BertConfig as JBertConfig
from singa_tpu.models.bert import BertForMaskedLM as JBert
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2
from singa_tpu.parallel import sharding as jshd

import torch_shard_scenarios as scen
from test_parallel import TinyLM as JTinyLM

WORLD = 4
MESHES = ((1, 2, 2), (2, 1, 2), (1, 4, 1))
MODELS = ("tinylm", "gpt2", "bert")
VOCABS = {"tinylm": scen.VOCAB, "gpt2": 256, "bert": 1000}
B, S, STEPS, MULTI_STEPS = 4, 16, 2, 3
SGD = dict(lr=0.1, momentum=0.9)
#: clipping by the global norm over every shard (a norm the steps reach)
CLIP_SGD = dict(lr=0.5, momentum=0.9, clip_norm=0.05)
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
STATE_TOL = dict(rtol=2e-3, atol=2e-4)


def _jax_model(kind):
    if kind == "tinylm":
        return JTinyLM(plan=None)
    if kind == "gpt2":
        return JGPT2(JGPT2Config.tiny(dropout=0.0))
    return JBert(JBertConfig.tiny(hidden_dropout=0.0, attn_dropout=0.0))


def _data(kind, seed):
    rng = np.random.RandomState(seed)
    shape = (MULTI_STEPS, B, S)
    return (rng.randint(0, VOCABS[kind], shape).astype(np.int32),
            rng.randint(0, VOCABS[kind], shape).astype(np.int32))


def _jax_build(kind, x0, sgd=SGD):
    dev = jdevice.get_default_device()
    dev.SetRandSeed(5)
    m = _jax_model(kind)
    m.set_optimizer(jopt.SGD(**sgd))
    m.compile([jtensor.from_numpy(x0, dev)], is_train=True, use_graph=True)
    return m


def _jax_states(m):
    out = {f"state/{k}": np.asarray(jtensor.to_numpy(v))
           for k, v in m.get_states().items()}
    out.update({f"opt/{k}": np.asarray(v)
                for k, v in m.optimizer.get_states().items()})
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The W = 4 group's results, the JAX runs' losses and states (after
    ``STEPS`` and, for ``TinyLM``, ``MULTI_STEPS``) and the zips."""
    tmp = tmp_path_factory.mktemp("shard_train")
    jdev = jdevice.get_default_device()
    scenarios, runs = [], {}
    for i, kind in enumerate(MODELS):
        xs, ys = _data(kind, seed=i)
        m = _jax_build(kind, xs[0])
        zpath, dpath = tmp / f"{kind}_jax.zip", tmp / f"{kind}_data.npz"
        m.save_states(str(zpath))
        np.savez(dpath, xs=xs, ys=ys)
        runs[kind] = dict(m=m, xs=xs, ys=ys, zip=zpath)
        for mesh in MESHES:
            scenarios.append(dict(
                kind="train", name=f"{kind}_{''.join(map(str, mesh))}",
                model=kind, mesh=mesh, sgd=SGD, steps=STEPS, zip=str(zpath),
                data=str(dpath)))
    scenarios.append(dict(kind="train", name="tinylm_multi", model="tinylm",
                          mesh=(2, 1, 2), sgd=SGD, steps=MULTI_STEPS,
                          multi=True, zip=str(runs["tinylm"]["zip"]),
                          data=str(tmp / "tinylm_data.npz")))
    scenarios.append(dict(kind="train", name="tinylm_clip", model="tinylm",
                          mesh=(1, 2, 2), sgd=CLIP_SGD, steps=STEPS,
                          zip=str(tmp / "tinylm_clip_jax.zip"),
                          data=str(tmp / "tinylm_data.npz")))
    scenarios.append(dict(kind="refusals", name="refusals"))
    xs, ys = _data("tinylm", seed=0)
    clip = _jax_build("tinylm", xs[0], CLIP_SGD)
    clip.save_states(str(tmp / "tinylm_clip_jax.zip"))
    procs = scen.launch(tmp, WORLD, scenarios)
    try:
        clip_losses = [float(jtensor.to_numpy(clip(
            jtensor.from_numpy(xs[i], jdev),
            jtensor.from_numpy(ys[i], jdev))[1])) for i in range(STEPS)]
        runs["tinylm_clip"] = dict(losses=np.asarray(clip_losses),
                                   states=_jax_states(clip))
        for kind in MODELS:
            run = runs[kind]
            m, xs, ys = run.pop("m"), run.pop("xs"), run.pop("ys")
            losses = []
            for i in range(MULTI_STEPS if kind == "tinylm" else STEPS):
                _, loss = m(jtensor.from_numpy(xs[i], jdev),
                            jtensor.from_numpy(ys[i], jdev))
                losses.append(float(jtensor.to_numpy(loss)))
                if i + 1 == STEPS:
                    run["states"] = _jax_states(m)
            run["losses"] = np.asarray(losses)
            if kind == "tinylm":
                run["multi_states"] = _jax_states(m)
    finally:
        scen.join(tmp, procs)
    out = dict(tmp=tmp, jax=runs)
    for sc in scenarios[:-1]:
        out[sc["name"]] = scen.load_ranks(tmp, sc["name"], WORLD)
    out["refusals"] = [json.loads((tmp / f"refusals_r{r}.json").read_text())
                       for r in range(WORLD)]
    return out


def _check(ranks, losses, states):
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], losses, **LOSS_TOL,
                                   err_msg=f"rank {r} losses")
        assert {k for k in got if k.startswith(("state/", "opt/"))} \
            == set(states), f"rank {r}"
        for k, v in states.items():
            np.testing.assert_allclose(got[k], v, **STATE_TOL,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "dp%d_tp%d_sp%d" % m)
@pytest.mark.parametrize("kind", MODELS)
def test_planned_steps_equal_the_jax_package(group, kind, mesh):
    """Two planned steps from the JAX zip: every rank's losses (the
    global batch's mean) and gathered states (parameters and momentum)
    equal the JAX package's."""
    run = group["jax"][kind]
    _check(group[f"{kind}_{''.join(map(str, mesh))}"], run["losses"][:STEPS],
           run["states"])


def test_clip_norm_under_a_plan(group):
    """``clip_norm`` at (1, 2, 2): the global norm counts every shard
    once, so the clipped steps equal the JAX package's."""
    run = group["jax"]["tinylm_clip"]
    _check(group["tinylm_clip"], run["losses"], run["states"])


def test_train_n_batches_under_a_plan(group):
    """``train_n_batches`` over 3 stacked global batches at (2, 1, 2)
    equals 3 single JAX steps."""
    run = group["jax"]["tinylm"]
    _check(group["tinylm_multi"], run["losses"], run["multi_states"])


def test_local_shapes_are_the_specs_slices(group):
    """Each rank holds its slice: at tp = 4 the vocab-parallel table and
    the column weights a quarter of their rows or columns, the layer
    norms whole."""
    shapes = json.loads(str(group["tinylm_141"][1]["local_shapes"]))
    assert shapes["TinyLM.embed.W"] == [scen.VOCAB // 4, scen.HIDDEN]
    assert shapes["TinyLM.blocks0.attn.q_proj.W"] == [scen.HIDDEN,
                                                      scen.HIDDEN // 4]
    assert shapes["TinyLM.blocks0.mlp.fc2.W"] == [scen.INTER // 4,
                                                  scen.HIDDEN]
    assert shapes["TinyLM.blocks0.ln1.scale"] == [scen.HIDDEN]


def test_param_specs_equal_the_jax_layers(group):
    """The parameters' specs equal those the JAX layers give (a planned
    JAX ``TinyLM`` compiled on the 8-device mesh)."""
    plan = jshd.ShardingPlan(jshd.create_mesh(dp=2, tp=2, sp=2))
    m = JTinyLM(plan=plan)
    m.set_sharding_plan(plan)
    m.set_optimizer(jopt.SGD(lr=0.1))
    x = jtensor.from_numpy(_data("tinylm", 0)[0][0])
    m.compile([x], is_train=True, use_graph=True)
    want = {n: [list(e) if isinstance(e, tuple) else e
                for e in getattr(t, "partition_spec", None) or ()]
            for n, t in m.get_params().items()}
    got = json.loads(str(group["tinylm_122"][0]["specs"]))
    assert got == want


@pytest.mark.parametrize("kind", MODELS)
def test_save_states_zip_loads_into_the_jax_package(group, kind):
    """A planned rank's ``save_states`` zip (gathered global arrays)
    loads into the JAX package's serial model and gives its final
    states; the zip of every rank is the same."""
    name = f"{kind}_122"
    path = group["tmp"] / f"{name}_r0.zip"
    with zipfile.ZipFile(path) as zf:
        assert all(n.endswith(".npy") for n in zf.namelist())
    xs, _ = _data(kind, seed=MODELS.index(kind))
    m = _jax_build(kind, xs[0])
    m.load_states(str(path))
    got = _jax_states(m)
    want = group["jax"][kind]["states"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **STATE_TOL, err_msg=k)
    for r in range(1, WORLD):
        other = np.load(group["tmp"] / f"{name}_r{r}.zip")
        first = np.load(path)
        for k in first.files:
            np.testing.assert_array_equal(other[k], first[k], err_msg=k)


@pytest.mark.parametrize("what", ["plan_then_distopt", "distopt_then_plan"])
def test_distopt_with_a_plan_raises(group, what):
    for r in range(WORLD):
        assert "mutually exclusive" in group["refusals"][r][what]


def test_undivided_vocab_raises_naming_table_and_axis(group):
    """A 255-row table at tp = 4 raises ``ValueError`` naming the table
    and the model axis; nothing is padded."""
    msg = group["refusals"][0]["undivided_vocab"]
    assert "wte.W" in msg and "model" in msg and "255" in msg


def test_decoding_a_sharded_model_raises():
    """``generate`` and ``serve`` read whole weights: a model sharded over
    more than one rank raises, naming the way out (its zip into a
    plan-less model)."""
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    plan = scen.shd.ShardingPlan(scen.shd.Mesh((1, 2, 1, 1, 1), rank=0,
                                               device="cpu"))
    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0), plan)
    with pytest.raises(NotImplementedError, match="without a plan"):
        m.generate([1, 2, 3], max_new_tokens=2)
    with pytest.raises(NotImplementedError, match="2 ranks"):
        m.serve()


def test_window_on_the_ring_raises():
    """A sliding window has no ring path (as in the JAX package): a seq
    axis of 2 refuses it at the attention, before any hop."""
    import torch

    from singa_tpu_torch.parallel.tensor_parallel import ParallelMHA

    plan = scen.shd.ShardingPlan(scen.shd.Mesh((1, 1, 2, 1, 1), rank=0,
                                               device="cpu"))
    mha = ParallelMHA(4, plan, causal=True, window=4)
    assert mha.seq_parallel
    with pytest.raises(NotImplementedError, match="sliding-window"):
        mha(torch.zeros(2, 8, 16))


# -------------------------------------- chip_smoke.py's shard gates


@pytest.fixture(scope="module")
def smoke_faults(tmp_path_factory):
    """``chip_smoke.py``'s shard phase at its CPU shapes (two gloo ranks,
    tiny GPT-2 at sp = 2 and tiny BERT at tp = 2, the ring cases), with
    every planted fault, as ``--shard-faults`` runs it on the card: rank
    0's report."""
    import os

    import torch

    import chip_smoke

    saved = chip_smoke.SHARD_DIR, os.environ.get("OMP_NUM_THREADS")
    chip_smoke.SHARD_DIR = str(tmp_path_factory.mktemp("shard_smoke"))
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        dev = torch.device("cpu")
        spec = chip_smoke.shard_spec(dev, faults=True)
        chip_smoke.shard_zips(spec, dev)
        return chip_smoke.shard_two_ranks(spec)[0]
    finally:
        chip_smoke.SHARD_DIR = saved[0]
        if saved[1] is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = saved[1]


def test_chip_smoke_sound_shard_runs_pass_its_gates(smoke_faults):
    """The sound planned runs pass both training gates, and the ring
    stays within ``TOL[bf16]`` of one call, element by element."""
    for part in ("gpt2_sp2", "bert_tp2"):
        assert smoke_faults[part]["refused_by"] == [], smoke_faults[part]
    for case in smoke_faults["ring"]:
        assert max(case["allclose_share"].values()) <= 1.0, case


@pytest.mark.parametrize("fault", ["grad_average_skipped",
                                   "ring_dkv_halved",
                                   "tp_input_grad_unreduced"])
def test_chip_smoke_shard_gates_refuse_planted_faults(smoke_faults, fault):
    """Each planted fault of the planned step is refused by the bf16 gate
    (the witness) and by the float32 gate alike."""
    import chip_smoke

    part = "gpt2_sp2" if chip_smoke.SHARD_TRAIN_FAULTS[fault] == "gpt2" \
        else "bert_tp2"
    got = smoke_faults[part]["planted_faults"][fault]
    assert got["refused_by"] == ["bf16", "float32"], got


@pytest.mark.parametrize("fault", ["late_call_skipped", "dv_not_rotated"])
def test_chip_smoke_ring_check_refuses_planted_faults(smoke_faults, fault):
    """The ring check reads each planted ring fault past its element-wise
    allowance against one call, in both ring cases."""
    for case in smoke_faults["ring"]:
        shares = case["planted_faults_refused"][fault]
        assert max(v["share"] for v in shares.values()) > 1.0, case
