"""The port's communicator and ``DistOpt`` (``singa_tpu_torch/parallel``)
against the JAX package's, one process per rank.

The JAX package runs ``DistOpt(num_devices=W)`` single-controller: its
graph step is a ``shard_map`` over W of the 8 virtual CPU devices.  The
port runs W processes (``tests/torch_dist_worker.py``) in a gloo process
group on the CPU, each feeding its own shard of the global batch.  Both
start from one ``save_states`` zip the JAX package writes after its
(world-1, eager) warm step, residual rows included, and take 3 steps;
then each rank's parameters, optimizer state, batch-norm statistics and
residual row are held against the JAX states.

The file launches two rank groups, each from a module-scoped fixture that
runs every case in one launch: W = 2 (the communicator's operations, the
five sync modes, clipping in the dense and ``fp16`` modes,
``train_n_batches``, a batch-norm model, the clip refusals, the partial
mode's graph keys) and W = 4 (``plain`` and ``sparseTopK``).  The ranks
meet through a ``file://`` URL under the test's temporary directory, so
parallel test workers never share a port; ``init_process_group`` has a
60 s timeout and each join 150 s.

Tolerances: float32 atol 1e-5 (the packages sum in other orders; top-K
sums indices chosen by several ranks in gloo's order).  bf16 on the wire
(``fp16``, ``synch_half``): gloo's reduction order is not XLA's, so a
synced value may differ by one bf16 ulp of the summed value; after 3 SGD
steps that bounds a parameter's update by 2^-7 of the tensor's largest
update.
"""

import json
import os
import subprocess
import sys
import time
import zipfile
from pathlib import Path

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

from singa_tpu import device as jdevice
from singa_tpu import layer as jlayer
from singa_tpu import model as jmodel
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models.common import apply_dist_option as japply
from singa_tpu.models.mlp import MLP as JMLP
from singa_tpu.parallel.communicator import Communicator as JComm
from singa_tpu.parallel.dist_opt import DistOpt as JDistOpt

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dist_worker.py"
STEPS = 3
ATOL = 1e-5
JOIN_S = 150


class DistMLP(JMLP):
    def __init__(self, dist_option="plain", spars=None):
        super().__init__(data_size=8, perceptron_size=16, num_classes=4)
        self._dist_option = dist_option
        self._spars = spars

    def train_one_batch(self, x, y):
        return super().train_one_batch(x, y, dist_option=self._dist_option,
                                       spars=self._spars)


class BNNet(jmodel.Model):
    def __init__(self, dist_option="plain", spars=None):
        super().__init__()
        self.conv = jlayer.Conv2d(4, 3, padding=1)
        self.bn = jlayer.BatchNorm2d()
        self.flat = jlayer.Flatten()
        self.fc = jlayer.Linear(10)
        self.ce = jlayer.SoftMaxCrossEntropy()
        self._dist_option = dist_option
        self._spars = spars

    def forward(self, x):
        return self.fc(self.flat(self.bn(self.conv(x))))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = self.ce(out, y)
        japply(self.optimizer, loss, self._dist_option, self._spars)
        return out, loss


MODELS = {"mlp": DistMLP, "bn": BNNet}
SGD = dict(lr=0.1, momentum=0.9)

#: name -> (model, dist_option, spars, SGD arguments, train_n_batches)
CASES_2 = {
    "plain": ("mlp", "plain", None, SGD, False),
    "fp16": ("mlp", "fp16", None, SGD, False),
    "partialUpdate": ("mlp", "partialUpdate", None, SGD, False),
    "sparseTopK": ("mlp", "sparseTopK", 0.1, SGD, False),
    "sparseThreshold": ("mlp", "sparseThreshold", 0.01, SGD, False),
    "clip_plain": ("mlp", "plain", None, dict(lr=0.5, clip_norm=0.05),
                   False),
    "clip_fp16": ("mlp", "fp16", None, dict(lr=0.5, clip_norm=0.05), False),
    "train_n_batches": ("mlp", "plain", None, SGD, True),
    "bn": ("bn", "plain", None, SGD, False),
    "bn_partialUpdate": ("bn", "partialUpdate", None, SGD, False),
}
CASES_4 = {
    "plain": ("mlp", "plain", None, SGD, False),
    "sparseTopK": ("mlp", "sparseTopK", 0.1, SGD, False),
}
COMM_SPARS = {"topk": 0.2, "threshold": 0.5}


def _data(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "mlp":
        xs = rng.randn(STEPS + 1, 32, 8).astype(np.float32)
        ys = rng.randint(0, 4, (STEPS + 1, 32)).astype(np.int32)
    else:
        xs = rng.randn(STEPS + 1, 16, 1, 12, 12).astype(np.float32)
        ys = rng.randint(0, 10, (STEPS + 1, 16)).astype(np.int32)
    return xs, ys


def _jax_model(kind, mode, spars, sgd, world, x0):
    dev = jdevice.get_default_device()
    dev.SetRandSeed(5)
    m = MODELS[kind](mode, spars)
    m.set_optimizer(JDistOpt(jopt.SGD(**sgd), num_devices=world))
    m.compile([jtensor.from_numpy(x0, dev)], is_train=True, use_graph=True)
    return m


def _launch(tmp, world, scenarios):
    spec = dict(world=world, init=f"file://{tmp}/rendezvous", out=str(tmp),
                timeout=60, scenarios=scenarios)
    path = tmp / "spec.json"
    path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(tmp / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), str(path), str(r)], cwd=ROOT,
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _join(tmp, procs):
    """Wait for every rank (150 s in all); a hung rank is killed and
    fails the fixture with every rank's log."""
    deadline = time.monotonic() + JOIN_S
    rcs = []
    for p, log in procs:
        try:
            rcs.append(p.wait(max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            rcs.append("timeout")
        log.close()
    if any(rc != 0 for rc in rcs):
        logs = "\n".join((tmp / f"rank{r}.log").read_text()[-3000:]
                         for r in range(len(procs)))
        pytest.fail(f"rank exit codes {rcs}:\n{logs}")


def _jax_states(m):
    out = {f"state/{k}": np.asarray(jtensor.to_numpy(v))
           for k, v in m.get_states().items()}
    for k, v in m.optimizer.get_states().items():
        out[f"opt/{k}"] = np.asarray(v)
    return out


def _run_group(tmp, world, cases, extra=()):
    """Write each case's zip and data, launch the W ranks, take the JAX
    package's 3 steps meanwhile, join; returns ``{case: {"jax": states,
    "losses": [...], "ranks": [npz, ...], "zip": path}}``."""
    jdev = jdevice.get_default_device()
    scenarios, runs = list(extra), {}
    for i, (name, (kind, mode, spars, sgd, multi)) in enumerate(
            cases.items()):
        xs, ys = _data(kind, seed=i)
        m = _jax_model(kind, mode, spars, sgd, world, xs[0])
        m(jtensor.from_numpy(xs[0], jdev), jtensor.from_numpy(ys[0], jdev))
        zpath, dpath = tmp / f"{name}_jax.zip", tmp / f"{name}_data.npz"
        m.save_states(str(zpath))
        np.savez(dpath, xs=xs, ys=ys)
        scenarios.append(dict(name=name, model=kind, mode=mode, spars=spars,
                              sgd=sgd, multi=multi, zip=str(zpath),
                              data=str(dpath)))
        runs[name] = dict(m=m, xs=xs, ys=ys, jax_zip=zpath)
    procs = _launch(tmp, world, scenarios)
    try:
        for name, run in runs.items():
            m, xs, ys = run.pop("m"), run.pop("xs"), run.pop("ys")
            if cases[name][4]:
                _, losses = m.train_n_batches(
                    jtensor.from_numpy(xs[1:], jdev),
                    jtensor.from_numpy(ys[1:], jdev))
                run["losses"] = np.asarray(jtensor.to_numpy(losses))
            else:
                run["losses"] = np.asarray([float(jtensor.to_numpy(m(
                    jtensor.from_numpy(xs[i], jdev),
                    jtensor.from_numpy(ys[i], jdev))[1]))
                    for i in range(1, STEPS + 1)])
            run["jax"] = _jax_states(m)
    finally:
        _join(tmp, procs)
    for name, run in runs.items():
        run["ranks"] = [dict(np.load(tmp / f"{name}_r{r}.npz"))
                        for r in range(world)]
        run["zip"] = tmp / f"{name}_r0.zip"
    return runs


def _comm_data(world):
    rng = np.random.RandomState(7)
    return dict(a=rng.randn(world, 6, 5).astype(np.float32),
                b=rng.randn(world, 7).astype(np.float32),
                r=(0.1 * rng.randn(world, 6, 5)).astype(np.float32))


def _jax_comm(world, d):
    """The JAX ``Communicator``'s operations inside a ``shard_map`` over
    ``world`` devices, one row of each array a rank."""
    comm = JComm(num_devices=world)

    def f(a, b, r):
        a, b, r = a[0], b[0], r[0]
        out = dict(all_reduce=comm.all_reduce(a),
                   all_reduce_mean=comm.all_reduce(a, average=True),
                   synch_half=comm.synch_half(a, average=True))
        for k, v in enumerate(comm.fused_synch([a, b], average=True)):
            out[f"fused_synch{k}"] = v
        for k, v in enumerate(comm.fused_synch_half([a, b], average=True)):
            out[f"fused_synch_half{k}"] = v
        for name, top in (("topk", True), ("threshold", False)):
            s, nr = comm.sparse_all_reduce(a, r, spars=COMM_SPARS[name],
                                           topK=top, average=True)
            out[f"sparse_{name}"], out[f"sparse_{name}_res"] = s, nr
        return {k: v[None] for k, v in out.items()}

    g = jax.jit(jax.shard_map(f, mesh=comm.mesh, in_specs=(P("data"),) * 3,
                              out_specs=P("data"), check_vma=False))
    return {k: np.asarray(v) for k, v in g(d["a"], d["b"], d["r"]).items()}


@pytest.fixture(scope="module")
def group2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist2")
    d = _comm_data(2)
    np.savez(tmp / "comm_data.npz", **d)
    extra = [dict(name="comm", data=str(tmp / "comm_data.npz"),
                  spars=COMM_SPARS), dict(name="refusals"),
             dict(name="partial_keys")]
    runs = _run_group(tmp, 2, CASES_2, extra)
    runs["comm"] = dict(jax=_jax_comm(2, d), ranks=[
        dict(np.load(tmp / f"comm_r{r}.npz")) for r in range(2)])
    runs["refusals"] = [json.loads((tmp / f"refusals_r{r}.json").read_text())
                        for r in range(2)]
    runs["partial_keys"] = [json.loads(
        (tmp / f"partial_keys_r{r}.json").read_text()) for r in range(2)]
    return runs


@pytest.fixture(scope="module")
def group4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist4")
    runs = _run_group(tmp, 4, CASES_4, [dict(name="partial_keys")])
    runs["partial_keys"] = [json.loads(
        (tmp / f"partial_keys_r{r}.json").read_text()) for r in range(4)]
    return runs


def _bf16_ulp(x):
    """One bf16 ulp of |x| (8 significant bits)."""
    ax = np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(ax)) - 7)


def _check_case(run, world, half):
    want = run["jax"]
    init = np.load(run["jax_zip"])
    for r, got in enumerate(run["ranks"]):
        for k, v in want.items():
            if k.startswith("opt/__residual__"):
                name = k[len("opt/__residual__"):]
                np.testing.assert_allclose(
                    got[f"residual/{name}"], v[r], atol=ATOL, rtol=0,
                    err_msg=f"rank {r} residual {name}")
                continue
            g = got[k]
            if half and k.startswith("state/") and "running" not in k:
                # bf16 wire: the update within 2^-7 of its largest entry
                w0 = init[k[len("state/"):]]
                step = np.abs(v - w0).max()
                np.testing.assert_allclose(g - w0, v - w0, rtol=0,
                                           atol=2.0 ** -7 * step + ATOL,
                                           err_msg=f"rank {r} {k}")
            elif half and k.startswith("opt/") and k.endswith(":momentum"):
                np.testing.assert_allclose(
                    g, v, rtol=0, atol=2.0 ** -7 * np.abs(v).max() + ATOL,
                    err_msg=f"rank {r} {k}")
            else:
                np.testing.assert_allclose(g, v, atol=ATOL, rtol=0,
                                           err_msg=f"rank {r} {k}")
        assert not [k for k in got if k.startswith("residual/")
                    and f"opt/__residual__{k[9:]}" not in want]
    mean_loss = np.mean([g["losses"] for g in run["ranks"]], axis=0)
    np.testing.assert_allclose(mean_loss, run["losses"],
                               rtol=2.0 ** -7 if half else 1e-5)


@pytest.mark.parametrize("name", list(CASES_2))
def test_two_ranks_equal_the_jax_distopt(group2, name):
    """Each sync mode (and clipping, ``train_n_batches``, a batch-norm
    model's averaged statistics) at W = 2: every rank's parameters,
    optimizer state and residual row equal the JAX package's after 3
    graph steps from one zip."""
    _check_case(group2[name], 2, half="fp16" in name)


@pytest.mark.parametrize("name", list(CASES_4))
def test_four_ranks_equal_the_jax_distopt(group4, name):
    _check_case(group4[name], 4, half=False)


@pytest.mark.parametrize("name", ["sparseTopK", "partialUpdate"])
def test_residual_rows_differ_across_ranks(group2, name):
    """Each rank keeps its own accumulator: the rows differ (a replicated
    residual would give equal rows)."""
    rows = [{k: v for k, v in g.items() if k.startswith("residual/")}
            for g in group2[name]["ranks"]]
    assert rows[0] and any(not np.allclose(rows[0][k], rows[1][k])
                           for k in rows[0])


@pytest.mark.parametrize("name", ["sparseTopK", "partialUpdate", "plain"])
def test_zips_go_back_to_the_jax_package(group2, name):
    """A rank's ``save_states`` zip (residuals gathered to (W, *shape))
    loads into the JAX package's ``DistOpt`` model and gives the JAX run's
    final states."""
    run = group2[name]
    kind, mode, spars, sgd, _ = CASES_2[name]
    with zipfile.ZipFile(run["zip"]) as zf:
        names = zf.namelist()
    assert all(zf_name.endswith(".npy") for zf_name in names)
    xs, _ = _data(kind, seed=list(CASES_2).index(name))
    m = _jax_model(kind, mode, spars, sgd, 2, xs[0])
    m.load_states(str(run["zip"]))
    got = _jax_states(m)
    want = run["jax"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("op", [
    "all_reduce", "all_reduce_mean", "fused_synch0", "fused_synch1",
    "sparse_topk", "sparse_topk_res", "sparse_threshold",
    "sparse_threshold_res", "synch_half", "fused_synch_half0",
    "fused_synch_half1"])
def test_communicator_ops_equal_the_jax_communicator(group2, op):
    """Each operation on the same per-rank arrays equals the JAX
    ``Communicator``'s inside a ``shard_map`` (bf16 on the wire within one
    bf16 ulp of the summed value)."""
    want = group2["comm"]["jax"][op]
    for r, got in enumerate(group2["comm"]["ranks"]):
        atol = _bf16_ulp(want[r]) if "half" in op else ATOL
        assert np.all(np.abs(got[op] - want[r]) <= atol + 1e-30), (op, r)


def test_process_info_names_each_rank(group2):
    """``process_info`` (and the monitor's crash-bundle host record)
    gives each process its rank and the world size."""
    for r, got in enumerate(group2["comm"]["ranks"]):
        assert got["process_info"].tolist() == [r, 2, r, r]


def test_partial_and_sparse_refuse_clip_norm(group2):
    for rank in group2["refusals"]:
        assert set(rank) == {"partialUpdate", "sparseTopK"}
        assert all("clip_norm" in v for v in rank.values()), rank


def test_partial_update_keys_one_graph_per_phase(group2):
    """Six partial steps from a fresh model at W = 2: the graph runner
    keys one step before the mode is known and one per phase after, and
    each step all-reduces only its phase's parameters (2 of the MLP's 4)."""
    for rank in group2["partial_keys"]:
        assert rank["phases"] == [None, 1, 0, 1, 0, 1]
        assert rank["entries"] == 3
        assert rank["all_reduces_per_step"] == [2] * 6


@pytest.mark.parametrize("world", [2, 4])
def test_partial_update_replays_advance_the_phase(group2, group4, world):
    """Graph-mode partial steps whose prepared steps run as CUDA graph
    replays do (no Python: the host step stays where the step found it)
    still cycle the phases 0..W-1, each issuing its own all-reduces, and
    end where as many eager steps end: the graph runner advances the
    host step after every step, whatever ran."""
    n = 3 * world + 2
    per_phase = [len(range(p, 4, world)) for p in range(world)]
    for rank in (group2 if world == 2 else group4)["partial_keys"]:
        assert rank["replay_phases"] == [None] + [s % world
                                                  for s in range(1, n)]
        assert rank["replay_all_reduces"] == rank["eager_all_reduces"] == [
            per_phase[s % world] for s in range(n)]
        assert rank["eager_phases"] == rank["replay_phases"]
        assert rank["replay_host_step"] == n
        assert rank["replay_max_diff_vs_eager"] == 0.0


def test_chip_smoke_dist_world_refuses_without_the_cards(monkeypatch,
                                                        capsys):
    """``chip_smoke.py --dist-world 4`` (ResNet-152 DistOpt over NCCL,
    one process a GPU) needs 4 GPUs and says so, exiting nonzero and
    printing no result, where it has fewer (no CPU stand-in)."""
    import chip_smoke
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert chip_smoke.main_dist_world(4) == 1
    out, err = capsys.readouterr()
    assert out == "" and "needs 4 GPUs, sees 3" in err, err


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo group in this process, for the length of a test."""
    import torch.distributed as dist

    from singa_tpu_torch.parallel import communicator

    communicator.initialize_distributed(
        init_method=f"file://{tmp_path}/rendezvous", num_processes=1,
        process_id=0, backend="gloo", initialization_timeout=60)
    try:
        yield communicator.Communicator()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("transient", [True, False],
                         ids=["transient", "fatal"])
def test_comm_fault_site_acts_as_the_jax_packages(world1, transient):
    """An injected fault at ``comm.collective``: a transient one is
    retried (``resilience.retries{site=comm.collective}`` + 1) and the
    all-reduce returns its sum; a fatal one raises ``FaultInjected``,
    in both packages (the JAX package's at trace time)."""
    import jax.numpy as jnp
    import torch

    from singa_tpu.observe.registry import registry as jreg
    from singa_tpu.resilience import faults as jfaults
    from singa_tpu_torch.observe.registry import registry as treg
    from singa_tpu_torch.resilience import faults as tfaults

    jcomm = JComm(num_devices=2)
    jrun = jax.jit(jax.shard_map(
        lambda a: jcomm.all_reduce(a[0])[None], mesh=jcomm.mesh,
        in_specs=P("data"), out_specs=P("data"), check_vma=False))
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = {}
    for pkg, faults, reg, run in (
            ("jax", jfaults, jreg, lambda: np.asarray(jrun(a))[0]),
            ("port", tfaults, treg, lambda: world1.all_reduce(
                torch.from_numpy(a.sum(0))).numpy())):
        retries = reg().counter("resilience.retries",
                                site="comm.collective")
        before = retries.value
        with faults.injected("comm.collective",
                             faults.FailOnce(transient=transient)):
            if transient:
                got[pkg] = run()
            else:
                with pytest.raises(faults.FaultInjected):
                    run()
        assert retries.value - before == int(transient), pkg
    if transient:
        np.testing.assert_array_equal(got["port"], got["jax"])
