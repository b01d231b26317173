"""The port's sharded-serving scenarios (``serve/tp.py``, ``serve/ep.py``,
``serve/pp.py``), run by a spawned gloo group on the CPU, and the
launcher the test files use to spawn it.

    python tests/torch_serve_scenarios.py SPEC.json RANK

``SPEC.json``: ``world``, ``init`` (a ``file://`` URL), ``out`` (a
directory) and ``scenarios`` (each a dict with a ``name`` and a
``kind``).  Rank 0 is the controller: it builds the models and the
engines and runs every scenario, writing ``<name>.json``; the other ranks
run ``serve.shard.worker_loop()`` until rank 0 stops them.  A scenario
that raises records its traceback under ``"error"``.  Nothing here
imports JAX.
"""

import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from singa_tpu_torch import device, tensor  # noqa: E402
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead  # noqa: E402
from singa_tpu_torch.observe import health_report  # noqa: E402
from singa_tpu_torch.observe.registry import registry  # noqa: E402
from singa_tpu_torch.parallel import communicator as _comm  # noqa: E402
from singa_tpu_torch.resilience import FailAfterN, faults  # noqa: E402
from singa_tpu_torch.serve import (EngineFailedError,  # noqa: E402
                                   EngineSupervisor, GenerationRequest,
                                   PagedConfig, PrefixCacheConfig)
from singa_tpu_torch.serve import shard  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 150


# -- models and workloads ----------------------------------------------------


def build(zip_path=None, seed=0, **cfg_kw):
    """A ``GPT2Config.tiny`` model on the CPU (no dropout), its states from
    a JAX ``save_states`` zip when given, else from the seed."""
    cpu = device.create_cpu_device()
    cpu.SetRandSeed(seed)
    torch.manual_seed(seed)
    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0, **cfg_kw))
    m.compile([tensor.from_numpy(np.zeros((1, 16), np.int32), cpu)],
              is_train=False)
    if zip_path:
        m.load_states(zip_path)
    return m


def workload(seed, n, p_lo=3, p_hi=14, n_lo=2, n_hi=9, sampled=True,
             vocab=256):
    """``tests/test_tp_serve.py``'s ``_workload``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        out.append(dict(
            prompt=rng.randint(0, vocab, rng.randint(p_lo, p_hi))
            .astype(np.int32),
            n_new=int(rng.randint(n_lo, n_hi)),
            temperature=(float(rng.choice([0.0, 0.9])) if sampled else 0.0),
            seed=int(rng.randint(0, 1000))))
    return out


def warm_workload(seed, n, system=40):
    """``tests/test_tp_serve.py``'s warm-prefix workload: a shared system
    prompt and a short tail each, greedy."""
    rng = np.random.RandomState(seed)
    head = rng.randint(0, 256, system).astype(np.int32)
    return [dict(prompt=np.concatenate(
        [head, rng.randint(0, 256, rng.randint(3, 8)).astype(np.int32)]),
        n_new=6, temperature=0.0, seed=int(rng.randint(0, 1000)))
        for _ in range(n)]


def make_work(spec):
    spec = dict(spec)
    if spec.pop("warm", False):
        return warm_workload(**spec)
    return workload(**spec)


def _req(w, **kw):
    return GenerationRequest(w["prompt"], max_new_tokens=w["n_new"],
                             temperature=w["temperature"], seed=w["seed"],
                             **kw)


def run(m, work, two_pass=False, priorities=None, **kw):
    """Serve ``work`` on ``m.serve(**kw)``: (token lists, the engine's
    stats snapshot, its executor snapshot or None); ``two_pass``: the
    workload twice, the second pass's tokens (a prefix cache's warm
    pass)."""
    eng = m.serve(**kw)
    try:
        for _ in range(2 if two_pass else 1):
            hs = [eng.submit(_req(w, **({} if priorities is None else
                                        dict(priority=priorities[i]))))
                  for i, w in enumerate(work)]
            eng.run_until_complete(max_steps=4000)
            toks = [h.result().tokens.tolist() for h in hs]
        snap = eng.stats.snapshot()
        sx = None if eng._shard is None else eng._shard.snapshot()
    finally:
        eng.close()
    return toks, _jsonable(snap), _jsonable(sx)


def _jsonable(x):
    return json.loads(json.dumps(x, default=lambda o: repr(o)))


PAGED = dict(block_size=8, num_blocks=64)


def _paged(**kw):
    return PagedConfig(**{**PAGED, **kw})


# -- the scenarios (rank 0) --------------------------------------------------


def sc_parity(sc, out):
    """The sharded engine against the single-device one on the same
    workload, for each engine variant of ``sc["variants"]``: (variant ->
    {"one": streams, "sharded": streams, ...})."""
    mode = sc["mode"]
    res = {}
    models = {}
    for var in sc["variants"]:
        key = var.get("model", "base")
        if key not in models:
            models[key] = build(sc.get("zip") if key == "base" else None,
                                seed=var.get("seed", 0),
                                **var.get("cfg", sc.get("cfg", {})))
        m = models[key]
        kw = dict(var.get("engine", {}))
        if kw.get("paged", "yes") is None:
            kw["paged"] = None
        else:
            kw["paged"] = _paged(**kw.get("paged", {}))
        if "prefix_cache" in kw:
            kw["prefix_cache"] = PrefixCacheConfig(**kw["prefix_cache"])
        if "draft" in var:
            kw["draft_model"] = build(seed=1, **var["draft"])
        work = make_work(var["work"])
        opts = dict(two_pass=var.get("two_pass", False),
                    priorities=var.get("priorities"))
        one = s1 = None
        if var.get("one", True):
            one, s1, _ = run(m, work, **opts, **kw)
        shard_kw = {mode: var.get("shard", sc["shard"])}
        got, snap, sx = run(m, work, **opts, **kw, **shard_kw)
        res[var["id"]] = dict(one=one, sharded=got, snap=snap, shard=sx,
                              one_snap=s1)
        if var.get("twice"):
            got2, _, sx2 = run(m, work, **opts, **kw, **shard_kw)
            res[var["id"]].update(sharded2=got2, shard2=sx2)
        if var.get("generate"):
            res[var["id"]]["generate"] = [
                m.generate(w["prompt"], max_new_tokens=w["n_new"],
                           temperature=0.0).tolist() for w in work]
    return res


def sc_refusals(sc, out):
    """Each (engine kwargs, model variant) of ``sc["cases"]``: the error's
    type and message, and whether the registry changed."""
    res = {}
    models = {}
    for case in sc["cases"]:
        key = json.dumps(case.get("cfg", {}), sort_keys=True)
        if key not in models:
            models[key] = build(**case.get("cfg", {}))
        kw = dict(case["engine"])
        if kw.get("paged", "yes") is None:
            kw["paged"] = None
        elif "paged" in kw:
            kw["paged"] = _paged(**kw["paged"])
        if "prefix_cache" in kw:
            kw["prefix_cache"] = PrefixCacheConfig(**kw["prefix_cache"])
        if "draft" in case:
            kw["draft_model"] = build(seed=1, **case["draft"])
        before = set(registry().snapshot()["gauges"]) | \
            set(registry().snapshot()["counters"])
        try:
            eng = models[key].serve(**kw)
            eng.close()
            res[case["id"]] = dict(type=None, msg="built")
        except Exception as e:
            res[case["id"]] = dict(type=type(e).__name__, msg=str(e))
        after = set(registry().snapshot()["gauges"]) | \
            set(registry().snapshot()["counters"])
        res[case["id"]]["leaked"] = sorted(after - before)
    return res


def sc_supervisor(sc, out):
    """An injected fault at the executor's site fails the sharded engine
    mid-decode; the supervisor rebuilds it (the workers rebuild their
    mirror) and requeued streams equal the single-device engine's."""
    m = build(sc.get("zip"), **sc.get("cfg", {}))
    work = make_work(sc["work"])
    kw = dict(max_slots=2, paged=_paged())
    base, _, _ = run(m, work, **kw)
    r0 = registry().snapshot()["counters"].get("resilience.engine_restarts",
                                               0)
    sup = EngineSupervisor(m, restart_budget=2, **kw,
                           **{sc["mode"]: sc["shard"]})
    hs = [sup.submit(_req(w)) for w in work]
    pol = faults.inject(sc["site"], FailAfterN(3, times=1))
    try:
        sup.run_until_complete(max_steps=4000)
    finally:
        faults.clear()
    got = []
    for h in hs:
        try:
            got.append(dict(tokens=h.result().tokens.tolist()))
        except EngineFailedError as e:
            got.append(dict(error=str(e), started=e.started))
    health = health_report(include_registry=False)["serve"][sc["mode"]]
    sup.close()
    return dict(fired=pol.fired, base=base, got=got, health=health,
                restarts=registry().snapshot()["counters"].get(
                    "resilience.engine_restarts", 0) - r0)


def sc_metrics(sc, out):
    """The executor's ``serve.<kind>.*`` metrics, the stats section and the
    health section while a sharded engine is open, and after close."""
    m = build(sc.get("zip"), **sc.get("cfg", {}))
    kw = dict(max_slots=2, paged=_paged(), **{sc["mode"]: sc["shard"]})
    eng = m.serve(**kw)
    for w in workload(**sc["work"]):
        eng.submit(_req(w))
    eng.run_until_complete(max_steps=4000)
    snap = registry().snapshot()
    mine = {k: v for part in ("gauges", "counters")
            for k, v in snap[part].items()
            if k.startswith(f"serve.{sc['mode']}.")}
    stats = eng.stats.snapshot()[sc["mode"]]
    health = health_report(include_registry=False)["serve"][sc["mode"]]
    eng.close()
    snap = registry().snapshot()
    left = [k for part in ("gauges", "counters") for k in snap[part]
            if k.startswith(f"serve.{sc['mode']}.")]
    return _jsonable(dict(metrics=mine, stats=stats, health=health,
                          left=left))


def sc_slices(sc, out):
    """The rank's slices of a sharded engine's placed weights and pools
    (rank 0's), for the spec check against the JAX shards."""
    m = build(sc.get("zip"), **sc.get("cfg", {}))
    res = {}
    for q in (None, "int8"):
        eng = m.serve(max_slots=2, paged=_paged(), cache_dtype=q,
                      **{sc["mode"]: sc["shard"]})
        pool = eng.paged_arena.pool_k
        res[f"pool_{q}"] = [list(t.shape) for t in
                            (pool if isinstance(pool, tuple) else (pool,))]
        res[f"blocks_{q}"] = len(eng._params["blocks"])
        eng.close()
    return _jsonable(res)


def sc_capture(sc, out):
    """The gloo-on-the-card refusal: ``check_sharded`` for a model whose
    weights sit on a CUDA device (a stand-in object: this process has no
    card) over this gloo group, with ``capture`` True and False."""
    import types

    cuda = types.SimpleNamespace(device=torch.device("cuda", 0))
    model = shard._Shipped(GPT2Config.tiny(), {"wte": cuda})
    res = {}
    for capture in (True, False):
        try:
            got = shard.check_sharded(model.cfg, model, tp=2,
                                      paged=_paged(), capture=capture)
            res[str(capture)] = dict(type=None, msg=repr(got))
        except Exception as e:
            res[str(capture)] = dict(type=type(e).__name__, msg=str(e))
    return res


SCENARIOS = {"parity": sc_parity, "refusals": sc_refusals,
             "capture": sc_capture,
             "supervisor": sc_supervisor, "metrics": sc_metrics,
             "slices": sc_slices}


def _wait_for(path, timeout=JOIN_S):
    """Block until ``path`` exists: the test process writes the JAX zip
    while the ranks start (it renames the file into place whole)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)


def controller(spec):
    out = spec["out"]
    try:
        for path in {sc["zip"] for sc in spec["scenarios"] if "zip" in sc}:
            _wait_for(path)
        for sc in spec["scenarios"]:
            t0 = time.perf_counter()
            try:
                res = SCENARIOS[sc["kind"]](sc, out)
            except Exception:
                res = {"error": traceback.format_exc()}
            res = dict(res, seconds=time.perf_counter() - t0)
            with open(os.path.join(out, f"{sc['name']}.json"), "w") as f:
                json.dump(_jsonable(res), f)
    finally:
        shard.stop_workers()


def main():
    spec = json.load(open(sys.argv[1]))
    rank, world = int(sys.argv[2]), int(spec["world"])
    torch.set_num_threads(1)
    _comm.initialize_distributed(
        init_method=spec["init"], num_processes=world, process_id=rank,
        backend="gloo", initialization_timeout=spec.get("timeout", 60))
    with torch.no_grad():
        if rank == 0:
            controller(spec)
        else:
            shard.worker_loop()
    torch.distributed.barrier()
    # every result is written: leave without the interpreter's teardown,
    # in which the process group's threads can end the process with
    # std::terminate under load
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


# -- the launcher (the test process) -----------------------------------------


def launch(tmp, world, scenarios):
    """Start ``world`` ranks of this file over a gloo group meeting at a
    ``file://`` URL under ``tmp``; returns the processes and their logs."""
    spec = dict(world=world, init=f"file://{tmp}/rendezvous", out=str(tmp),
                timeout=JOIN_S, scenarios=scenarios)
    path = Path(tmp) / "spec.json"
    path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(Path(tmp) / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), str(path),
             str(r)], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def join(tmp, procs):
    """Wait for every rank; raises with their logs when one failed or hung
    (a hung rank is killed)."""
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
        logs = "\n".join((Path(tmp) / f"rank{r}.log").read_text()[-3000:]
                         for r in range(len(procs)))
        raise RuntimeError(f"rank exit codes {rcs}:\n{logs}")


def save_zip(m, path):
    """``m.save_states`` into ``path`` whole (a temporary name, then a
    rename), for ranks that start before the zip exists."""
    m.save_states(path + ".tmp")
    os.replace(path + ".tmp", path)


def results(tmp, name):
    res = json.loads((Path(tmp) / f"{name}.json").read_text())
    if "error" in res:
        raise AssertionError(f"scenario {name} raised on rank 0:\n"
                             f"{res['error']}")
    return res


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
