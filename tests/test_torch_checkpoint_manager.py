"""The port's ``CheckpointManager`` (``resilience/checkpoint.py``) and the
model methods over it against the JAX package's.

* A checkpoint directory written by the port validates and restores in
  the JAX manager, and one the JAX package wrote in the port's, manifest
  schema included: the MLP's weights, its SGD momentum and step counter
  and the aux values arrive bit for bit;
* a corrupted newest checkpoint (a flipped byte, a truncated zip, a bad
  manifest) makes ``restore_latest`` fall back to the previous step and
  raises ``resilience.checkpoint_fallbacks``; ``keep`` rotation;
  ``NoValidCheckpointError`` when none survive; the sweep of a crashed
  save's staging directory;
* ``CorruptRecordError`` is fatal to ``is_transient`` (no retry);
* a run resumed from a checkpoint takes the uninterrupted run's steps
  bit for bit on the CPU (weights, momentum, the step counter that a
  learning-rate schedule reads, and the loader's epoch seed carried in
  ``aux_states``).
"""

import json
import os

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)

from singa_tpu import opt as jopt
from singa_tpu import tensor as jt
from singa_tpu.models.mlp import MLP as JMLP
from singa_tpu.resilience import checkpoint as jckpt
from singa_tpu_torch import device, opt, tensor
from singa_tpu_torch.io import CorruptRecordError, loader
from singa_tpu_torch.models.mlp import MLP
from singa_tpu_torch.observe.registry import registry
from singa_tpu_torch.resilience import (CheckpointCorruptError,
                                        CheckpointManager,
                                        NoValidCheckpointError,
                                        RetryPolicy, is_transient,
                                        retry_call)
from singa_tpu_torch.resilience.checkpoint import MANIFEST_NAME, STATES_NAME

CPU = device.create_cpu_device()


def _data(seed=0, n=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 6).astype(np.float32),
            rng.randint(0, 4, n).astype(np.int32))


def _port_mlp(seed=0, schedule=False):
    CPU.SetRandSeed(seed)
    m = MLP(data_size=6, perceptron_size=16, num_classes=4)
    lr = opt.ExponentialDecay(0.1, 2, 0.5) if schedule else 0.1
    m.set_optimizer(opt.SGD(lr=lr, momentum=0.9))
    x, _ = _data()
    m.compile([tensor.from_numpy(x, CPU)], is_train=True, use_graph=False)
    return m


def _jax_mlp(x, y):
    jm = JMLP(data_size=6, perceptron_size=16, num_classes=4)
    jm.set_optimizer(jopt.SGD(lr=0.1, momentum=0.9))
    jm.compile([jt.from_numpy(x)], is_train=True, use_graph=False)
    jm(jt.from_numpy(x), jt.from_numpy(y))   # optimizer state exists now
    return jm


def _port_step(m, x, y):
    _, loss = m(tensor.from_numpy(x, CPU), tensor.from_numpy(y, CPU))
    return loss.item()


def _port_states(m):
    return {k: tensor.to_numpy(v) for k, v in m.persistent_tensors().items()}


def _jax_states(jm):
    d = {k: jt.to_numpy(v) for k, v in jm.get_states().items()}
    for k, v in jm.optimizer.get_states().items():
        d[f"__opt__{k}"] = np.asarray(jt.to_numpy(v) if isinstance(
            v, jt.Tensor) else v)
    return d


def _assert_states_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]).reshape(-1),
                                      np.asarray(want[k]).reshape(-1),
                                      err_msg=k)


def test_port_checkpoint_restores_in_jax_and_back(tmp_path):
    x, y = _data()
    root = str(tmp_path / "ckpt")
    m = _port_mlp()
    _port_step(m, x, y)
    _port_step(m, x, y)
    path = m.save_checkpoint(root, step=7, aux_states={"epoch": 3})
    manifest = json.load(open(os.path.join(path, MANIFEST_NAME)))
    assert manifest["schema"] == "singa_tpu.checkpoint/1"
    assert manifest["step"] == 7
    # the JAX manager validates and restores the port's directory
    jmgr = jckpt.CheckpointManager(root, keep=3)
    assert jmgr.validate(7)["files"][STATES_NAME]["sha256"] == \
        manifest["files"][STATES_NAME]["sha256"]
    jm = _jax_mlp(*_data(1))
    step, aux = jmgr.restore_latest(jm)
    assert step == 7 and int(aux["epoch"]) == 3
    _assert_states_equal(_jax_states(jm), _port_states(m))
    # the JAX package takes a step and checkpoints; the port restores it
    jm(jt.from_numpy(x), jt.from_numpy(y))
    jmgr.save(jm, 9, aux_states={"epoch": 4})
    fresh = _port_mlp(seed=5)
    step, aux = fresh.restore_latest_checkpoint(root)
    assert step == 9 and int(aux["epoch"]) == 4
    CheckpointManager(root).validate(9)
    _assert_states_equal(_port_states(fresh), _jax_states(jm))


def _fallbacks():
    return registry().counter("resilience.checkpoint_fallbacks").value


@pytest.mark.parametrize("damage", ["flip_byte", "truncate", "manifest",
                                    "missing_zip"])
def test_corrupt_newest_falls_back_and_counts(tmp_path, damage):
    x, y = _data()
    root = str(tmp_path / "ckpt")
    m = _port_mlp()
    mgr = m.checkpoint_manager(root, keep=3)
    _port_step(m, x, y)
    mgr.save(m, 2, aux_states={"step": 2})
    at2 = _port_states(m)
    _port_step(m, x, y)
    newest = mgr.save(m, 4, aux_states={"step": 4})
    zpath = os.path.join(newest, STATES_NAME)
    if damage == "flip_byte":
        blob = bytearray(open(zpath, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(zpath, "wb").write(bytes(blob))
    elif damage == "truncate":
        blob = open(zpath, "rb").read()
        open(zpath, "wb").write(blob[:len(blob) - 100])
    elif damage == "manifest":
        open(os.path.join(newest, MANIFEST_NAME), "w").write('{"step": NaN')
    else:
        os.unlink(zpath)
    with pytest.raises(CheckpointCorruptError):
        mgr.validate(4)
    before = _fallbacks()
    fresh = _port_mlp(seed=3)
    step, aux = fresh.restore_latest_checkpoint(root, manager=mgr)
    assert step == 2 and int(aux["step"]) == 2
    assert _fallbacks() == before + 1
    _assert_states_equal(_port_states(fresh), at2)


def test_keep_rotation_sweep_and_no_valid_checkpoint(tmp_path):
    root = str(tmp_path / "ckpt")
    os.makedirs(os.path.join(root, ".step_00000001.crashed"))
    m = _port_mlp()
    mgr = CheckpointManager(root, keep=2)
    assert not os.path.exists(os.path.join(root, ".step_00000001.crashed"))
    for s in (1, 2, 3, 4):
        mgr.save(m, s)
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    mgr.save(m, 4)   # the same step again: replaced, still two kept
    assert mgr.steps() == [3, 4]
    assert not [n for n in os.listdir(root) if n.startswith(".")]
    for s in mgr.steps():
        os.unlink(os.path.join(mgr.step_dir(s), STATES_NAME))
    before = _fallbacks()
    with pytest.raises(NoValidCheckpointError, match=r"\[4, 3\]"):
        mgr.restore_latest(_port_mlp())
    assert _fallbacks() == before + 2
    with pytest.raises(ValueError, match="keep"):
        CheckpointManager(root, keep=0)


def test_corrupt_record_error_is_fatal_to_retry():
    e = CorruptRecordError("f.bin", "CRC mismatch", key="w", offset=8,
                           expected=1, actual=2)
    assert isinstance(e, OSError) and not is_transient(e)
    assert is_transient(OSError("flaky"))
    calls = []

    def fn():
        calls.append(1)
        raise e

    with pytest.raises(CorruptRecordError):
        retry_call(fn, "checkpoint.read",
                   policy=RetryPolicy(max_attempts=4, base_delay_s=0.0),
                   sleep=lambda s: None)
    assert len(calls) == 1


def test_resumed_run_is_bit_equal_to_the_uninterrupted_one(tmp_path):
    """Six steps from a BinFile dataset (``DataLoader(num_workers=1)``,
    two epochs of three batches) with a learning-rate schedule; a
    checkpoint at steps 2 and 4 carrying the step and the loader's seed;
    the step-4 checkpoint corrupted; a fresh model and loader resume from
    step 2, skip the batches consumed, and replay steps 3-6: losses and
    final weights equal the uninterrupted run's bit for bit."""
    rng = np.random.RandomState(0)
    xs = rng.randn(24, 6).astype(np.float32)
    ys = rng.randint(0, 4, 24)
    ds = str(tmp_path / "train.bin")
    loader.write_dataset(ds, xs, ys)
    root = str(tmp_path / "ckpt")

    def batches(dl, epoch_seed):
        dl.seed = epoch_seed
        while True:
            seed = dl.seed
            for i, b in enumerate(dl):
                yield seed, i, b

    m = _port_mlp(schedule=True)
    dl = loader.DataLoader(ds, 8, num_workers=1, seed=11)
    losses = []
    it = batches(dl, 11)
    for step in range(1, 7):
        seed, i, (x, y) = next(it)
        losses.append(_port_step(m, x, y))
        if step in (2, 4):
            m.save_checkpoint(root, step, keep=2, aux_states={
                "step": step, "epoch_seed": seed, "batch": i})
    final = _port_states(m)
    zpath = os.path.join(CheckpointManager(root).step_dir(4), STATES_NAME)
    blob = bytearray(open(zpath, "rb").read())
    blob[100] ^= 1
    open(zpath, "wb").write(bytes(blob))

    fresh = _port_mlp(seed=9, schedule=True)
    step, aux = fresh.restore_latest_checkpoint(root)
    assert step == 2
    dl2 = loader.DataLoader(ds, 8, num_workers=1)
    it2 = batches(dl2, int(aux["epoch_seed"]))
    for _ in range(int(aux["batch"]) + 1):
        next(it2)   # the batches step 2 had consumed
    replay = []
    for _ in range(3, 7):
        _, _, (x, y) = next(it2)
        replay.append(_port_step(fresh, x, y))
    assert replay == losses[2:]
    _assert_states_equal(_port_states(fresh), final)
    assert int(fresh.optimizer.state_tensors()["__step_counter__"]) == 6
