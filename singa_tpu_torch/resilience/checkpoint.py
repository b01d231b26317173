"""CheckpointManager (counterpart of
``singa_tpu/resilience/checkpoint.py``): step-numbered checkpoint
directories with a strict-JSON manifest, last-K retention, and a
fallback past corrupt checkpoints.

Layout (one directory per step under ``root``)::

    root/
      step_00000010/
        states.zip      # Model.save_states zip (one .npy per tensor)
        manifest.json   # strict JSON, written LAST (the commit record)
      step_00000020/
        ...

The manifest carries each data file's sha256 and byte size, the step
number and the parameter counts, under the JAX package's schema name,
so a checkpoint directory written by either package validates and
restores in the other (the zip itself interchanges, ``model.py``).
A save is atomic at two levels: ``Model.save_states`` writes its zip to
a temporary file and renames it, and the manager stages the whole step
directory under a dot-prefixed name and renames it into place only
after the manifest is fsynced; a same-step directory is renamed aside
first and deleted last.  A crash mid-save leaves a dot-prefixed
directory that ``restore_latest`` never reads (the next manager sweeps
it).

``restore_latest`` walks the steps newest to oldest, validating each
(the manifest parses as strict JSON, its files exist, their sizes and
digests match) before loading; a corrupt or unreadable step increments
``resilience.checkpoint_fallbacks`` and the walk moves to the previous
one.  Transient write and read errors go through the retry layer
(``resilience.retries{site=checkpoint.write|read}``); corruption is
fatal there, so it falls through to the walk instead of spending the
retry budget.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import uuid

import numpy as np

from ..observe import trace as _trace
from ..observe.registry import registry as _registry
from ..utils.logging import get_channel
from . import faults as _faults
from .retry import RetryPolicy, retry_call

__all__ = ["CheckpointManager", "CheckpointCorruptError",
           "NoValidCheckpointError", "MANIFEST_NAME", "STATES_NAME"]

MANIFEST_NAME = "manifest.json"
STATES_NAME = "states.zip"
# the manifest names the JAX package's schema, so the two packages'
# checkpoint directories interchange
_JAX_PACKAGE = "singa_tpu"
_SCHEMA = f"{_JAX_PACKAGE}.checkpoint/1"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory failed validation (bad manifest, missing
    file, size or digest mismatch).  Fatal to the retry layer — a
    digest mismatch never heals — but absorbed by the
    ``restore_latest`` fallback walk."""

    def __init__(self, path, reason):
        super().__init__(f"corrupt checkpoint {path}: {reason}")
        self.path = path
        self.reason = reason


class NoValidCheckpointError(RuntimeError):
    """Every step directory under the root failed validation (or the
    root holds none)."""


def _sha256(path, chunk=1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


class CheckpointManager:
    """Manage step-numbered checkpoints of one model under ``root``.

    >>> mgr = CheckpointManager("/ckpt/run0", keep=3)
    >>> mgr.save(model, step=100)
    >>> step, aux = mgr.restore_latest(model)   # falls back on corruption

    ``keep``: last-K retention — older step directories are deleted
    after each successful save (K >= 2 is what makes the corruption
    fallback useful; K=1 keeps only the copy that might be the corrupt
    one).  ``retry_policy``: backoff for transient write/read I/O.
    """

    def __init__(self, root, keep=3, retry_policy=None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.root = str(root)
        self.keep = int(keep)
        self.retry_policy = (retry_policy if retry_policy is not None
                             else RetryPolicy(base_delay_s=0.02,
                                              max_delay_s=0.5))
        os.makedirs(self.root, exist_ok=True)
        self._log = get_channel("resilience")
        # sweep crash-orphaned staging/aside directories (dot-prefixed
        # — a preemption mid-save leaves one behind with a full-sized
        # states.zip inside; without this, a preemption-heavy fleet
        # leaks a model-sized orphan per crash until the disk fills).
        # Done at construction only: this manager has no in-flight
        # saves yet, so anything dot-prefixed here is dead.
        for name in os.listdir(self.root):
            if name.startswith(".step_"):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
                self._log.warning(
                    "swept orphaned checkpoint staging dir %s "
                    "(crash mid-save?)", name)
        reg = _registry()
        self._c_saves = reg.counter(
            "resilience.checkpoint_saves",
            help="checkpoint step directories committed")
        self._c_fallbacks = reg.counter(
            "resilience.checkpoint_fallbacks",
            help="restore_latest skips of a corrupt/unreadable step")

    # -- layout ----------------------------------------------------------
    @staticmethod
    def _dirname(step) -> str:
        return f"step_{int(step):08d}"

    def step_dir(self, step) -> str:
        return os.path.join(self.root, self._dirname(step))

    def steps(self) -> list:
        """Committed step numbers, ascending.  Temp (dot-prefixed) and
        foreign directories are ignored."""
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.startswith("."):
                try:
                    out.append(int(name[len("step_"):]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self):
        s = self.steps()
        return s[-1] if s else None

    # -- save ------------------------------------------------------------
    def save(self, model, step, aux_states=None) -> str:
        """Write one checkpoint for ``step`` and rotate retention.
        Returns the committed step directory.  Transient write errors
        retry with backoff (``resilience.retries{site=checkpoint.write}``);
        an existing directory for the same step is swapped out via
        rename-aside + rename-in (old copy deleted last).
        """
        final = self.step_dir(step)
        tmp = os.path.join(self.root,
                           f".{self._dirname(step)}.{uuid.uuid4().hex}")

        def _write():
            _faults.check("checkpoint.write")
            os.makedirs(tmp, exist_ok=True)
            states = os.path.join(tmp, STATES_NAME)
            model.save_states(states, aux_states=aux_states)
            st = model.get_states()
            manifest = {
                "schema": _SCHEMA,
                "step": int(step),
                "created_unix_s": time.time(),
                "param_count": int(sum(
                    int(np.prod(t.shape)) if t.shape else 1
                    for t in st.values())),
                "tensor_count": len(st),
                "files": {
                    STATES_NAME: {
                        "bytes": os.path.getsize(states),
                        "sha256": _sha256(states),
                    },
                },
            }
            mpath = os.path.join(tmp, MANIFEST_NAME)
            with open(mpath, "w") as f:
                # allow_nan=False: the manifest is the STRICT-JSON
                # commit record CI and tooling parse with
                # parse_constant=raise
                json.dump(manifest, f, indent=1, allow_nan=False)
                f.flush()
                os.fsync(f.fileno())
            return manifest

        with _trace.span("resilience/checkpoint_save", cat="resilience",
                         step=int(step), path=final):
            try:
                manifest = retry_call(_write, "checkpoint.write",
                                      policy=self.retry_policy)
                # replace an existing same-step directory by renaming
                # it aside (dot-prefixed — steps() never sees it),
                # renaming the new one in, and only then deleting the
                # old.  The no-copy-visible window is two renames, not
                # a size-proportional rmtree; a crash inside it still
                # degrades to restore_latest's fallback to the
                # previous retained step, never to silent corruption.
                old = None
                if os.path.isdir(final):
                    old = os.path.join(
                        self.root, f".{self._dirname(step)}.old."
                                   f"{uuid.uuid4().hex}")
                    os.rename(final, old)
                os.rename(tmp, final)
                if old is not None:
                    shutil.rmtree(old, ignore_errors=True)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
        self._c_saves.inc()
        self._log.info("checkpoint committed: step=%d -> %s "
                       "(%d params)", step, final,
                       manifest["param_count"])
        self._retain()
        return final

    def _retain(self):
        """Drop the oldest committed steps beyond ``keep``.  Runs after
        a successful commit, so the new checkpoint is never traded for
        the old one it was meant to replace."""
        steps = self.steps()
        for step in steps[:-self.keep]:
            path = self.step_dir(step)
            shutil.rmtree(path, ignore_errors=True)
            self._log.info("checkpoint retention: dropped step %d", step)

    # -- validate / restore ----------------------------------------------
    def validate(self, step) -> dict:
        """Validate one committed step; returns its manifest or raises
        :class:`CheckpointCorruptError` naming what failed."""
        path = self.step_dir(step)
        mpath = os.path.join(path, MANIFEST_NAME)
        if not os.path.isfile(mpath):
            raise CheckpointCorruptError(path, "manifest.json missing")
        try:
            with open(mpath) as f:
                manifest = json.load(
                    f, parse_constant=lambda c: (_ for _ in ()).throw(
                        ValueError(f"non-strict JSON constant {c}")))
        except (ValueError, OSError) as e:
            raise CheckpointCorruptError(
                path, f"manifest unreadable: {e!r}") from e
        if manifest.get("schema") != _SCHEMA:
            raise CheckpointCorruptError(
                path, f"unknown schema {manifest.get('schema')!r}")
        if manifest.get("step") != int(step):
            raise CheckpointCorruptError(
                path, f"manifest step {manifest.get('step')} != "
                      f"directory step {step}")
        for name, meta in manifest.get("files", {}).items():
            fpath = os.path.join(path, name)
            if not os.path.isfile(fpath):
                raise CheckpointCorruptError(path, f"{name} missing")
            size = os.path.getsize(fpath)
            if size != meta.get("bytes"):
                raise CheckpointCorruptError(
                    path, f"{name} truncated: {size} bytes, manifest "
                          f"says {meta.get('bytes')}")
            digest = _sha256(fpath)
            if digest != meta.get("sha256"):
                raise CheckpointCorruptError(
                    path, f"{name} digest mismatch: {digest[:12]}... "
                          f"!= manifest {str(meta.get('sha256'))[:12]}...")
        return manifest

    def restore_latest(self, model):
        """Load the newest VALID checkpoint into ``model``.  Returns
        ``(step, aux_states)``.  A corrupt/truncated/unreadable step
        increments ``resilience.checkpoint_fallbacks`` and falls back
        to the previous one; raises :class:`NoValidCheckpointError`
        when none survive."""
        steps = self.steps()
        for step in reversed(steps):
            path = self.step_dir(step)
            try:
                self.validate(step)

                def _read():
                    _faults.check("checkpoint.read")
                    return model.load_states(
                        os.path.join(path, STATES_NAME))

                with _trace.span("resilience/checkpoint_restore",
                                 cat="resilience", step=int(step)):
                    aux = retry_call(_read, "checkpoint.read",
                                     policy=self.retry_policy)
                self._log.info("restored checkpoint step=%d from %s",
                               step, path)
                return step, aux
            except Exception as e:
                # CheckpointCorruptError, zipfile.BadZipFile,
                # truncated-read OSError, retry give-up, state-shape
                # mismatch: all mean "this step cannot serve a
                # restore" — record the fallback and walk back
                self._c_fallbacks.inc()
                _trace.event("resilience/checkpoint_fallback",
                             cat="resilience", step=int(step),
                             error=repr(e))
                self._log.error(
                    "checkpoint step %d unusable (%r); falling back "
                    "to previous", step, e)
        raise NoValidCheckpointError(
            f"no valid checkpoint under {self.root} "
            f"(tried steps {list(reversed(steps))})")
