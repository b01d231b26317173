"""Caller-side handles of copy-on-write KV forking (counterpart of
``singa_tpu/serve/fork.py``).

Both shapes of parallel decoding ride on one engine mechanism
(``InferenceEngine._spawn_branch``: a live slot's block table is copied,
each of its blocks gains a reference in the paged arena, and a branch
about to write into a block a sibling still references first gets a
private copy of it):

* **best-of-n**: ``GenerationRequest(n=4)`` returns a
  :class:`ForkHandle`.  The engine admits the prompt once and forks n - 1
  branches off the admitted slot in the same scheduling pass; every
  branch shares every prompt block and sums the log-probability of its
  chosen tokens under the raw model distribution
  (``GenerationResult.score``), by which ``ranked()`` and ``best()``
  order the finished branches.
* **tree search**: a live branch forks again mid-stream
  (``BranchHandle.fork()``), and a losing one is cut by ``prune()``,
  which frees only its private blocks (shared ones stay until their last
  holder drops them) and seals a ``finish_reason="pruned"`` result.

The handles hold no state of their own: it lives in the engine's slots
and the arena's reference counts, and ``result()`` works after the
branch retires.
"""

from __future__ import annotations

__all__ = ["BranchHandle", "ForkHandle"]


class BranchHandle:
    """One decoding branch: a :class:`RequestHandle` plus the fork
    verbs.  Delegates ``done``/``result`` to the wrapped handle;
    ``fork``/``prune`` act on the engine while the branch is live."""

    def __init__(self, engine, handle, branch=0):
        self._engine = engine
        self._handle = handle
        self.branch = int(branch)

    @property
    def request(self):
        return self._handle.request

    @property
    def request_id(self):
        return self._handle.request.request_id

    def done(self):
        return self._handle.done()

    def result(self):
        return self._handle.result()

    def fork(self, *, seed=None, max_new_tokens=None):
        """Split this live branch in two: the original keeps its key
        chain, the returned sibling samples with ``fold_in(parent key,
        branch)`` (or a fresh chain from ``seed``) and optionally its own
        remaining-token budget.  Every block decoded so far is shared copy-on-write."""
        return self._engine.fork(self.request_id, seed=seed,
                                 max_new_tokens=max_new_tokens)

    def prune(self):
        """Cut this branch: frees its private (unshared, non-trash)
        blocks immediately and seals a ``finish_reason="pruned"``
        result carrying everything emitted so far.  Sibling branches
        are untouched.  No-op if the branch already finished."""
        if self._handle.done():
            return
        self._engine.prune(self.request_id)

    def __repr__(self):
        state = "done" if self._handle.done() else "live"
        return (f"BranchHandle({self.request_id!r}, "
                f"branch={self.branch}, {state})")


class ForkHandle:
    """The ``n > 1`` submission surface: one prompt, n branches.

    ``branches`` lists a :class:`BranchHandle` per branch (branch 0 is
    the parent — the exact stream ``n=1`` would have produced).  The
    engine forks siblings synchronously during the parent's admission
    pass, so once the parent is admitted the list is complete; before
    admission it holds just the queued parent (whose rejection, e.g. a
    passed deadline, is then the whole group's rejection).
    """

    def __init__(self, engine, parent_handle):
        self._engine = engine
        self._parent = parent_handle
        self._parent_branch = BranchHandle(engine, parent_handle, 0)

    @property
    def request(self):
        return self._parent.request

    @property
    def request_id(self):
        return self._parent.request.request_id

    @property
    def branches(self):
        """Parent branch plus every sibling forked off it so far."""
        kids = getattr(self._parent, "_fork_children", None) or []
        return [self._parent_branch] + [
            BranchHandle(self._engine, h, i + 1)
            for i, h in enumerate(kids)]

    def done(self):
        bs = self.branches
        return all(b.done() for b in bs) and (
            len(bs) >= self.request.n or self._parent._error is not None)

    def results(self):
        """Every branch's terminal result, branch order (pruned
        included).  Raises the group rejection if a branch was
        rejected."""
        return [b.result() for b in self.branches]

    def ranked(self):
        """Completed (non-pruned, non-rejected) results, best first:
        sorted by cumulative chosen-token logprob ``score``, branch
        index breaking ties deterministically."""
        out = []
        for b in self.branches:
            if not b.done() or b._handle._error is not None:
                continue
            r = b._handle._result
            if r is not None and r.finish_reason != "pruned":
                out.append(r)
        return sorted(out, key=lambda r: (-(r.score or 0.0), r.branch))

    def best(self):
        """Highest-scoring completed result (best-of-n's answer)."""
        ranked = self.ranked()
        if not ranked:
            raise RuntimeError(
                f"{self.request_id}: no completed branch to rank — "
                "drive the engine to completion first (or every "
                "branch was pruned/rejected)")
        return ranked[0]

    def __repr__(self):
        bs = self.branches
        return (f"ForkHandle({self.request_id!r}, n={self.request.n}, "
                f"branches={len(bs)}, "
                f"done={sum(1 for b in bs if b.done())})")
