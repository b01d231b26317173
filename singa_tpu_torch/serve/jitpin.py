"""The serve stack's census of prepared decode steps (counterpart of
``singa_tpu/serve/jitpin.py:19``): the pin that a warmed-up engine
captures nothing more.

``jit_cache_size()`` is the number of decode steps the open engines of
this process hold prepared: CUDA graphs on the card, one per decode
key an engine has stepped at (a paged engine: its width, a halving
bucket of ``max_slots``, and whether the step takes vocabulary masks and
returns log-probabilities, so at most four a bucket; the slot arena:
one, at ``max_slots``), and on the CPU the step entries that stand in
for them.
A closed engine releases its steps.  After every bucket has been used
once the count must stay flat, however many steps follow.
"""

from __future__ import annotations

import weakref

__all__ = ["jit_cache_size", "track"]

_engines = weakref.WeakSet()


def track(engine):
    """Count ``engine``'s prepared steps (its ``_steps``) from now on."""
    _engines.add(engine)


def jit_cache_size() -> int:
    """Prepared decode steps held by the open engines of this process."""
    return sum(len(e._steps) for e in list(_engines))
