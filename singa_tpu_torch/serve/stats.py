"""Serving telemetry (counterpart of ``singa_tpu/serve/stats.py``):
per-request latency, queue and slot gauges, token counts, all in the
process-wide registry (``observe/registry.py``) under ``serve.*`` with
an ``engine=<n>`` label, one label value per engine.

* **TTFT**: submit to the first (prefill) token, queue wait included.
* **TPOT**: (last token - first token) / (n - 1); a request that emits
  one token has no TPOT sample.
* **queue wait / admission**: TTFT split into submit -> admission and
  admission -> first token (the prefill).
* **occupancy**: live slots / max_slots, sampled once per decode step;
  **queue depth**: sampled after each step's scheduling pass.

* **paged**: the arena's snapshot (``serve/paged.py``): blocks free and
  used, and the preemption counters ``serve.paged.preemptions``,
  ``serve.paged.swap_out`` and ``serve.paged.swap_in``, which the arena
  registers in this registry under the same label, as in the JAX
  package.

All times come from the engine's clock, so a fake clock makes the
snapshot deterministic in tests.  The JAX version's SLO targets and
speculative-decoding counters are not ported yet.
"""

from __future__ import annotations

import itertools

from ..observe.registry import registry

__all__ = ["EngineStats"]

_engine_ids = itertools.count()


class EngineStats:
    """Accumulated over an engine's lifetime; ``snapshot()`` at any
    point.  ``unregister()`` drops the metrics from the registry (the
    engine's ``close()``)."""

    def __init__(self, max_slots: int, clock, reg=None):
        self.max_slots = int(max_slots)
        self._clock = clock
        self._t0 = clock()
        reg = reg if reg is not None else registry()
        self.registry = reg
        self.engine_label = str(next(_engine_ids))
        lbl = dict(engine=self.engine_label)
        c, g, h = reg.counter, reg.gauge, reg.histogram
        self._submitted = c("serve.submitted", help="submit() calls",
                            **lbl)
        self._completed = c("serve.completed",
                            help="requests retired normally", **lbl)
        self._rej_deadline = c("serve.rejected_deadline",
                               help="requests dropped past their deadline",
                               **lbl)
        self._rej_queue = c("serve.rejected_queue_full",
                            help="requests rejected by back-pressure", **lbl)
        self._prefills = c("serve.prefills", help="admission prefills run",
                           **lbl)
        self._decode_steps = c("serve.decode_steps",
                               help="pool decode steps run", **lbl)
        self._tokens_out = c("serve.tokens_out", help="tokens emitted",
                             **lbl)
        self._h_ttft = h("serve.ttft", help="submit->first-token seconds",
                         **lbl)
        self._h_tpot = h("serve.tpot", help="mean inter-token seconds",
                         **lbl)
        self.ttft = self._h_ttft.series
        self.tpot = self._h_tpot.series
        self._h_queue_wait = h("serve.request.queue_wait_s",
                               help="submit->admission seconds", **lbl)
        self._h_admission = h("serve.request.admission_s",
                              help="admission->first-token seconds", **lbl)
        self._queue_depth = g("serve.queue_depth",
                              help="scheduler queue depth", **lbl)
        self._occupancy = g("serve.occupancy",
                            help="live slots / max_slots, last decode step",
                            **lbl)
        self._registered = [
            self._submitted, self._completed, self._rej_deadline,
            self._rej_queue, self._prefills, self._decode_steps,
            self._tokens_out, self._h_ttft, self._h_tpot,
            self._h_queue_wait, self._h_admission, self._queue_depth,
            self._occupancy]
        self._queue_depth_sum = 0
        self._queue_depth_max = 0
        self._queue_samples = 0
        self._occupancy_sum = 0.0
        # the arena's snapshot (blocks free/used, preemption and swap
        # counters), set by the engine
        self.paged_source = None

    def unregister(self):
        self.registry.remove(*self._registered)

    @property
    def decode_steps(self):
        return self._decode_steps.value

    @property
    def tokens_out(self):
        return self._tokens_out.value

    def on_submit(self):
        self._submitted.inc()

    def on_queue_full(self):
        self._rej_queue.inc()

    def on_deadline_expired(self):
        self._rej_deadline.inc()

    def on_prefill(self):
        self._prefills.inc()

    def on_admission(self, queue_wait_s, admission_s):
        self._h_queue_wait.observe(queue_wait_s)
        self._h_admission.observe(admission_s)

    def on_token(self):
        self._tokens_out.inc()

    def on_decode_step(self, live_slots: int):
        self._decode_steps.inc()
        occ = live_slots / self.max_slots
        self._occupancy_sum += occ
        self._occupancy.set(occ)

    def on_schedule(self, queue_depth: int):
        self._queue_samples += 1
        self._queue_depth_sum += queue_depth
        self._queue_depth_max = max(self._queue_depth_max, queue_depth)
        self._queue_depth.set(queue_depth)

    def on_complete(self, result):
        self._completed.inc()
        self.ttft.record(result.ttft)
        if result.tpot is not None:
            self.tpot.record(result.tpot)

    def snapshot(self) -> dict:
        wall = max(self._clock() - self._t0, 1e-9)
        steps = self.decode_steps
        return {
            "requests": {
                "submitted": self._submitted.value,
                "completed": self._completed.value,
                "rejected_deadline": self._rej_deadline.value,
                "rejected_queue_full": self._rej_queue.value,
            },
            "throughput": {
                "tokens_out": self.tokens_out,
                "wall_s": wall,
                "tokens_per_s": self.tokens_out / wall,
                "prefills": self._prefills.value,
                "decode_steps": steps,
            },
            "latency": {"ttft": self.ttft.summary(),
                        "tpot": self.tpot.summary()},
            "queue": {
                "mean_depth": (self._queue_depth_sum / self._queue_samples
                               if self._queue_samples else 0.0),
                "max_depth": self._queue_depth_max,
            },
            "slots": {
                "max_slots": self.max_slots,
                "occupancy_mean": (self._occupancy_sum / steps
                                   if steps else 0.0),
            },
            "paged": (self.paged_source()
                      if self.paged_source is not None else None),
        }
