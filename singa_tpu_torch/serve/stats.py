"""Serving telemetry (counterpart of ``singa_tpu/serve/stats.py``):
per-request latency, queue and slot gauges, token counts, all in the
process-wide registry (``observe/registry.py``) under ``serve.*`` with
an ``engine=<n>`` label, one label value per engine.

* **TTFT**: submit to the first (prefill) token, queue wait included.
* **TPOT**: (last token - first token) / (n - 1); a request that emits
  one token has no TPOT sample.  It counts every token a step emitted,
  however many: on a speculative engine it is step time over accepted
  tokens, so a draft that stops agreeing shows as a worse TPOT.
* **queue wait / admission**: TTFT split into submit -> admission and
  admission -> first token (the prefill), the latter by ``kind``:
  ``cold``, or ``warm`` when a prefix-cache hit skipped part of it.
* **occupancy**: live slots / max_slots, sampled once per decode step;
  **queue depth**: sampled after each step's scheduling pass.

* **paged**: the paged arena's snapshot (``serve/paged.py``): block
  size, whether its pools are int8 (``quant``), blocks free and used,
  and the preemption counters ``serve.paged.preemptions``,
  ``serve.paged.swap_out`` and ``serve.paged.swap_in``, which the arena
  registers in this registry under the same label, as in the JAX
  package; None on the slot arena, which has no blocks and does not
  preempt.

* **prefix**: the prefix cache's snapshot (``serve/prefix.py``): hits,
  misses, evictions, cached blocks, hit and lookup tokens and the
  token hit rate, from the ``serve.prefix.*`` metrics the cache
  registers under the same label; None without a cache.

* **spec** (speculative engines only): ``serve.spec.accepted`` and
  ``serve.spec.drafted``, the draft proposals the target's verify kept
  and offered, and ``serve.spec.chunks``, one a live slot a speculative
  step: the acceptance rate on live traffic and the tokens a chunk;
  None on other engines.

* **budget_chunks**: ``serve.prefill.budget_chunks``, the block-width
  chunk passes the chunked-prefill token budget split admissions into
  (None without a budget).

* **fork** (paged engines): ``serve.fork.branches`` (branches forked off
  live slots, by ``n > 1`` admissions and ``fork()``),
  ``serve.fork.cow_copies`` (blocks a branch copied before writing into
  one a sibling still shared), ``serve.fork.pruned`` (branches cut by
  ``prune()``) and the gauge ``serve.fork.shared_blocks`` (arena blocks
  with more than one reference); None on the slot arena.

* **slo** (an engine built with ``slo=observe.SLO(...)``): the targets
  and the ``serve.slo_violations{kind=ttft|tpot|queue}`` counters: a
  retiring request whose TTFT passes ``ttft_p99_s`` or whose TPOT passes
  ``tpot_p50_s``, and a scheduling pass that leaves the queue deeper
  than ``queue_depth_max``, each with a ``serve/slo_violation`` or
  ``serve/queue_pressure`` trace instant; None without an SLO.

All times come from the engine's clock, so a fake clock makes the
snapshot deterministic in tests.
"""

from __future__ import annotations

import itertools

from ..observe import trace as _trace
from ..observe.registry import registry

__all__ = ["EngineStats"]

_engine_ids = itertools.count()


class EngineStats:
    """Accumulated over an engine's lifetime; ``snapshot()`` at any
    point.  ``unregister()`` drops the metrics from the registry (the
    engine's ``close()``)."""

    def __init__(self, max_slots: int, clock, reg=None, spec=False,
                 budget=False, fork=False, slo=None):
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
        self._h_admission = {
            kind: h("serve.request.admission_s",
                    help="admission->first-token seconds (the prefill, "
                         "cold or prefix-warm)", kind=kind, **lbl)
            for kind in ("cold", "warm")}
        self._queue_depth = g("serve.queue_depth",
                              help="scheduler queue depth", **lbl)
        self._occupancy = g("serve.occupancy",
                            help="live slots / max_slots, last decode step",
                            **lbl)
        self._registered = [
            self._submitted, self._completed, self._rej_deadline,
            self._rej_queue, self._prefills, self._decode_steps,
            self._tokens_out, self._h_ttft, self._h_tpot,
            self._h_queue_wait, self._h_admission["cold"],
            self._h_admission["warm"], self._queue_depth,
            self._occupancy]
        self.spec = bool(spec)
        if spec:
            self._spec = {n: c(f"serve.spec.{n}", help=h, **lbl) for n, h in (
                ("accepted", "draft proposals the target's verify kept"),
                ("drafted", "draft proposals offered to the verify"),
                ("chunks", "verify chunks, one a live slot a speculative "
                           "step"))}
            self._registered += list(self._spec.values())
        self._budget_chunks = None
        if budget:
            self._budget_chunks = c(
                "serve.prefill.budget_chunks",
                help="block-width chunk passes the chunked-prefill token "
                     "budget split admissions into", **lbl)
            self._registered.append(self._budget_chunks)
        self._fork = None
        if fork:
            self._fork = {n: c(f"serve.fork.{n}", help=h, **lbl) for n, h in (
                ("branches", "decoding branches forked off live slots (n > "
                             "1 admissions and fork() calls)"),
                ("cow_copies", "copy-on-write block copies: a branch about "
                               "to write into a block a sibling still "
                               "references got a private copy"),
                ("pruned", "branches cut by prune() (private blocks freed, "
                           "result sealed finish_reason='pruned')"))}
            self._fork["shared_blocks"] = g(
                "serve.fork.shared_blocks",
                help="arena blocks referenced more than once", **lbl)
            self._registered += list(self._fork.values())
        # recency-weighted TPOT, None until the first multi-token retire
        self.tpot_ewma = None
        self._tpot_alpha = 0.25
        self.slo = slo
        self._slo_viol = {}
        if slo is not None:
            for kind in ("ttft", "tpot", "queue"):
                self._slo_viol[kind] = c(
                    "serve.slo_violations",
                    help="requests/steps beyond the declared SLO target",
                    kind=kind, **lbl)
            self._registered += list(self._slo_viol.values())
        self._queue_depth_sum = 0
        self._queue_depth_max = 0
        self._queue_samples = 0
        self._occupancy_sum = 0.0
        # the arena's snapshot (blocks free/used, preemption and swap
        # counters) and the prefix cache's, set by the engine
        self.paged_source = None
        self.prefix_source = None

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

    def on_admission(self, queue_wait_s, admission_s, warm=False):
        self._h_queue_wait.observe(queue_wait_s)
        self._h_admission["warm" if warm else "cold"].observe(admission_s)

    def on_token(self):
        self._tokens_out.inc()

    def on_spec(self, accepted: int, drafted: int):
        """One live slot's verify: ``accepted`` of ``drafted`` proposals
        kept (its correction or bonus token is ``on_token``'s)."""
        self._spec["accepted"].inc(int(accepted))
        self._spec["drafted"].inc(int(drafted))
        self._spec["chunks"].inc()

    def on_budget_chunk(self):
        self._budget_chunks.inc()

    def on_fork(self, what, shared_blocks):
        """Count one fork event (``"branches"``, ``"cow_copies"`` or
        ``"pruned"``, or None for none) and set the shared-blocks
        gauge."""
        if what is not None:
            self._fork[what].inc()
        self._fork["shared_blocks"].set(shared_blocks)

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
        slo = self.slo
        if (slo is not None and slo.queue_depth_max is not None
                and queue_depth > slo.queue_depth_max):
            self._slo_viol["queue"].inc()
            _trace.event("serve/queue_pressure", cat="serve",
                         depth=queue_depth, limit=slo.queue_depth_max)

    def on_complete(self, result):
        self._completed.inc()
        self.ttft.record(result.ttft)
        if result.tpot is not None:
            self.tpot.record(result.tpot)
            a = self._tpot_alpha
            self.tpot_ewma = (result.tpot if self.tpot_ewma is None
                              else (1 - a) * self.tpot_ewma
                              + a * result.tpot)
        slo = self.slo
        if slo is None:
            return
        if slo.ttft_p99_s is not None and result.ttft > slo.ttft_p99_s:
            self._slo_viol["ttft"].inc()
            _trace.event("serve/slo_violation", cat="serve", kind="ttft",
                         request=result.request_id, value=result.ttft,
                         target=slo.ttft_p99_s)
        if (slo.tpot_p50_s is not None and result.tpot is not None
                and result.tpot > slo.tpot_p50_s):
            self._slo_viol["tpot"].inc()
            _trace.event("serve/slo_violation", cat="serve", kind="tpot",
                         request=result.request_id, value=result.tpot,
                         target=slo.tpot_p50_s)

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
                "uptime_s": wall,
                "tokens_per_s": self.tokens_out / wall,
                # every emitted token was asked for: this is goodput
                "goodput_tokens_per_s": self.tokens_out / wall,
                "prefills": self._prefills.value,
                "decode_steps": steps,
            },
            "latency": {"ttft": self.ttft.summary(),
                        "tpot": self.tpot.summary(),
                        "admission": {k: v.series.summary() for k, v
                                      in self._h_admission.items()},
                        "tpot_ewma_s": self.tpot_ewma},
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
            "slo": (None if self.slo is None else {
                "targets": self.slo.asdict(),
                "violations": {k: m.value
                               for k, m in self._slo_viol.items()}}),
            "paged": (self.paged_source()
                      if self.paged_source is not None else None),
            "prefix": (self.prefix_source()
                       if self.prefix_source is not None else None),
            "spec": self._spec_snapshot(),
            "budget_chunks": (None if self._budget_chunks is None
                              else self._budget_chunks.value),
            "fork": (None if self._fork is None else
                     {n: m.value for n, m in self._fork.items()}),
        }

    def _spec_snapshot(self):
        if not self.spec:
            return None
        acc, dr, ch = (self._spec[n].value
                       for n in ("accepted", "drafted", "chunks"))
        return {"drafted": dr, "accepted": acc, "chunks": ch,
                "acceptance_rate": acc / dr if dr else None,
                "tokens_per_chunk": (acc + ch) / ch if ch else None}
