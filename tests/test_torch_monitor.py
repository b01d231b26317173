"""The port's monitor (``singa_tpu_torch/observe/monitor.py``) against
the JAX package's ``singa_tpu/observe/monitor.py``, and the port's own
pieces of it: the H100 rows of the peak table, the ``torch.distributed``
rank as the watchdog's process label, and the per-step FLOP count that
takes the place of the XLA cost tables.

* The watchdog, driven by hand under one injected clock in both
  packages: the same beats give the same hang firings (latched once,
  re-armed by a beat, disarmed by an idle beat), the same step-time
  anomalies and the same summary; the flight recorder keeps the same
  tail; a crash bundle is strict JSON with the JAX bundle's keys.
* ``peak_flops``: NVIDIA's dense bf16 data-sheet figures, the PCIe part
  matched before the bare name; the TPU rows as the JAX table has them;
  nan for the CPU and unknown devices.
* The FLOP count: a tiny GPT-2 trained in graph mode with the monitor on
  counts, on a signature's first call, exactly 6 T N_mm + 12 L B S^2 d
  (the matrix products' parameters N_mm, T tokens; attention both ways)
  with the fused attention, whose products are aten ops; the flash
  kernels' wrappers credit the same attention term by shape
  (``_count_flops``), which the counter cannot see on the card.
"""

import json
import math
import os

import numpy as np
import pytest

import torch

from singa_tpu.observe import monitor as jmonitor
from singa_tpu.observe import trace as jtrace
from singa_tpu.observe.registry import MetricsRegistry as JRegistry
from singa_tpu_torch import device, opt, tensor
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.observe import monitor, trace
from singa_tpu_torch.observe.registry import MetricsRegistry
from singa_tpu_torch.ops import flash_attention as fa

CPU = device.create_cpu_device()


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("kind, peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 SXM5 80GB", 989e12), ("TPU v5 lite", 197e12),
    ("TPU v5p", 459e12), ("TPU v4", 275e12), ("cpu", float("nan")),
    ("NVIDIA A100-SXM4-80GB", float("nan"))])
def test_peak_flops_rows(kind, peak):
    got = monitor.peak_flops(kind)
    if math.isnan(peak):
        assert math.isnan(got)
    else:
        assert got == peak
    tpu = "tpu" in kind.lower()
    if tpu or math.isnan(peak):
        j = jmonitor.peak_flops(kind)
        assert (math.isnan(j) and math.isnan(got)) or j == got


def test_peak_flops_default_device_and_process_label():
    """Without a GPU the default is nan (the CPU has no entry); the
    watchdog's process label is the rank of an initialised process
    group, else "0"."""
    if not torch.cuda.is_available():
        assert math.isnan(monitor.peak_flops())
    assert monitor._process_rank() == "0"
    wd = monitor.Watchdog(reg=MetricsRegistry(), clock=Clock(),
                          dump_on_hang=False)
    assert wd._process == "0"


def _watchdog_script(mon, reg_cls):
    """Beats, silences and checks under one clock; the observable
    outcomes."""
    clock = Clock()
    reg = reg_cls()
    wd = mon.Watchdog(timeout_s=10.0, clock=clock, reg=reg, warmup=4,
                      z_threshold=3.0, dump_on_hang=False)
    out = []
    for i in range(12):
        clock.t += 1.0
        wd.beat("train", step_time=0.1 + 0.001 * (i % 3))
        out.append(wd.check())
    clock.t += 1.0
    wd.beat("train", step_time=5.0)   # an outlier: one anomaly
    wd.beat("serve.e0", step_time=0.05, fresh_compile=True)
    for _ in range(3):
        clock.t += 6.0
        out.append(wd.check())        # both silent past 10 s: fire once
    wd.beat("serve.e0", busy=False)   # idle is not hung
    clock.t += 30.0
    out.append(wd.check())
    wd.beat("train", step_time=0.1)   # re-armed
    clock.t += 11.0
    out.append(wd.check())
    summ = wd.summary()
    out.append({"hangs": wd.hangs, "summary": summ,
                "latched": wd.hang_latched("train"),
                "snap": reg.snapshot()})
    wd.forget("train")
    out.append(reg.snapshot())
    return out


def test_watchdog_hangs_and_anomalies_equal_jax():
    j = _watchdog_script(jmonitor, JRegistry)
    p = _watchdog_script(monitor, MetricsRegistry)
    assert json.dumps(p, sort_keys=True) == json.dumps(j, sort_keys=True)
    fired = [x for x in p[:-2] if x]
    assert fired == [["train", "serve.e0"], ["train"]]
    assert p[-2]["summary"]["sources"]["train"]["anomalies"] == 1


def _recorder_script(mon, tr):
    rec = mon.FlightRecorder(capacity=4)
    clock = Clock()
    rec.start()
    try:
        tr._clock = clock
        for i in range(6):
            clock.t += 1.0
            with tr.span("serve/decode_step", cat="serve", step=i):
                clock.t += 0.5
        tr.event("serve/retire", cat="serve", request="r")
        events = rec.events()
        main = tr.events()
    finally:
        rec.stop()
        tr._clock = __import__("time").perf_counter
    return events, main, len(rec)


def test_flight_recorder_keeps_the_tail_with_tracing_off():
    j = _recorder_script(jmonitor, jtrace)
    p = _recorder_script(monitor, trace)
    assert p == j
    events, main, n = p
    assert n == 4 and main == []
    assert events[-1]["name"] == "serve/retire"


def test_crash_bundle_is_strict_json_with_the_jax_keys(tmp_path):
    """``dump_report`` writes one strict-JSON bundle (nan as null) with the
    JAX bundle's schema and top-level keys, the recent events and the
    registry; ``install_crash_handler`` chains the excepthook and starts
    the recorder."""
    monitor.flight_recorder().start()
    try:
        with trace.span("train/step", cat="train", loss=float("nan")):
            pass
        path = monitor.dump_report(str(tmp_path / "p.json"), reason="t",
                                   extra={"x": float("inf")})
        jpath = jmonitor.dump_report(str(tmp_path / "j.json"), reason="t")
    finally:
        monitor.flight_recorder().stop()
        monitor.flight_recorder().clear()
    text = open(path).read()
    p = json.loads(text, parse_constant=lambda c: pytest.fail(c))
    j = json.load(open(jpath))
    assert p["schema"] == j["schema"] == "singa_tpu.crash/1"
    assert set(p) - {"x"} == set(j)
    assert p["x"] is None and p["reason"] == "t"
    assert p["recent_events"][-1]["args"]["loss"] is None
    assert p["host"]["process_index"] == 0
    import sys
    prev = sys.excepthook
    monitor.install_crash_handler(dir=str(tmp_path), signals=())
    try:
        assert sys.excepthook is not prev
        assert monitor.flight_recorder().active
    finally:
        monitor.uninstall_crash_handler()
        monitor.flight_recorder().stop()
        os.environ.pop("SINGA_TPU_CRASH_DIR", None)
    assert sys.excepthook is prev


def _train(cfg, steps=3, B=2, S=32):
    m = GPT2LMHead(cfg)
    m.set_optimizer(opt.SGD(lr=0.01))
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                           (B, S)).astype(np.int32)
    lab = np.roll(ids, -1, 1)
    m.compile([tensor.from_numpy(ids, CPU)], is_train=True,
              use_graph=True)
    x, y = tensor.from_numpy(ids, CPU), tensor.from_numpy(lab, CPU)
    for _ in range(steps):
        m(x, y)
    return m


def _analytic(cfg, B, S):
    d, L, V, ni = cfg.n_embd, cfg.n_layer, cfg.vocab_size, cfg.n_inner
    n_mm = L * (4 * d * d + 2 * d * ni) + V * d
    return 6 * B * S * n_mm + 12 * L * B * S * S * d


def test_step_flops_of_tiny_gpt2_equal_the_analytic_count():
    """With the monitor on, the graph runner counts a signature's first
    call: the fused-attention tiny GPT-2's step is exactly the analytic
    count, attention included; ``train.steps`` feeds the meter, which
    stays nan on the CPU (no peak)."""
    cfg = GPT2Config.tiny(dropout=0.0, attn_impl="fused")
    torch.manual_seed(0)
    monitor.start(thread=False, clock=Clock())
    try:
        _train(cfg)
        assert monitor.step_flops() == _analytic(cfg, 2, 32)
        s = monitor.mfu_meter().read()
        assert math.isnan(s["mfu"])
        summ = monitor.watchdog().summary()["sources"]["train"]
        assert summ["beats"] == 3
    finally:
        monitor.stop()
    assert monitor._flop_tally is None


def test_step_flops_not_counted_without_the_monitor():
    cfg = GPT2Config.tiny(dropout=0.0, attn_impl="fused")
    m = _train(cfg, steps=2)
    assert m._graph_runner._entries
    assert m._graph_runner.cost_tables() == []


def test_flash_wrappers_credit_the_attention_term():
    """What the three flash wrappers credit a launch on the card (the
    counter cannot see a ctypes launch): 4 B H S^2 D forward and 8 B H
    S^2 D backward, the attention term of the analytic count; nothing
    outside a counted step."""
    q = torch.zeros(2 * 4, 32, 16)
    monitor._flop_tally = tally = [0]
    try:
        fa._count_flops(q, q, 2)   # forward: QK^T, PV
        fa._count_flops(q, q, 2)   # dq: dP, dQ
        fa._count_flops(q, q, 2)   # dkv: dV, dK
    finally:
        monitor._flop_tally = None
    B, S, d = 2, 32, 64   # 4 heads of 16
    assert tally[0] == 12 * B * S * S * d
    fa._count_flops(q, q, 2)  # no tally open: nothing, no error
