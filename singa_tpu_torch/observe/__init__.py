"""singa_tpu_torch.observe — tracing, metrics, request ledger, step
anatomy, monitoring, SLOs and health for training and serving (the
counterpart of ``singa_tpu/observe/``, the port's own copy).

One event model (``trace``: spans and instants), one process-wide
metrics surface (``registry``), three exporters (``export``: JSONL,
Chrome trace-event JSON, Prometheus text); the per-request lifecycle
ledger (``requests``), the per-step host/device anatomy of the serve
engine (``stepprof``), the flight recorder, crash bundles, MFU and the
hang watchdog (``monitor``), windowed rings (``timeseries``), burn-rate
alerting (``slo``), cross-host merging (``federate``) and the one-call
summary :func:`health_report` with the serve :class:`SLO`
(``health``).  Everything is off until enabled and costs one flag read
per site when off; the registry is always on.

    from singa_tpu_torch import observe
    observe.enable()
    observe.monitor.start()
    ...train / serve...
    observe.export.write_chrome_trace("/tmp/trace.json")
    print(observe.health_report()["train"]["mfu"])
"""

from . import export  # noqa: F401
from . import trace  # noqa: F401
from .registry import (Counter, Gauge, Histogram,  # noqa: F401
                       MetricsRegistry, registry)
from .trace import (clear, disable, drain, dropped,  # noqa: F401
                    enable, event, events, is_enabled, set_max_events,
                    span, traced)
from . import stepprof  # noqa: F401
from .stepprof import StepProfiler  # noqa: F401
from . import monitor  # noqa: F401
from . import requests  # noqa: F401
from .requests import RequestLedger  # noqa: F401
from . import timeseries  # noqa: F401
from .timeseries import WindowedFamily, WindowRing  # noqa: F401
from . import slo  # noqa: F401
from .slo import BurnRule, SLOPolicy  # noqa: F401
from . import federate  # noqa: F401
from .federate import ClockSync, FleetTelemetry  # noqa: F401
from . import health  # noqa: F401
from .health import SLO, health_report  # noqa: F401
