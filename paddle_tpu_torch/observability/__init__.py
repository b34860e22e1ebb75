"""Runtime telemetry of the port: metrics registry, hot-path hooks,
request tracing and the crash flight recorder.

The port's counterpart of ``paddle_tpu/observability``:

- :mod:`metrics` — process-global, thread-safe Counters / Gauges /
  Histograms with labels, exportable as Prometheus text
  (``REGISTRY.to_prometheus()``) and JSON (``REGISTRY.to_json()``).
- :mod:`hooks` — the emitters the serving engine, the scheduler, the
  supervisor and dense ``generate`` call. Near-zero cost when disabled:
  one module-flag read per call site, no allocation (``hooks.span``
  hands back a shared nullcontext).
- :mod:`tracing` — request-scoped tracing for the serving plane: a
  trace minted at submission rides the request handle through queue,
  prefill, decode, preemption, recovery and finish; per-request TTFT
  breakdowns; Chrome export. Independent switch
  (``tracing.enable(clock_ns=...)``), zero-cost when off.
- :mod:`flight` — the crash flight recorder: per-supervisor ring of
  scheduler ticks + request-trace tails, dumped as a CRC-framed
  ``flight-<ts>.json`` black box on EngineDead / step exceptions / on
  demand.

The reference's ``timeline`` (the per-phase summary over a profiler's
spans) waits for the profiler's device tier (ROADMAP.md, queue A step
9b).

Usage::

    import paddle_tpu_torch.observability as obs
    obs.enable()                       # or PADDLE_TPU_METRICS=1
    ... run serving ...
    print(obs.REGISTRY.to_prometheus())   # scrape payload
    obs.disable()
"""
from . import metrics  # noqa: F401
from . import hooks  # noqa: F401
from . import tracing  # noqa: F401
from . import flight  # noqa: F401
from .metrics import (  # noqa: F401
    REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
    counter, gauge, histogram,
)
from .hooks import enable, disable, metrics_enabled, span  # noqa: F401
from .tracing import RequestTrace, Tracer, chrome_trace  # noqa: F401
from .flight import FlightRecorder  # noqa: F401
