"""Process-global metrics registry.

The port's copy of ``paddle_tpu/observability/metrics.py``: Counters,
Gauges and Histograms with labels in a Prometheus-style registry,
exportable as Prometheus text exposition format and as a JSON snapshot.
Everything is thread-safe: hot-path emitters run from the supervisor's
watchdog thread concurrently with a scrape.

The registry itself is always live; whether the hot paths FEED it is
gated by :mod:`.hooks` (one module-global flag), so a disabled process
pays one boolean read per instrumented call site and allocates nothing.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# latency-oriented default buckets (seconds): 100us .. 60s
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _fmt_labels(names: Sequence[str], values: Sequence[str],
                extra: Tuple[str, str] = None) -> str:
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(f'{extra[0]}="{extra[1]}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _CounterValue:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    def get(self) -> float:
        return self._value


class _GaugeValue:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    def get(self) -> float:
        return self._value


class _HistogramValue:
    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]):
        self._lock = threading.Lock()
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +1: +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float):
        v = float(value)
        with self._lock:
            i = len(self.buckets)
            for j, b in enumerate(self.buckets):
                if v <= b:
                    i = j
                    break
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def get(self) -> dict:
        with self._lock:
            cum, out = 0, {}
            for b, c in zip(self.buckets, self.counts):
                cum += c
                out[b] = cum
            return {"buckets": out, "sum": self.sum, "count": self.count}


class Metric:
    """One named metric; label combinations materialize child values."""

    kind = "untyped"
    _child_cls = _CounterValue

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        if not name or not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _new_child(self):
        return self._child_cls()

    def labels(self, *values, **kwvalues):
        if kwvalues:
            if values:
                raise ValueError("pass labels positionally OR by name")
            try:
                values = tuple(kwvalues[n] for n in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e.args[0]!r} "
                    f"(labelnames={self.labelnames})") from None
            if len(kwvalues) != len(self.labelnames):
                extra = set(kwvalues) - set(self.labelnames)
                raise ValueError(f"{self.name}: unknown labels {extra}")
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label "
                f"value(s) {self.labelnames}, got {len(values)}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.get(values)
                if child is None:
                    child = self._children[values] = self._new_child()
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; call "
                f".labels(...) first")
        return self.labels()

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())


class Counter(Metric):
    kind = "counter"
    _child_cls = _CounterValue

    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    def get(self) -> float:
        return self._default().get()


class Gauge(Metric):
    kind = "gauge"
    _child_cls = _GaugeValue

    def set(self, value: float):
        self._default().set(value)

    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    def dec(self, amount: float = 1.0):
        self._default().dec(amount)

    def get(self) -> float:
        return self._default().get()


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(buckets if buckets is not None
                          else DEFAULT_BUCKETS))
        if not bs or any(not math.isfinite(b) for b in bs):
            raise ValueError("histogram buckets must be finite and "
                             "non-empty (+Inf is implicit)")
        self.buckets = bs

    def _new_child(self):
        return _HistogramValue(self.buckets)

    def observe(self, value: float):
        self._default().observe(value)

    def get(self) -> dict:
        return self._default().get()


class MetricsRegistry:
    """Get-or-create registry; name collisions across kinds, labels, or
    explicitly differing histogram buckets raise."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or \
                        m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.labelnames}")
                # explicit differing buckets must not silently reuse the
                # first registration's boundaries (None = don't care)
                buckets = kw.get("buckets")
                if buckets is not None and \
                        tuple(sorted(buckets)) != m.buckets:
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {m.buckets}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._metrics)

    def collect(self) -> List[Metric]:
        with self._lock:
            return list(self._metrics.values())

    def clear(self):
        """Drop every metric (tests / fresh rounds)."""
        with self._lock:
            self._metrics.clear()

    # ---- exporters ----
    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: List[str] = []
        for m in self.collect():
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for lv, child in m.children():
                if isinstance(child, _HistogramValue):
                    snap = child.get()
                    for b, cum in snap["buckets"].items():
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_fmt_labels(m.labelnames, lv, ('le', repr(float(b)))) }"
                            f" {cum}")
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels(m.labelnames, lv, ('le', '+Inf'))}"
                        f" {snap['count']}")
                    lab = _fmt_labels(m.labelnames, lv)
                    lines.append(f"{m.name}_sum{lab} {snap['sum']}")
                    lines.append(f"{m.name}_count{lab} {snap['count']}")
                else:
                    lab = _fmt_labels(m.labelnames, lv)
                    lines.append(f"{m.name}{lab} {child.get()}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> dict:
        """Structured snapshot: {name: {kind, help, values}}; histogram
        values carry bucket counts + sum/count."""
        out = {}
        for m in self.collect():
            values = {}
            for lv, child in m.children():
                key = ",".join(f"{n}={v}" for n, v in
                               zip(m.labelnames, lv)) or ""
                v = child.get()
                if isinstance(child, _HistogramValue):
                    v = {"buckets": {repr(b): c for b, c in
                                     v["buckets"].items()},
                         "sum": v["sum"], "count": v["count"]}
                values[key] = v
            out[m.name] = {"kind": m.kind, "help": m.help,
                           "labels": list(m.labelnames), "values": values}
        return out

    def dumps(self) -> str:
        return json.dumps(self.to_json())


#: the process-global registry every hook feeds
REGISTRY = MetricsRegistry()


def counter(name, help="", labelnames=()):
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()):
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=None):
    return REGISTRY.histogram(name, help, labelnames, buckets)
