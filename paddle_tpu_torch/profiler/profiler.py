"""Host-span collector (reference: python/paddle/profiler/profiler.py).

The port's copy of the host tier of ``paddle_tpu/profiler/profiler.py``:
:class:`RecordEvent` spans land in the process-global collector while
it is recording, which :mod:`~paddle_tpu_torch.observability.hooks`
reads (``hooks.span`` and the closed-span hooks). Spans are kept in a
plain Python list. The ``Profiler`` class with its step scheduler and
device tier is not ported yet (ROADMAP.md, queue A step 9b).
"""
from __future__ import annotations

import threading
import time
from typing import List


class _Event:
    __slots__ = ("name", "start", "end", "tid", "event_type")

    def __init__(self, name, start, end, tid, event_type="UserDefined"):
        self.name = name
        self.start = start
        self.end = end
        self.tid = tid
        self.event_type = event_type

    @property
    def duration(self):
        return self.end - self.start


class _Collector:
    """Host event buffer (the HostTracer analog): closed spans append
    under a lock while ``enabled``."""

    def __init__(self):
        self.events: List[_Event] = []
        self.enabled = False
        self.lock = threading.Lock()

    def add(self, ev: _Event):
        with self.lock:
            self.events.append(ev)

    def drain(self) -> List[_Event]:
        """A copy of every span recorded so far."""
        with self.lock:
            return list(self.events)

    def clear(self):
        with self.lock:
            self.events.clear()


_collector = _Collector()


class RecordEvent:
    """Span instrumentation (reference: paddle/phi/api/profiler/
    event_tracing.h:32 RecordEvent; python/paddle/profiler/utils.py
    RecordEvent). Usable as context manager or begin()/end()."""

    def __init__(self, name: str, event_type: str = "UserDefined"):
        self.name = name
        self.event_type = event_type
        self._start = None

    def begin(self):
        self._start = time.perf_counter_ns()

    def end(self):
        if self._start is None or not _collector.enabled:
            return
        _collector.add(_Event(self.name, self._start,
                              time.perf_counter_ns(),
                              threading.get_ident(), self.event_type))
        self._start = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
