"""Crash flight recorder for the serving plane.

The port's copy of ``paddle_tpu/observability/flight.py``: a fixed-size
ring per :class:`~paddle_tpu_torch.serving.EngineSupervisor` recording
the last N scheduler ticks (plan summary, budget use, degraded rung,
consecutive-failure count) plus the last M request-trace tails, dumped
as a CRC-framed ``flight-<ts>.json`` on :class:`~paddle_tpu_torch.
serving.EngineDead`, on any exception escaping ``step()``, and on
demand (``EngineSupervisor.dump_flight()``).

The file stays PLAIN json so the dump is greppable on a dead box with
no tooling: the envelope is ``{"magic": "PTFR", "version": 1, "crc32":
<crc of the canonical payload encoding>, "payload": {...}}`` and
:func:`load` re-encodes the parsed payload canonically to verify the
checksum, so a torn or bit-flipped dump fails loudly. Writes are
atomic (tmp + fsync + rename).
"""
from __future__ import annotations

import json
import os
import time
import zlib
from collections import deque
from typing import Optional

MAGIC = "PTFR"
VERSION = 1
PREFIX = "flight-"


def _canonical(payload) -> bytes:
    """The byte encoding the CRC covers. ``default=_jsonable`` maps
    numpy scalars (tick fields come straight off scheduler state) to
    native ints/floats, so the parsed payload re-encodes to the SAME
    bytes — the property :func:`load`'s verification rests on."""
    return json.dumps(payload, sort_keys=True, separators=(",", ":"),
                      default=_jsonable).encode("utf-8")


def _jsonable(x):
    item = getattr(x, "item", None)     # numpy scalar -> native
    if item is not None:
        try:
            return item()
        except Exception:
            pass
    tolist = getattr(x, "tolist", None)  # small numpy array -> list
    if tolist is not None:
        try:
            return tolist()
        except Exception:
            pass
    return str(x)


class FlightRecorder:
    """The per-supervisor ring. Always-on and allocation-light: one
    small dict append per scheduler tick (the supervisor already pays
    a WAL append per tick; this is noise next to it)."""

    def __init__(self, max_ticks: int = 256, max_traces: int = 8,
                 max_trace_spans: int = 32, meta: Optional[dict] = None):
        self.ticks = deque(maxlen=max(1, int(max_ticks)))
        self.max_traces = int(max_traces)
        self.max_trace_spans = int(max_trace_spans)
        self.meta = dict(meta or {})
        self.ticks_total = 0
        self.dumps = []          # paths this recorder wrote

    def record_tick(self, **fields) -> None:
        self.ticks_total += 1
        self.ticks.append(fields)

    def last_ticks(self) -> list:
        return list(self.ticks)

    def dump(self, dir_path: str, reason: str,
             extra: Optional[dict] = None) -> str:
        """Write the black box: ring + request-trace tails (when
        tracing is on) + supervisor-supplied extras. Returns the
        path. Never called from a context that can tolerate a second
        failure — callers wrap it best-effort."""
        from . import tracing
        os.makedirs(dir_path, exist_ok=True)
        payload = {
            "reason": str(reason),
            "wall_time": time.time(),
            "meta": self.meta,
            "ticks_total": self.ticks_total,
            "ticks": list(self.ticks),
            "traces": (tracing.TRACER.tails(self.max_traces,
                                            self.max_trace_spans)
                       if tracing.enabled else []),
            "extra": extra or {},
        }
        body = _canonical(payload)
        doc = (b'{"magic":"%s","version":%d,"crc32":%d,"payload":'
               % (MAGIC.encode(), VERSION, zlib.crc32(body))
               ) + body + b"}"
        path = os.path.join(dir_path, f"{PREFIX}{time.time_ns()}.json")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(doc)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self.dumps.append(path)
        return path


def load(path: str) -> dict:
    """Parse + integrity-check a flight dump; returns the payload.
    Raises ValueError on a bad magic, version, or CRC mismatch (a torn
    or corrupted dump must fail loudly, like a torn WAL frame)."""
    with open(path, "rb") as f:
        doc = json.load(f)
    if doc.get("magic") != MAGIC:
        raise ValueError(f"{path}: not a flight dump (magic "
                         f"{doc.get('magic')!r})")
    if doc.get("version") != VERSION:
        raise ValueError(f"{path}: unsupported flight dump version "
                         f"{doc.get('version')!r}")
    payload = doc.get("payload")
    crc = zlib.crc32(_canonical(payload))
    if crc != doc.get("crc32"):
        raise ValueError(f"{path}: flight dump CRC mismatch "
                         f"(stored {doc.get('crc32')}, computed {crc})")
    return payload


def find_dumps(dir_path: str) -> list:
    """All flight dumps under ``dir_path``, oldest first (the
    timestamped names sort chronologically)."""
    try:
        names = sorted(n for n in os.listdir(dir_path)
                       if n.startswith(PREFIX) and n.endswith(".json"))
    except OSError:
        return []
    return [os.path.join(dir_path, n) for n in names]
