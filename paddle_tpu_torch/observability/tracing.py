"""Request-scoped tracing for the serving plane.

The port's copy of ``paddle_tpu/observability/tracing.py``. The metrics
plane is aggregate-only; this module is the PER-REQUEST lifecycle view:
a trace minted at submission rides the
:class:`~paddle_tpu_torch.inference.predictor.GenerationRequest` handle
through every edge the serving stack moves it across (queue wait,
admission, each prefill chunk, each decode or verify commit it took
part in, preemption, recovery replay, finish) as HOST-side spans.
Spans carry replica id + slot + a per-request step seq, and
``Tracer.attach`` is a no-op on an already-traced request, so a
request rebuilt by a recovery keeps one trace.

Contracts:

- ZERO cost when disabled: every hook in :mod:`.hooks` that feeds this
  module starts with one module-attribute read (``tracing.enabled``):
  no allocation, no clock read (``serving_trace_now`` returns 0 and
  call sites skip the close entirely).
- NO device syncs: span timestamps come from the tracer's host clock;
  call sites close spans only at existing commit fences or on pure
  host paths.
- BOUNDED memory: each trace keeps at most ``max_spans`` spans (a ring:
  the tail survives, the drop count is kept), and the tracer holds at
  most ``max_traces`` traces (LRU by insertion; evictions counted).
- DETERMINISTIC under virtual time: the clock is injectable
  (``enable(clock_ns=...)``), so exports of one run are byte-identical
  to another's.

Exports: ``Tracer.chrome()`` (Chrome trace JSON through
:func:`chrome_trace`: one pid row per replica, one tid row per slot)
and per-request ``RequestTrace.ttft_breakdown()`` (queue_ms,
prefill_ms, handoff_ms, swap_ms, sched_overhead_ms).
"""
from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Optional

#: module-global fast-path flag — hooks read this directly (one
#: attribute read per disabled call)
enabled = False

_DEF_MAX_TRACES = 1024
_DEF_MAX_SPANS = 512

#: span name -> TTFT phase bucket. Anything unlisted is host-plane
#: bookkeeping and lands in sched_overhead_ms by subtraction.
PHASE_OF = {
    "queue_wait": "queue",
    "prefill_chunk": "prefill",
    "resume_replay": "prefill",
    "decode_step": "decode",
    "spec_verify": "decode",
    "handoff_export": "handoff",
    "handoff_import": "handoff",
    "swap_out": "swap",
    "swap_in": "swap",
    "wal_replay": "recovery",
}

#: phases whose span close can mint the first token (the TTFT stamp)
_FIRST_TOKEN_PHASES = ("prefill", "decode")


def chrome_trace(rows, pid_names: Optional[Dict[int, str]] = None,
                 tid_names: Optional[Dict[int, str]] = None) -> dict:
    """Rows -> a Chrome trace-event dict (``chrome://tracing`` /
    Perfetto's legacy JSON format); the port's copy of the reference's
    ``observability.timeline.chrome_trace``. Each row: {name, cat,
    start_ns, dur_ns, pid, tid, args?}. ``pid_names`` / ``tid_names``
    become process_name / thread_name metadata events, and events are
    ordered by (pid, tid, ts, dur, name) after the metadata, so two
    exports of the same spans serialize byte-identically."""
    meta = []
    for pid, label in sorted((pid_names or {}).items()):
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "tid": 0, "args": {"name": label}})
    for tid, label in sorted((tid_names or {}).items()):
        meta.append({"ph": "M", "name": "thread_name", "pid": 0,
                     "tid": tid, "args": {"name": label}})
    events = []
    for r in rows:
        ev = {"ph": "X", "name": r["name"], "cat": r.get("cat", ""),
              "pid": int(r.get("pid", 0)), "tid": int(r.get("tid", 0)),
              "ts": r["start_ns"] / 1e3,        # chrome wants microsecs
              "dur": r.get("dur_ns", 0) / 1e3}
        if r.get("args"):
            ev["args"] = r["args"]
        events.append(ev)
    events.sort(key=lambda e: (e["pid"], e["tid"], e["ts"], e["dur"],
                               e["name"]))
    return {"traceEvents": meta + events}


class Span:
    """One closed host-side span. Plain slots, no behavior — traces
    hold thousands of these."""

    __slots__ = ("name", "start_ns", "end_ns", "replica", "slot",
                 "seq", "meta")

    def __init__(self, name, start_ns, end_ns, replica=-1, slot=-1,
                 seq=-1, meta=None):
        self.name = name
        self.start_ns = int(start_ns)
        self.end_ns = int(end_ns)
        self.replica = int(replica)
        self.slot = int(slot)
        self.seq = int(seq)
        self.meta = meta

    @property
    def phase(self) -> str:
        return PHASE_OF.get(self.name, "sched")

    def to_dict(self) -> dict:
        d = {"name": self.name, "start_ns": self.start_ns,
             "end_ns": self.end_ns, "replica": self.replica,
             "slot": self.slot, "seq": self.seq}
        if self.meta:
            d["meta"] = self.meta
        return d


class RequestTrace:
    """The per-request span ring + the incrementally-maintained TTFT
    phase accumulator (kept OUTSIDE the ring so a long decode that
    evicts the early spans cannot lose the breakdown)."""

    __slots__ = ("trace_id", "rid", "submit_ns", "enqueued_ns",
                 "first_token_ns", "end_ns", "spans", "recorded",
                 "dropped", "phase_ns", "replicas", "done", "reason")

    def __init__(self, trace_id: int, rid: int, now_ns: int,
                 max_spans: int = _DEF_MAX_SPANS):
        self.trace_id = trace_id
        self.rid = rid
        self.submit_ns = now_ns
        self.enqueued_ns = now_ns     # re-stamped on every requeue
        self.first_token_ns = 0
        self.end_ns = 0
        self.spans = deque(maxlen=max(1, int(max_spans)))
        self.recorded = 0
        self.dropped = 0
        self.phase_ns = {}            # TTFT window only (pre first token)
        self.replicas = []            # insertion-ordered, deduped
        self.done = False
        self.reason = None

    def add(self, span: Span, tokens_seen: bool = False) -> None:
        self.recorded += 1
        if len(self.spans) == self.spans.maxlen:
            self.dropped += 1
        self.spans.append(span)
        if span.replica >= 0 and span.replica not in self.replicas:
            self.replicas.append(span.replica)
        if not self.first_token_ns:
            ph = span.phase
            self.phase_ns[ph] = (self.phase_ns.get(ph, 0)
                                 + max(0, span.end_ns - span.start_ns))
            if tokens_seen and ph in _FIRST_TOKEN_PHASES:
                self.first_token_ns = span.end_ns

    def ttft_breakdown(self) -> Optional[dict]:
        """Where this request's time-to-first-token went, in ms:
        {queue_ms, prefill_ms, handoff_ms, swap_ms, sched_overhead_ms,
        ttft_ms}. Pre-first-token decode/verify work counts as
        prefill_ms (it is compute toward the first token); the
        unattributed remainder — planning, dispatch bookkeeping,
        waiting for a slot in a full plan — is sched_overhead_ms.
        None until a first token exists."""
        if not self.first_token_ns:
            return None
        total = max(0, self.first_token_ns - self.submit_ns)
        q = self.phase_ns.get("queue", 0)
        p = (self.phase_ns.get("prefill", 0)
             + self.phase_ns.get("decode", 0))
        h = self.phase_ns.get("handoff", 0)
        s = self.phase_ns.get("swap", 0)
        return {
            "queue_ms": q / 1e6,
            "prefill_ms": p / 1e6,
            "handoff_ms": h / 1e6,
            "swap_ms": s / 1e6,
            "sched_overhead_ms": max(0, total - q - p - h - s) / 1e6,
            "ttft_ms": total / 1e6,
        }

    def to_dict(self, tail: Optional[int] = None) -> dict:
        spans = list(self.spans)
        if tail is not None:
            spans = spans[-tail:]
        d = {"trace_id": self.trace_id, "rid": self.rid,
             "submit_ns": self.submit_ns,
             "first_token_ns": self.first_token_ns,
             "end_ns": self.end_ns, "replicas": list(self.replicas),
             "recorded": self.recorded, "dropped": self.dropped,
             "done": self.done, "reason": self.reason,
             "spans": [s.to_dict() for s in spans]}
        bd = self.ttft_breakdown()
        if bd is not None:
            d["ttft_breakdown"] = bd
        return d


class Tracer:
    """The process trace registry: trace_id -> RequestTrace, LRU-capped
    at ``max_traces`` (insertion order; finished and live traces age
    out alike — the flight recorder snapshots tails before they do)."""

    def __init__(self, max_traces: int = _DEF_MAX_TRACES,
                 max_spans: int = _DEF_MAX_SPANS, clock_ns=None):
        self.max_traces = max(1, int(max_traces))
        self.max_spans = max(1, int(max_spans))
        self.clock_ns = clock_ns or time.monotonic_ns
        self.traces: "OrderedDict[int, RequestTrace]" = OrderedDict()
        self.evicted = 0
        self.spans_total = 0
        self._next_id = 1
        self._lock = threading.Lock()

    # ---- clock ----
    def now(self) -> int:
        return int(self.clock_ns())

    # ---- lifecycle ----
    def attach(self, req, replica: int = -1) -> RequestTrace:
        """Mint a trace onto ``req`` (idempotent: a request that
        already carries one — a handoff import, a failover rehome, a
        cluster request reaching a replica scheduler — keeps it, which
        is exactly what stitches cross-replica hops into one trace)."""
        tr = getattr(req, "trace", None)
        if tr is not None:
            return tr
        now = self.now()
        with self._lock:
            tr = RequestTrace(self._next_id, int(req.rid), now,
                              self.max_spans)
            self._next_id += 1
            self.traces[tr.trace_id] = tr
            while len(self.traces) > self.max_traces:
                self.traces.popitem(last=False)
                self.evicted += 1
        req.trace = tr
        tr.add(Span("submit", now, now, replica=replica))
        return tr

    def record(self, req, name: str, t0_ns: int, t1_ns: int = 0,
               replica: int = -1, slot: int = -1, seq: int = -1,
               meta=None) -> None:
        """Close a span opened at ``t0_ns`` (a ``now()`` anchor) onto
        ``req``'s trace; ``t1_ns=0`` closes at now. No-op for
        untraced requests (minted before enable, or evicted)."""
        tr = getattr(req, "trace", None)
        if tr is None or not t0_ns:
            return
        end = t1_ns or self.now()
        self.spans_total += 1
        tr.add(Span(name, t0_ns, end, replica=replica, slot=slot,
                    seq=seq, meta=meta),
               tokens_seen=bool(getattr(req, "tokens", None)))

    def mark(self, req, name: str, replica: int = -1, slot: int = -1,
             seq: int = -1, meta=None) -> None:
        """Zero-duration point event (preempt, dispatch, rehome, ...)."""
        now = self.now()
        self.record(req, name, now, now, replica=replica, slot=slot,
                    seq=seq, meta=meta)

    def enqueued(self, req) -> None:
        """Re-stamp the queue-wait anchor (submit and every requeue:
        preemption, recovery resume, shed-retry re-dispatch)."""
        tr = getattr(req, "trace", None)
        if tr is not None:
            tr.enqueued_ns = self.now()

    def admitted(self, req, replica: int = -1, slot: int = -1,
                 meta=None, t_ns: int = 0) -> None:
        """Close the queue_wait span opened at the last enqueue and
        mark the admission edge. ``t_ns``: the admission instant when
        the caller anchored it earlier (an admit path that swaps KV in
        first passes its entry time so queue and swap stay disjoint)."""
        tr = getattr(req, "trace", None)
        if tr is None:
            return
        now = t_ns or self.now()
        self.spans_total += 1
        tr.add(Span("queue_wait", tr.enqueued_ns, now, replica=replica,
                    slot=slot, meta=meta))
        tr.add(Span("admit", now, now, replica=replica, slot=slot))

    def first_token(self, req) -> None:
        """Stamp TTFT explicitly — the decode commit calls this for the
        rows whose first token just landed, so the stamp never depends
        on span ordering inside the commit."""
        tr = getattr(req, "trace", None)
        if tr is not None and not tr.first_token_ns:
            tr.first_token_ns = self.now()

    def finish(self, req, reason: str, replica: int = -1) -> None:
        tr = getattr(req, "trace", None)
        if tr is None or tr.done:
            return
        now = self.now()
        tr.done = True
        tr.reason = reason
        tr.end_ns = now
        tr.add(Span("finish", now, now, replica=replica,
                    meta={"reason": reason}))

    # ---- queries / exports ----
    def get(self, trace_id: int) -> Optional[RequestTrace]:
        return self.traces.get(trace_id)

    def trace_of(self, req) -> Optional[RequestTrace]:
        return getattr(req, "trace", None)

    def breakdowns(self) -> list:
        """Every trace's TTFT breakdown (finished-first-token only) —
        the raw rows an SLO report takes percentiles of."""
        out = []
        for tr in self.traces.values():
            bd = tr.ttft_breakdown()
            if bd is not None:
                out.append(bd)
        return out

    def tails(self, max_traces: int = 8, max_spans: int = 32) -> list:
        """The newest ``max_traces`` traces, each clipped to its last
        ``max_spans`` spans — the request-side half of a flight dump."""
        trs = list(self.traces.values())[-max(0, int(max_traces)):]
        return [tr.to_dict(tail=max_spans) for tr in trs]

    def chrome(self) -> dict:
        """Chrome trace-event JSON dict: one pid row per replica (the
        un-placed replica -1 renders as pid 0 "router"), one tid row
        per slot (slotless marks on tid 0). Sort-stable — see
        :func:`chrome_trace`."""
        rows = []
        for tr in self.traces.values():
            for s in tr.spans:
                args = {"trace_id": tr.trace_id, "rid": tr.rid,
                        "seq": s.seq}
                if s.meta:
                    args.update(s.meta)
                rows.append({
                    "name": s.name, "cat": s.phase,
                    "start_ns": s.start_ns,
                    "dur_ns": max(0, s.end_ns - s.start_ns),
                    "pid": s.replica + 1, "tid": max(0, s.slot) + 1,
                    "args": args})
        pids = sorted({r["pid"] for r in rows})
        labels = {p: ("router" if p == 0 else f"replica {p - 1}")
                  for p in pids}
        return chrome_trace(rows, pid_names=labels)

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome(), f, sort_keys=True,
                      separators=(",", ":"))
        return path

    def stats(self) -> dict:
        return {"traces": len(self.traces), "evicted": self.evicted,
                "spans_total": self.spans_total,
                "max_traces": self.max_traces,
                "max_spans": self.max_spans}


#: the process tracer — replaced wholesale by :func:`enable`
TRACER = Tracer()


def enable(clock_ns=None, max_traces: int = _DEF_MAX_TRACES,
           max_spans: int = _DEF_MAX_SPANS) -> Tracer:
    """Turn request tracing on with a FRESH registry (deterministic
    trace ids). ``clock_ns``: injectable monotonic-ns callable —
    FakeClock traffic passes a virtual clock so exports are
    byte-identical run-to-run."""
    global enabled, TRACER
    TRACER = Tracer(max_traces=max_traces, max_spans=max_spans,
                    clock_ns=clock_ns)
    enabled = True
    return TRACER


def disable() -> None:
    global enabled
    enabled = False


def tracing_enabled() -> bool:
    return enabled
