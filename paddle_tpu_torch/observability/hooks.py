"""Hot-path instrumentation hooks.

The port's counterpart of ``paddle_tpu/observability/hooks.py``: the
serving engine, the SLO scheduler, the supervisor and dense
``generate`` call into THIS module instead of touching the registry or
the span collector directly, so the disabled-path cost is one
module-attribute read (``hooks.enabled``, or ``tracing.enabled`` for
the trace hooks) per call site: no allocation, no string formatting,
no lock.

Three independent switches feed three sinks:

- ``enabled`` (set via :func:`enable` / :func:`disable`, or the
  ``PADDLE_TPU_METRICS=1`` env at import): metric emission into
  :data:`.metrics.REGISTRY`;
- the span collector's RECORD state (:mod:`..profiler.profiler`): span
  emission; :func:`span` returns a shared ``nullcontext`` when it is
  off, so an un-profiled step allocates nothing;
- ``tracing.enabled`` (:func:`.tracing.enable`): per-request traces.

Device waits: a timing hook closes on a tensor the card computes
(:func:`_block`), and its callers only ever pass one from a COMMIT half,
where the fetch that follows waits for the same work anyway, so no
dispatch waits on the card with the hooks on. The host tier's page
moves (``serving_fused_latency("pool_move", ...)``) may wait too: they
run at admission, at a handoff or at a defrag, never in a dispatch.
The tp, dp, MoE and pipeline hooks come with the modules that call
them (ROADMAP.md, queue A).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

from ..profiler.profiler import RecordEvent, _Event, _collector
from . import metrics as _m
from . import tracing as _tr

#: module-global fast-path flag — call sites read this directly
enabled = os.environ.get("PADDLE_TPU_METRICS", "").lower() in (
    "1", "true", "yes", "on")

_NULL = contextlib.nullcontext()  # shared: the disabled span() result


def enable():
    """Turn metric emission on (idempotent)."""
    global enabled
    enabled = True


def disable():
    global enabled
    enabled = False


def metrics_enabled() -> bool:
    return enabled


def active() -> bool:
    """True when ANY sink wants events (metrics on, or the collector
    recording) — the guard for instrumentation that must time work."""
    return enabled or _collector.enabled


def span(name: str, event_type: str = "UserDefined"):
    """Context manager for a host span; a shared no-op unless the span
    collector is recording (spans feed ONLY the collector — metrics
    enabled alone must not pay the RecordEvent allocation)."""
    if not _collector.enabled:
        return _NULL
    return RecordEvent(name, event_type)


def _record(name: str, start_ns: int, end_ns: int, event_type: str):
    """Append a closed span to the collector (if recording)."""
    if _collector.enabled:
        _collector.add(_Event(name, start_ns, end_ns,
                              threading.get_ident(), event_type))


def _block(x):
    """Wait for the card work that produced ``x`` (a tensor, or a
    list / tuple / dict of them), so that a span measures the work and
    not its launch: an event recorded on the tensor's device's current
    stream, then waited on. CPU tensors and other values return at
    once. Called only from commit halves (module docstring)."""
    if isinstance(x, dict):
        x = list(x.values())
    for t in (x if isinstance(x, (list, tuple)) else (x,)):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            ev.synchronize()
            return


# ---------------- dense decoding ----------------

def generate_begin() -> int:
    """Phase-timing anchor; 0 when no sink is active (callers skip)."""
    if not (enabled or _collector.enabled):
        return 0
    return time.perf_counter_ns()


def generate_phase(phase: str, t0_ns: int, out, tokens: int) -> int:
    """Close a generate() phase opened at ``t0_ns``: fence ``out``,
    record the span, feed the phase histogram + token counter. Returns a
    fresh anchor for the next phase."""
    if not t0_ns:
        return 0
    _block(out)
    now = time.perf_counter_ns()
    _record(f"Generate.{phase}", t0_ns, now, "Forward")
    if enabled:
        secs = (now - t0_ns) / 1e9
        _m.histogram(f"generate_{phase}_seconds",
                     f"wall seconds per generate() {phase} phase"
                     ).observe(secs)
        _m.counter("generate_tokens_total",
                   "tokens processed by generate()",
                   ("phase",)).labels(phase).inc(tokens)
        if phase == "decode" and secs > 0:
            _m.gauge("generate_decode_tokens_per_sec",
                     "decode throughput of the last generate() call"
                     ).set(tokens / secs)
    return time.perf_counter_ns()


# ---------------- continuous-batching serving ----------------

def serving_admitted(n: int, prompt_tokens: int):
    """A FRESH request entered a decode slot (admission counter +
    prefill token counter). Preemption resumes re-enter through
    ``serving_resumed`` instead, so drained occupancy satisfies
    ``admissions - evictions == 0`` (resumes == preemptions cancel
    out)."""
    if not enabled:
        return
    _m.counter("serving_admissions_total",
               "requests admitted into decode slots").inc(n)
    _m.counter("serving_prefill_tokens_total",
               "prompt tokens prefilled into the paged cache"
               ).inc(prompt_tokens)


def serving_prefix(hit_tokens: int, miss_tokens: int):
    """One admission's prefix-cache outcome: ``hit`` tokens were mapped
    from already-prefilled shared pages (zero prefill FLOPs, zero fresh
    KV HBM), ``miss`` tokens go through chunked prefill. The ratio is
    the live prefix-cache hit rate — the multiplier on the
    shared-system-prompt serving win."""
    if not enabled:
        return
    _m.counter("serving_prefix_hit_tokens_total",
               "prompt tokens served from shared prefix pages"
               ).inc(hit_tokens)
    _m.counter("serving_prefix_miss_tokens_total",
               "prompt tokens that required fresh prefill"
               ).inc(miss_tokens)


def serving_prefill_chunk(t0_ns: int, out, tokens: int):
    """Close one chunked-prefill step opened at ``t0_ns`` (a
    :func:`generate_begin` anchor): fence ``out``, feed the per-chunk
    latency histogram — the engine's per-step latency bound — plus the
    chunk-size counter."""
    if not t0_ns:
        return
    _block(out)
    now = time.perf_counter_ns()
    _record("Serving.prefill_chunk", t0_ns, now, "Forward")
    if enabled:
        _m.histogram("serving_prefill_chunk_ms",
                     "wall milliseconds per chunked-prefill step",
                     buckets=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250,
                              500, 1000, 2500)).observe(
            (now - t0_ns) / 1e6)
        _m.counter("serving_prefill_chunk_tokens_total",
                   "prompt tokens prefilled via chunked prefill"
                   ).inc(tokens)


def serving_cancelled(n: int, reason: str):
    """A request was cancelled while QUEUED — it never held a slot or
    pages (e.g. the scheduler's ``deadline_exceeded``), so it must not
    count as an eviction: admissions - evictions is an occupancy
    derivation and would go negative."""
    if not enabled:
        return
    _m.counter("serving_cancellations_total",
               "queued requests cancelled before admission (never held "
               "a slot)", ("reason",)).labels(reason).inc(n)


def serving_retired(n: int, reason: str):
    """A request left its slot and recycled its pages; ``reason`` is a
    structured finish reason (``eos`` / ``max_len`` /
    ``deadline_exceeded`` / other cancellations of RUNNING requests —
    queued-request cancellations count in
    ``serving_cancellations_total`` instead)."""
    if not enabled:
        return
    _m.counter("serving_evictions_total",
               "requests retired from decode slots",
               ("reason",)).labels(reason).inc(n)


def serving_preempted(n: int, pages_freed: int):
    """A running request's pages were evicted back to the pool to make
    room for a higher-priority admission (it will resume token-
    identically later). ``pages_freed`` counts pages that actually
    reached the free list — trie-shared pages survive elsewhere."""
    if not enabled:
        return
    _m.counter("serving_preemptions_total",
               "requests preempted (pages evicted for higher-priority "
               "admissions)").inc(n)
    _m.counter("serving_preempt_pages_freed_total",
               "pages returned to the pool by preemption evictions"
               ).inc(pages_freed)


def serving_resumed(n: int, replay_tokens: int):
    """A preempted request re-entered a slot; ``replay_tokens`` is the
    continuation-prefill work its eviction cost (tokens re-forwarded —
    prefix-trie survivors subtract from it)."""
    if not enabled:
        return
    _m.counter("serving_resumes_total",
               "preempted requests resumed into decode slots").inc(n)
    _m.counter("serving_resume_replay_tokens_total",
               "tokens re-prefilled by preemption resumes"
               ).inc(replay_tokens)


def serving_spec_verify(t0_ns: int, out, rows: int, drafted: int,
                        accepted: int, t1_ns: int = 0):
    """Close one speculative-decode verify step opened at ``t0_ns`` (a
    :func:`generate_begin` anchor): fence the verify output, record the
    span, and feed the speculation counters — drafted/accepted token
    totals, the rejected-tail rollback counter, and the per-step
    acceptance-rate histogram (the quantity the adaptive per-row k is
    driven by; its EMA is observable as accepted/drafted over any
    scrape window). ``rows`` is the number of slots the verify
    advanced. ``t1_ns``: the caller's own device-fence timestamp —
    the engine fetches the verify output to the host (a fence)
    and only then runs its per-slot commit loop before reaching this
    hook, so the span must close at that fence, not at call time, or
    the histogram would charge the host loop to the device."""
    if not t0_ns:
        return
    _block(out)
    now = t1_ns or time.perf_counter_ns()
    _record("Serving.spec_verify", t0_ns, now, "Forward")
    if not enabled:
        return
    _m.histogram("serving_spec_verify_ms",
                 "wall milliseconds per speculative verify step",
                 buckets=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                          1000, 2500)).observe((now - t0_ns) / 1e6)
    _m.counter("serving_spec_steps_total",
               "speculative verify steps executed").inc()
    _m.counter("serving_spec_rows_total",
               "slots advanced through the verify program").inc(rows)
    _m.counter("serving_spec_drafted_tokens_total",
               "draft tokens proposed to the verify program"
               ).inc(drafted)
    _m.counter("serving_spec_accepted_tokens_total",
               "draft tokens accepted by greedy verification"
               ).inc(accepted)
    _m.counter("serving_spec_rollback_tokens_total",
               "rejected draft tokens whose KV rows were rolled back "
               "(length bookkeeping, no copy)").inc(drafted - accepted)
    if drafted:
        _m.histogram("serving_spec_acceptance_rate",
                     "accepted/drafted ratio per verify step",
                     buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75,
                              0.875, 1.0)).observe(accepted / drafted)


def serving_step(active: int, max_slots: int, pages_used: int,
                 pages_total: int):
    """One continuous-batching decode step: batch-occupancy histogram +
    block-pool utilization gauge."""
    if not enabled:
        return
    _m.histogram("serving_batch_occupancy",
                 "active decode slots per step, as a fraction of "
                 "max_batch",
                 buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875,
                          1.0)).observe(active / max(max_slots, 1))
    _m.gauge("serving_block_pool_utilization",
             "fraction of the paged KV block pool in use"
             ).set(pages_used / max(pages_total, 1))
    _m.counter("serving_decode_steps_total",
               "continuous-batching decode steps").inc()
    _m.counter("serving_decode_tokens_total",
               "tokens decoded by the continuous-batching engine"
               ).inc(active)


# ---------------- SLO scheduler ----------------

def serving_queue_wait(seconds: float, priority: int):
    """One admission's time-in-queue (scheduler submit -> slot), by
    priority class — the SLO the scheduler exists to bound."""
    if not enabled:
        return
    _m.histogram("serving_time_in_queue_seconds",
                 "seconds from scheduler submit to slot admission",
                 ("priority",),
                 buckets=(0.001, 0.005, 0.025, 0.1, 0.5, 1, 2.5, 5, 10,
                          30, 60, 120)).labels(str(int(priority))
                                               ).observe(seconds)


def serving_sched_step(queue_depths, scheduled_tokens: int, budget):
    """One scheduler step: per-class queue-depth gauges + the
    budget-utilization gauge (skipped when no budget is configured).
    ``queue_depths`` maps priority class -> queued requests; classes
    that have EVER queued keep reporting (a depth that drops to zero
    must overwrite the stale gauge, not vanish)."""
    if not enabled:
        return
    g = _m.gauge("serving_queue_depth",
                 "queued requests awaiting admission, by priority class",
                 ("priority",))
    for prio, depth in queue_depths.items():
        g.labels(str(int(prio))).set(depth)
    _m.counter("serving_sched_steps_total",
               "SLO-scheduler steps planned").inc()
    _m.counter("serving_sched_tokens_total",
               "tokens scheduled by the step planner (decode slots + "
               "prefill-chunk widths)").inc(scheduled_tokens)
    if budget:
        _m.gauge("serving_step_budget_utilization",
                 "fraction of the per-step token budget the planner "
                 "scheduled").set(scheduled_tokens / budget)


def serving_overlap_step(exposed_ns: int, wall_ns: int, committed: int,
                         overlap: bool):
    """One scheduler step's host-plane attribution (the overlapped
    runtime's scoreboard). ``exposed_ns`` is the host
    bookkeeping time NOT hidden under an in-flight device program
    (wall minus commit-fence device waits minus the planning phase
    when it ran under an in-flight step); the ratio against the step's
    wall time is the ``serving_host_overhead_fraction`` gauge —
    measurably lower with ``overlap=True``, because expire/admit/plan
    then runs while the device executes. ``serving_sched_step_ms``
    (per-step wall latency, the p99 source) and the per-mode step
    counter ride alongside so sync-vs-overlap comparisons need no
    external clock."""
    if not enabled:
        return
    _m.gauge("serving_host_overhead_fraction",
             "fraction of the last scheduler step's wall time spent "
             "on exposed host-plane work (not hidden under an "
             "in-flight device program)").set(
        min(1.0, exposed_ns / max(1, wall_ns)))
    _m.histogram("serving_sched_step_ms",
                 "wall milliseconds per scheduler step (plan + "
                 "dispatch + commit)",
                 ("mode",),
                 buckets=(0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100,
                          250, 1000)).labels(
        "overlap" if overlap else "sync").observe(wall_ns / 1e6)
    _m.counter("serving_overlap_steps_total",
               "scheduler steps by execution mode",
               ("mode",)).labels(
        "overlap" if overlap else "sync").inc()
    if committed:
        _m.counter("serving_overlap_committed_total",
                   "units (tokens/slots/chunks) committed at step "
                   "commit fences").inc(committed)


def serving_sched_idle(fenced: bool):
    """A scheduler step planned zero tokens and committed nothing —
    all remaining work waits on device or swap completion. The run
    loop FENCED in-flight work (or yielded when there was nothing to
    fence) instead of busy-spinning through another empty
    expire/admit/plan pass."""
    if not enabled:
        return
    _m.counter("serving_sched_idle_steps_total",
               "zero-work scheduler steps resolved by fence or yield "
               "instead of re-planning",
               ("action",)).labels("fence" if fenced else "yield").inc()


# ---------------- faults, recovery, drain ----------------

def serving_fault(site: str, kind: str, injected: bool):
    """One serving fault, classified by hot-path site
    (:data:`paddle_tpu.serving.resilience.SITES`) and kind (the
    injector's mode, or the caught exception's class name). Injected
    faults (the deterministic :class:`FaultInjector`) and real ones
    keep SEPARATE counters — a chaos soak must be able to prove its
    faults were all its own."""
    if not enabled:
        return
    if injected:
        _m.counter("serving_fault_injected_total",
                   "faults fired by the deterministic fault injector",
                   ("site", "kind")).labels(site, kind).inc()
    else:
        _m.counter("serving_fault_failures_total",
                   "real (non-injected) serving step failures the "
                   "supervisor caught", ("site", "kind")
                   ).labels(site, kind).inc()


def serving_fault_recovery(t0_ns: int, sessions: int,
                           replay_tokens: int):
    """Close one supervisor recovery opened at ``t0_ns`` (a
    :func:`generate_begin` anchor): teardown + pool rebuild + journal
    restore. ``replay_tokens`` is the continuation-prefill bill the
    restored sessions will pay (prompt + committed tokens minus one,
    per admitted session) — the recovery-cost model's x-axis
    (recovery time grows with resident tokens)."""
    if not t0_ns:
        return
    now = time.perf_counter_ns()
    _record("Serving.fault_recovery", t0_ns, now, "UserDefined")
    if not enabled:
        return
    _m.histogram("serving_fault_recovery_ms",
                 "wall milliseconds per engine teardown+rebuild+restore",
                 buckets=(1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000,
                          2500, 5000)).observe((now - t0_ns) / 1e6)
    _m.counter("serving_fault_recoveries_total",
               "engine teardown+rebuild recoveries").inc()
    _m.counter("serving_fault_restored_sessions_total",
               "in-flight sessions restored through the resume replay"
               ).inc(sessions)
    _m.counter("serving_fault_replay_tokens_total",
               "tokens scheduled for re-prefill by crash recoveries"
               ).inc(replay_tokens)


def serving_degraded(level: int):
    """The supervisor's degraded-mode rung (0 = healthy, 1 = spec
    decode off, 2 = one-page prefill chunks, 3 = LOW admissions shed;
    one past the ladder = circuit open / dead) — the replica-health
    gauge a multi-engine router steers by."""
    if not enabled:
        return
    _m.gauge("serving_degraded_mode",
             "degraded-mode ladder rung of the engine supervisor "
             "(0 healthy .. 3 shed_low; 4 = circuit open)"
             ).set(level)


def serving_journal(entries: int, tokens: int):
    """Write-ahead request-journal size after a committed step: live
    entries and their resident tokens (prompt + committed) — the
    recovery bill if the engine died right now."""
    if not enabled:
        return
    _m.gauge("serving_fault_journal_entries",
             "live requests in the supervisor's write-ahead journal"
             ).set(entries)
    _m.gauge("serving_fault_journal_tokens",
             "resident tokens (prompt + committed) the journal would "
             "replay on a crash").set(tokens)


def serving_drain_checkpoint(t0_ns: int, nbytes: int, sessions: int,
                             trie_pages: int):
    """Close one engine drain opened at ``t0_ns``: checkpoint latency
    histogram + size gauges (bytes on disk, sessions checkpointed,
    prefix-trie pages persisted)."""
    if not t0_ns:
        return
    now = time.perf_counter_ns()
    _record("Serving.drain_checkpoint", t0_ns, now, "UserDefined")
    if not enabled:
        return
    _m.histogram("serving_drain_checkpoint_ms",
                 "wall milliseconds per drain checkpoint write",
                 buckets=(1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000,
                          2500, 5000)).observe((now - t0_ns) / 1e6)
    _m.gauge("serving_drain_checkpoint_bytes",
             "size of the last drain checkpoint on disk").set(nbytes)
    _m.counter("serving_drain_sessions_total",
               "in-flight sessions checkpointed by drains"
               ).inc(sessions)
    _m.counter("serving_drain_trie_pages_total",
               "prefix-trie pages persisted by drains").inc(trie_pages)


def serving_drain_restore(t0_ns: int, nbytes: int, sessions: int,
                          trie_pages: int):
    """Close one drain-checkpoint restore opened at ``t0_ns``: restore
    latency histogram + size gauges (the other half of the
    ``serving_drain_*`` pair — restarts are observable end to end)."""
    if not t0_ns:
        return
    now = time.perf_counter_ns()
    _record("Serving.drain_restore", t0_ns, now, "UserDefined")
    if not enabled:
        return
    _m.histogram("serving_drain_restore_ms",
                 "wall milliseconds per drain-checkpoint restore",
                 buckets=(1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000,
                          2500, 5000)).observe((now - t0_ns) / 1e6)
    _m.gauge("serving_drain_restore_bytes",
             "size of the last restored drain checkpoint").set(nbytes)
    _m.counter("serving_drain_restored_sessions_total",
               "sessions restored from drain checkpoints").inc(sessions)
    _m.counter("serving_drain_restored_trie_pages_total",
               "prefix-trie pages restored from drain checkpoints"
               ).inc(trie_pages)


# ---------------- durable journal (write-ahead log) ----------------

def serving_wal_append(t0_ns: int, nbytes: int):
    """One CRC-framed record appended to the on-disk write-ahead
    journal: append counter + bytes counter + latency histogram (the
    per-record half of the fsync ladder's cost)."""
    if not enabled:
        return
    _m.counter("serving_wal_appends_total",
               "records appended to the durable request journal").inc()
    _m.counter("serving_wal_bytes_total",
               "bytes appended to the durable request journal"
               ).inc(nbytes)
    _m.histogram("serving_wal_append_ms",
                 "wall milliseconds per WAL record append",
                 buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5,
                          5, 10, 25)).observe(
        (time.perf_counter_ns() - t0_ns) / 1e6)


def serving_wal_fsync(t0_ns: int):
    """One WAL fsync (per-commit policy: every append; group policy:
    amortized over the group-commit window): counter + latency
    histogram (the larger half of the durability cost)."""
    if not enabled:
        return
    _m.counter("serving_wal_fsyncs_total",
               "fsyncs run by the durable request journal").inc()
    _m.histogram("serving_wal_fsync_ms",
                 "wall milliseconds per WAL fsync",
                 buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50,
                          100)).observe(
        (time.perf_counter_ns() - t0_ns) / 1e6)


def serving_wal_checkpoint(t0_ns: int, nbytes: int, sessions: int,
                           segments_pruned: int):
    """One incremental WAL checkpoint (snapshot written atomically,
    covered log segments pruned — admissions never stopped): latency
    histogram + size gauge + sessions/pruned-segment counters."""
    if not t0_ns:
        return
    now = time.perf_counter_ns()
    _record("Serving.wal_checkpoint", t0_ns, now, "UserDefined")
    if not enabled:
        return
    _m.histogram("serving_wal_checkpoint_ms",
                 "wall milliseconds per incremental WAL checkpoint",
                 buckets=(1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                          1000)).observe((now - t0_ns) / 1e6)
    _m.gauge("serving_wal_checkpoint_bytes",
             "size of the last incremental WAL checkpoint").set(nbytes)
    _m.counter("serving_wal_checkpoints_total",
               "incremental WAL checkpoints written").inc()
    _m.counter("serving_wal_checkpoint_sessions_total",
               "live sessions snapshotted by WAL checkpoints"
               ).inc(sessions)
    _m.counter("serving_wal_segments_pruned_total",
               "log segments compacted away by WAL checkpoints"
               ).inc(segments_pruned)


def serving_wal_recovery(t0_ns: int, sessions: int, records: int,
                         torn_frames: int, quarantined: int):
    """One cold-restart recovery from the durable journal
    (:meth:`~paddle_tpu_torch.serving.EngineSupervisor.recover_from_disk`):
    recovery latency histogram, the recovery-replay gauge (sessions a
    dead process's journal brought back) and the media-fault counters
    — a torn tail truncated or a corrupt segment/checkpoint
    quarantined is an absorbed fault, and absorbed faults must be
    countable."""
    if not t0_ns:
        return
    now = time.perf_counter_ns()
    _record("Serving.wal_recovery", t0_ns, now, "UserDefined")
    if not enabled:
        return
    _m.histogram("serving_wal_recovery_ms",
                 "wall milliseconds per cold-restart WAL recovery",
                 buckets=(1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000,
                          2500, 5000)).observe((now - t0_ns) / 1e6)
    _m.gauge("serving_wal_recovered_sessions",
             "live sessions replayed by the last cold-restart "
             "recovery").set(sessions)
    _m.counter("serving_wal_replayed_records_total",
               "WAL records folded by cold-restart recoveries"
               ).inc(records)
    _m.counter("serving_wal_torn_frames_total",
               "torn WAL tails truncated at the last valid frame"
               ).inc(torn_frames)
    _m.counter("serving_wal_quarantined_total",
               "corrupt WAL segments/checkpoints quarantined during "
               "recovery").inc(quarantined)


# ---------------- sampled and model-draft speculation ----------------

def serving_sample_accept(drafted: int, accepted: int):
    """One REJECTION-SAMPLED verify commit: drafted/accepted token
    counters plus the per-step accept-rate histogram — the sampled
    sibling of ``serving_spec_acceptance_rate`` (temperature>0 rows
    accept with probability p(draft), so this rate IS the realized
    1+k·rate speedup multiplier of sampled speculative decode)."""
    if not enabled:
        return
    _m.counter("serving_sample_drafted_total",
               "draft tokens offered to rejection-sampled acceptance"
               ).inc(drafted)
    _m.counter("serving_sample_accepted_total",
               "draft tokens accepted by rejection sampling"
               ).inc(accepted)
    if drafted:
        _m.histogram("serving_sample_accept_rate",
                     "accepted/drafted ratio per rejection-sampled "
                     "verify step",
                     buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75,
                              0.875, 1.0)).observe(accepted / drafted)


def serving_draft_propose(rows: int, tokens: int, catchup: int):
    """One draft-model propose pass: ``rows`` slots drafted ``tokens``
    proposal tokens (linear chain tokens, or tree NODES under tree
    speculation) after ``catchup`` catch-up tokens re-fed through the
    draft forward (zero in steady state; prompt-sized on a cold slot —
    first propose, post-preemption resume, crash recovery, so this
    counter IS the disposable-draft-pool rebuild bill)."""
    if not enabled:
        return
    _m.counter("serving_draft_propose_total",
               "draft-model propose passes").inc()
    _m.counter("serving_draft_rows_total",
               "slots that received draft-model proposals").inc(rows)
    _m.counter("serving_draft_proposed_tokens_total",
               "draft-model proposal tokens (tree nodes under tree "
               "speculation)").inc(tokens)
    _m.counter("serving_draft_catchup_tokens_total",
               "committed-context tokens re-fed through the draft "
               "model to rebuild its disposable pool").inc(catchup)


def serving_draft_pool(pages_used: int, pages_usable: int):
    """Draft paged-pool occupancy after a propose pass — the second
    (small) pool's utilization gauge pair; balanced against its
    allocator after every rejection cascade by construction (proposal
    feeds never allocate; pages move only at admit/release)."""
    if not enabled:
        return
    _m.gauge("serving_draft_pool_pages_used",
             "draft-pool pages currently referenced").set(pages_used)
    _m.gauge("serving_draft_pool_pages_usable",
             "draft-pool pages usable (total minus reserved)"
             ).set(pages_usable)


def serving_tree_verify(t0_ns: int, out, rows: int, nodes: int,
                        accepted: int, paths, t1_ns: int = 0):
    """Close one TREE-speculation verify step opened at ``t0_ns``: the
    whole token tree scored in ONE forward. ``nodes``/``accepted``
    count tree nodes offered vs accepted along the committed root
    paths; ``paths`` is the per-row committed path length (accepted +
    1 — the path-length histogram is the quantity the (width, depth)
    expected-gain model is fit against). Same
    device-fence contract as :func:`serving_spec_verify`."""
    if not t0_ns:
        return
    _block(out)
    now = t1_ns or time.perf_counter_ns()
    _record("Serving.tree_verify", t0_ns, now, "Forward")
    if not enabled:
        return
    _m.histogram("serving_tree_verify_ms",
                 "wall milliseconds per tree-speculation verify step",
                 buckets=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                          1000, 2500)).observe((now - t0_ns) / 1e6)
    _m.counter("serving_tree_steps_total",
               "tree-speculation verify steps executed").inc()
    _m.counter("serving_tree_rows_total",
               "slots advanced through the tree verify program"
               ).inc(rows)
    _m.counter("serving_tree_nodes_total",
               "tree nodes proposed to the verify program").inc(nodes)
    _m.counter("serving_tree_accepted_nodes_total",
               "tree nodes accepted on committed root paths"
               ).inc(accepted)
    h = _m.histogram("serving_tree_path_len",
                     "committed root-path length per row (accepted "
                     "nodes + 1)",
                     buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32))
    for p in paths:
        h.observe(p)
    if nodes:
        _m.histogram("serving_tree_acceptance_rate",
                     "accepted/proposed node ratio per tree verify "
                     "step",
                     buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75,
                              0.875, 1.0)).observe(accepted / nodes)


# ---------------- constrained decoding ----------------

def serving_constrain(mask_ns: int, violations: int, rows: int):
    """One constrained decode commit: the host-side mask
    build/advance latency, the violation-avoided counter (steps where
    the UNCONSTRAINED argmax was grammar-invalid — each one is an
    output the mask saved from a parse failure), and the constrained
    row count."""
    if not enabled:
        return
    _m.histogram("serving_constrain_mask_ms",
                 "wall milliseconds per step of constraint mask "
                 "build + DFA advance",
                 buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5,
                          5, 10, 25)).observe(mask_ns / 1e6)
    _m.counter("serving_constrain_violations_avoided_total",
               "steps whose unconstrained argmax would have violated "
               "the grammar").inc(violations)
    _m.counter("serving_constrain_rows_total",
               "constrained rows advanced through masked sampling"
               ).inc(rows)


# ---------------- fused serving kernels ----------------

def serving_fused_dispatch(kernel: str, bytes_saved: int):
    """One fused-kernel dispatch counted into the serving programs,
    with the HBM bytes the fusion keeps out of the hot loop. The JAX
    package calls it at TRACE time (once per compiled program); the
    port compiles no programs, so nothing in it calls this hook, and
    the per-launch counts of its kernels live in the wrappers' launch
    counters instead."""
    if not enabled:
        return
    _m.counter("serving_fused_dispatch_total",
               "fused-kernel launches traced into serving programs",
               ("kernel",)).labels(kernel).inc()
    _m.counter("serving_fused_bytes_saved_total",
               "estimated HBM bytes the fused kernels keep out of the "
               "decode hot loop (per traced launch)",
               ("kernel",)).labels(kernel).inc(int(bytes_saved))
    _m.gauge("serving_fused_bytes_saved",
             "estimated HBM bytes saved per launch by each fused "
             "serving kernel", ("kernel",)).labels(kernel).set(
        int(bytes_saved))


def serving_fused_latency(kernel: str, t0_ns: int, out):
    """Close one HOST-timed fused-path step opened at ``t0_ns`` (the
    engine's decode/prefill/verify step with fusion on, or one fused
    page move): blocks on ``out`` so the histogram holds real device
    wall time per kernel — the ``decode_fused_speedup`` bench rider's
    per-kernel breakdown."""
    if not t0_ns:
        return
    _block(out)
    now = time.perf_counter_ns()
    _record(f"Serving.fused.{kernel}", t0_ns, now, "UserDefined")
    if not enabled:
        return
    _m.histogram("serving_fused_step_ms",
                 "wall milliseconds per fused-path serving step",
                 ("kernel",),
                 buckets=(0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100,
                          250, 1000)).labels(kernel).observe(
        (now - t0_ns) / 1e6)

# ---------------- hierarchical KV tier ----------------

def serving_swap_out(t0_ns: int, nbytes: int, pages: int):
    """Close one preemption SWAP-OUT opened at ``t0_ns``: the victim's
    live KV pages gathered device to host before its device pages freed
    (for a non-blocking swap-out, issue to fence). Latency histogram +
    bytes / pages counters."""
    if not t0_ns:
        return
    now = time.perf_counter_ns()
    _record("Serving.swap_out", t0_ns, now, "UserDefined")
    if not enabled:
        return
    _m.histogram("serving_swap_out_ms",
                 "wall milliseconds per preemption swap-out gather",
                 buckets=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                          1000)).observe((now - t0_ns) / 1e6)
    _m.counter("serving_swap_outs_total",
               "preemption victims swapped out to the host tier").inc()
    _m.counter("serving_swap_out_bytes_total",
               "KV bytes moved device→host by swap-outs").inc(nbytes)
    _m.counter("serving_swap_pages_total",
               "KV pages moved through the host tier",
               ("direction",)).labels("out").inc(pages)


def serving_swap_in(t0_ns: int, nbytes: int, pages: int):
    """Close one resume SWAP-IN opened at ``t0_ns``: fresh pages
    allocated and the host payload scattered back, the resume that
    replaces the replay prefill. Latency histogram + bytes / pages
    counters. The scatter is queued, not waited for: the histogram
    holds host time."""
    if not t0_ns:
        return
    now = time.perf_counter_ns()
    _record("Serving.swap_in", t0_ns, now, "UserDefined")
    if not enabled:
        return
    _m.histogram("serving_swap_in_ms",
                 "wall milliseconds per resume swap-in scatter",
                 buckets=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                          1000)).observe((now - t0_ns) / 1e6)
    _m.counter("serving_swap_ins_total",
               "preempted requests resumed by host-tier swap-in").inc()
    _m.counter("serving_swap_in_bytes_total",
               "KV bytes moved host→device by swap-ins").inc(nbytes)
    _m.counter("serving_swap_pages_total",
               "KV pages moved through the host tier",
               ("direction",)).labels("in").inc(pages)


def serving_swap_fallback():
    """A resume found no valid host payload (dropped by the capacity
    bound, stale or corrupt) and fell back to the replay prefill."""
    if not enabled:
        return
    _m.counter("serving_swap_replay_fallbacks_total",
               "swap-in resumes that fell back to replay prefill "
               "(payload dropped or stale)").inc()


def serving_host_pool(pages: int, nbytes: int, capacity):
    """Host-tier residency gauges after a store mutation: pages / bytes
    resident in host RAM, and occupancy against the configured page
    capacity (skipped when unbounded)."""
    if not enabled:
        return
    _m.gauge("serving_host_pool_pages",
             "KV pages resident in the host-RAM tier").set(pages)
    _m.gauge("serving_host_pool_bytes",
             "KV bytes resident in the host-RAM tier").set(nbytes)
    if capacity:
        _m.gauge("serving_host_pool_utilization",
                 "host-tier page residency over its configured "
                 "capacity").set(pages / capacity)


def serving_host_disk_pruned(files: int, bytes_total: int):
    """Standing-store files removed by the ``max_disk_bytes`` bound
    (oldest modification time first): pruned-file counter + lifetime
    pruned-bytes gauge, apart from the quarantine counter."""
    if not enabled:
        return
    _m.counter("serving_host_disk_pruned_total",
               "standing-store files pruned by the disk byte bound"
               ).inc(files)
    _m.gauge("serving_host_disk_pruned_bytes",
             "lifetime bytes pruned from the standing disk store"
             ).set(bytes_total)


def serving_prefix_demoted(pages: int):
    """Prefix-trie pages DEMOTED to the host tier under pool pressure
    instead of dying with their eviction."""
    if not enabled:
        return
    _m.counter("serving_prefix_demoted_pages_total",
               "prefix-trie pages demoted to the host tier on "
               "eviction").inc(pages)


def serving_prefix_promoted(t0_ns: int, pages: int):
    """Close one prefix PROMOTION opened at ``t0_ns``: demoted or
    standing-store chain pages scattered back into the pool and
    re-registered, so that the admission hits instead of prefilling."""
    if not t0_ns:
        return
    now = time.perf_counter_ns()
    _record("Serving.prefix_promote", t0_ns, now, "UserDefined")
    if not enabled:
        return
    _m.histogram("serving_prefix_promote_ms",
                 "wall milliseconds per host→pool prefix promotion",
                 buckets=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                          1000)).observe((now - t0_ns) / 1e6)
    _m.counter("serving_prefix_promoted_pages_total",
               "prefix pages promoted back from the host tier "
               "(demote/persist hits)").inc(pages)


def serving_handoff_export(t0_ns: int, nbytes: int, pages: int):
    """Close one prefill→decode KV export opened at ``t0_ns`` (a
    :func:`generate_begin` anchor): latency histogram + bytes / pages
    counters."""
    if not t0_ns:
        return
    now = time.perf_counter_ns()
    _record("Serving.handoff_export", t0_ns, now, "UserDefined")
    if not enabled:
        return
    _m.histogram("serving_handoff_export_ms",
                 "wall milliseconds per prefill-side KV export",
                 buckets=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                          1000)).observe((now - t0_ns) / 1e6)
    _m.counter("serving_handoff_exports_total",
               "prefill→decode KV handoffs exported").inc()
    _m.counter("serving_handoff_bytes_total",
               "KV bytes moved by prefill→decode handoffs").inc(nbytes)
    _m.counter("serving_handoff_pages_total",
               "KV pages moved by prefill→decode handoffs").inc(pages)


def serving_handoff_import(t0_ns: int):
    """Close one decode-side KV import (allocate + scatter or page
    move) opened at ``t0_ns``. Bytes and pages are counted once, at
    export."""
    if not t0_ns:
        return
    now = time.perf_counter_ns()
    _record("Serving.handoff_import", t0_ns, now, "UserDefined")
    if not enabled:
        return
    _m.histogram("serving_handoff_import_ms",
                 "wall milliseconds per decode-side KV import scatter",
                 buckets=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                          1000)).observe((now - t0_ns) / 1e6)
    _m.counter("serving_handoff_imports_total",
               "prefill→decode KV handoffs imported").inc()



# ---------------- the serving cluster's router ----------------

def serving_router_dispatch(replica: int, affinity_hit: bool):
    """One router dispatch decision: per-replica dispatch counter plus
    the affinity hit/miss split — the live prefix-affinity hit rate
    (hits mean the tenant's system prompt lands on a replica whose trie
    already holds it; misses fall back to least-loaded placement)."""
    if not enabled:
        return
    _m.counter("serving_router_dispatch_total",
               "requests dispatched to engine replicas by the cluster "
               "router", ("replica",)).labels(str(replica)).inc()
    _m.counter("serving_router_affinity_total",
               "prefix-affinity routing outcomes",
               ("outcome",)).labels(
        "hit" if affinity_hit else "miss").inc()


def serving_router_retry(n: int = 1):
    """A request a degraded replica shed (``rejected_overload``) was
    re-dispatched to the healthiest replica before surfacing the
    rejection to the caller — the router-level retry of shed work."""
    if not enabled:
        return
    _m.counter("serving_router_retries_total",
               "shed requests re-dispatched to a healthier replica"
               ).inc(n)


def serving_router_ratelimited(tenant: str):
    """A submission exceeded its tenant's token quota and finished
    ``rejected_ratelimit`` without touching any replica."""
    if not enabled:
        return
    _m.counter("serving_router_ratelimited_total",
               "submissions rejected by per-tenant rate limits",
               ("tenant",)).labels(tenant).inc()


def serving_router_failover(sessions: int):
    """A replica left service (circuit open, or a rolling-upgrade
    drain) and the router rehomed its live sessions onto surviving
    replicas — counted per event, with the rehomed-session total
    alongside (zero lost requests is the gate)."""
    if not enabled:
        return
    _m.counter("serving_router_failovers_total",
               "replica exits (death or retirement) the router "
               "rehomed sessions from").inc()
    _m.counter("serving_router_rehomed_sessions_total",
               "live sessions re-dispatched off dead or retiring "
               "replicas").inc(sessions)


def serving_router_replica(replica: int, queued: int, occupancy: float,
                           degraded_level: int):
    """One replica's published load signals, refreshed each cluster
    step: queue depth, paged-pool occupancy and the degraded-mode rung
    — the registry-side mirror of ``ServingScheduler.load_stats()``
    (the router reads the structured API; dashboards read these)."""
    if not enabled:
        return
    _m.gauge("serving_replica_queue_depth",
             "queued requests per engine replica",
             ("replica",)).labels(str(replica)).set(queued)
    _m.gauge("serving_replica_pool_occupancy",
             "paged-pool occupancy per engine replica",
             ("replica",)).labels(str(replica)).set(occupancy)
    _m.gauge("serving_replica_degraded_mode",
             "degraded-mode ladder rung per engine replica",
             ("replica",)).labels(str(replica)).set(degraded_level)


def serving_router_retry_exhausted():
    """A shed request exhausted its per-request retry budget (or its
    tenant's retry-rate cap) and the rejection surfaced to the caller —
    counted SEPARATELY from first-try rejection so overload dashboards
    can tell 'the cluster is full' from 'one replica is degraded and
    retries are amplifying'."""
    if not enabled:
        return
    _m.counter("serving_router_retry_exhausted_total",
               "shed requests whose retry budget or tenant retry-rate "
               "cap ran out before a replica accepted them").inc()


# ---------------- overload and SLO ----------------

def serving_slo_rejected(tenant: str):
    """The admission controller rejected a submission at the cluster
    door because its deadline was infeasible against current backlog
    (``rejected_infeasible``) — shed BEFORE any replica pays queueing
    or prefill for a request that could never meet its SLO."""
    if not enabled:
        return
    _m.counter("serving_slo_rejected_infeasible_total",
               "submissions rejected at admission as deadline-"
               "infeasible", ("tenant",)).labels(tenant).inc()


def serving_slo_ttft(ttft_s: float, met: bool, priority: int):
    """One request's time-to-first-token under the trace-driven
    harness (virtual-clock seconds from arrival to first committed
    token), with its deadline outcome — the p99 TTFT and
    deadline-met-fraction sources of the goodput-under-SLO tier."""
    if not enabled:
        return
    _m.histogram("serving_slo_ttft_ms",
                 "milliseconds from arrival to first token under the "
                 "traffic harness", ("priority",),
                 buckets=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500,
                          5000, 10000)).labels(
        str(int(priority))).observe(ttft_s * 1e3)
    _m.counter("serving_slo_deadline_total",
               "requests by deadline outcome under the traffic harness",
               ("outcome",)).labels("met" if met else "missed").inc()


def serving_slo_tokens(n: int, met: bool):
    """Tokens produced by a finished request, split by whether the
    request met its SLO: the ``met`` stream is GOODPUT, the rest is
    work the cluster did for requests that missed anyway — the split
    the admission controller exists to improve."""
    if not enabled:
        return
    _m.counter("serving_slo_tokens_total",
               "tokens produced under the traffic harness, by SLO "
               "outcome", ("outcome",)).labels(
        "goodput" if met else "badput").inc(n)


def serving_slo_report(goodput_tps: float, met_frac: float,
                       p99_ttft_ms):
    """End-of-trace summary gauges: goodput (tokens/s of SLO-met
    requests over the run's wall time), deadline-met fraction, and
    p99 TTFT — the three headline numbers of a traffic run."""
    if not enabled:
        return
    _m.gauge("serving_slo_goodput_tokens_per_sec",
             "goodput of the last traffic-harness run (tokens of "
             "deadline-met requests per wall second)").set(goodput_tps)
    _m.gauge("serving_slo_deadline_met_fraction",
             "deadline-met fraction of the last traffic-harness run"
             ).set(met_frac)
    if p99_ttft_ms is not None:
        _m.gauge("serving_slo_p99_ttft_ms",
                 "p99 time-to-first-token of the last traffic-harness "
                 "run").set(p99_ttft_ms)


def serving_autoscale(direction: str, replicas: int,
                      backlog_per_replica: float):
    """One autoscaler decision that actually scaled (``direction`` in
    ``up``/``down``): event counter + the serviceable-replica-count
    and backlog gauges — the closed loop's observable trajectory
    (the traffic soak asserts both directions fired)."""
    if not enabled:
        return
    _m.counter("serving_autoscale_events_total",
               "autoscaler scale events", ("direction",)).labels(
        direction).inc()
    _m.gauge("serving_autoscale_replicas",
             "serviceable replicas after the last autoscaler decision"
             ).set(replicas)
    _m.gauge("serving_autoscale_backlog_per_replica",
             "backlog per serviceable replica at the last autoscaler "
             "decision").set(backlog_per_replica)


# ---------------- payload integrity ----------------

def serving_integrity(site: str, action: str):
    """One payload-integrity event at a byte-moving site (``handoff``,
    ``swap_in``, ``prefix_promote``, ``disk_store``): ``detected`` — a
    checksum caught a corrupt or torn payload before install;
    ``quarantined`` — the entry was removed so it is never served again;
    ``replayed`` — the request recovered through the replay path."""
    if not enabled:
        return
    _m.counter("serving_integrity_events_total",
               "payload-integrity events at byte-moving sites",
               ("site", "action")).labels(site, action).inc()


def serving_integrity_retry(site: str):
    """One bounded-backoff retry of a byte-moving operation (``swap_in``,
    ``handoff_import``) after a transient fault; a failed attempt frees
    what it allocated before re-raising, so the retry is idempotent."""
    if not enabled:
        return
    _m.counter("serving_integrity_retries_total",
               "bounded retries of byte-moving operations after "
               "transient faults", ("site",)).labels(site).inc()


# ---------------- multi-tenant adapter pool ----------------

def serving_adapter_slots(used: int, capacity: int, pinned: int):
    """Adapter-pool residency gauges after a slot mutation: slots
    holding a loaded adapter, the configured slot capacity, and how
    many resident adapters running rows pin."""
    if not enabled:
        return
    _m.gauge("serving_adapter_slots_used",
             "adapter-pool slots holding a loaded adapter").set(used)
    _m.gauge("serving_adapter_slots_capacity",
             "configured adapter-pool slot capacity").set(capacity)
    _m.gauge("serving_adapter_slots_pinned",
             "resident adapters pinned by running requests").set(pinned)


def serving_adapter_load(t0_ns: int, nbytes: int, promoted: bool):
    """Close one adapter slot install opened at ``t0_ns``: packed
    factors written into a pool slot. ``promoted`` splits host-store
    promotions (the demoted or persisted copy came back) from fresh
    registry loads. Host wall time: the install's copies are queued on
    the card's stream, not waited for."""
    if not t0_ns:
        return
    now = time.perf_counter_ns()
    _record("Serving.adapter_load", t0_ns, now, "UserDefined")
    if not enabled:
        return
    _m.histogram("serving_adapter_load_ms",
                 "wall milliseconds per adapter slot install",
                 buckets=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                          1000)).observe((now - t0_ns) / 1e6)
    _m.counter("serving_adapter_loads_total",
               "adapter slot installs, by source",
               ("source",)).labels(
        "promote" if promoted else "load").inc()
    _m.counter("serving_adapter_load_bytes_total",
               "packed factor bytes installed into adapter slots"
               ).inc(nbytes)


def serving_adapter_demoted(nbytes: int):
    """One cold adapter DEMOTED to the host tier on LRU slot reclaim
    (CRC-stamped packed bytes; a later admission promotes it back
    instead of reading the registry again)."""
    if not enabled:
        return
    _m.counter("serving_adapter_demotions_total",
               "adapters demoted to the host tier on slot reclaim"
               ).inc()
    _m.counter("serving_adapter_demote_bytes_total",
               "packed factor bytes demoted to the host tier"
               ).inc(nbytes)


def serving_adapter_fallback(site: str):
    """A corrupt or torn demoted adapter payload failed its CRC before
    install: the entry was quarantined and the admission fell back to
    a fresh registry load, counted."""
    if not enabled:
        return
    _m.counter("serving_adapter_fallbacks_total",
               "adapter promotions that fell back to a fresh load "
               "(corrupt/torn payload quarantined)",
               ("site",)).labels(site).inc()


def serving_adapter_gather(nbytes: int):
    """One adapter-augmented serving program with ``nbytes`` of per-row
    factors gathered out of the pool a step. The JAX package calls it
    at TRACE time (once per compiled program); the port compiles no
    programs, so nothing in it calls this hook, as with
    :func:`serving_fused_dispatch`."""
    if not enabled:
        return
    _m.counter("serving_adapter_gather_calls_total",
               "adapter factor gathers traced into serving programs"
               ).inc()
    _m.counter("serving_adapter_gather_bytes_total",
               "per-step adapter factor bytes gathered by traced "
               "serving programs").inc(int(nbytes))


# ------- request tracing + flight recorder -------
#
# A THIRD switch, independent of metrics and the profiler collector:
# ``tracing.enabled`` (set via ``tracing.enable()``). Every hook below
# starts with that one module-attribute read — the zero-cost
# contract — and none of them touches device values: span timestamps
# come from the tracer's injectable host clock, and call sites close
# spans only at existing commit fences or on pure host paths
# (no fetch, no fence).

def serving_trace_now() -> int:
    """Span anchor from the tracer's (injectable) clock; 0 when
    tracing is off, so call sites skip the close entirely — the same
    skip-on-zero convention as :func:`generate_begin`."""
    if not _tr.enabled:
        return 0
    return _tr.TRACER.now()


def serving_trace_submit(req, replica: int = -1):
    """Mint a trace onto a freshly-submitted request handle
    (idempotent — a handle that already rides a trace keeps it, which
    is what stitches cross-replica handoff/rehome hops into ONE
    trace)."""
    if not _tr.enabled:
        return
    _tr.TRACER.attach(req, replica=replica)
    if enabled:
        _m.counter("serving_trace_requests_total",
                   "request traces minted at submission").inc()


def serving_trace_enqueued(req):
    """Re-stamp the queue-wait anchor: submission and every requeue
    (preemption, recovery resume, shed-retry re-dispatch) restart the
    queue_wait span the next admission closes."""
    if not _tr.enabled:
        return
    _tr.TRACER.enqueued(req)


def serving_trace_admitted(req, replica: int = -1, slot: int = -1,
                           meta=None, t_ns: int = 0):
    """Close the queue_wait span opened at the last enqueue and mark
    the admission edge (slot assignment). ``t_ns``: admission instant
    anchored earlier by the caller (keeps queue and swap disjoint on
    the swap-in admit path)."""
    if not _tr.enabled:
        return
    _tr.TRACER.admitted(req, replica=replica, slot=slot, meta=meta,
                        t_ns=t_ns)


def serving_trace_first_token(req):
    """Explicit TTFT stamp for the row whose first token just
    committed — called from the commit fence, never from dispatch."""
    if not _tr.enabled:
        return
    _tr.TRACER.first_token(req)


def serving_trace_span(req, name: str, t0_ns: int, t1_ns: int = 0,
                       replica: int = -1, slot: int = -1,
                       seq: int = -1, meta=None):
    """Close a lifecycle span opened at ``t0_ns`` (a
    :func:`serving_trace_now` anchor; 0 skips) onto the request's
    trace. ``seq`` is the per-request step sequence — committed-token
    count at close — so step participation is reconstructable."""
    if not _tr.enabled:
        return
    _tr.TRACER.record(req, name, t0_ns, t1_ns, replica=replica,
                      slot=slot, seq=seq, meta=meta)


def serving_trace_mark(req, name: str, replica: int = -1,
                       slot: int = -1, seq: int = -1, meta=None):
    """Zero-duration point event (preempt, dispatch, rehome, WAL
    replay, ...)."""
    if not _tr.enabled:
        return
    _tr.TRACER.mark(req, name, replica=replica, slot=slot, seq=seq,
                    meta=meta)


def serving_trace_finish(req, reason: str, replica: int = -1):
    """Terminal edge: stamp the finish reason and end timestamp."""
    if not _tr.enabled:
        return
    _tr.TRACER.finish(req, reason, replica=replica)


def serving_flight_tick():
    """One scheduler tick folded into a supervisor's flight-recorder
    ring (the ring itself lives on the supervisor; this is the
    metrics-side counter)."""
    if not enabled:
        return
    _m.counter("serving_flight_ticks_total",
               "scheduler ticks recorded into flight-recorder rings"
               ).inc()


def serving_flight_dump(reason: str, nbytes: int):
    """One flight-recorder black box written (EngineDead, an exception
    escaping step(), or on demand): per-reason counter + size gauge."""
    if not enabled:
        return
    _m.counter("serving_flight_dumps_total",
               "flight-recorder dumps written, by trigger",
               ("reason",)).labels(reason).inc()
    _m.gauge("serving_flight_dump_bytes",
             "size of the last flight-recorder dump").set(nbytes)


# ---------------- multi-process RPC + KV fabric ----------------

_RPC_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250,
                   1000)
_FABRIC_MS_BUCKETS = (0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250,
                      1000)


def serving_rpc_call(method: str, t0_ns: int, bytes_out: int,
                     bytes_in: int):
    """Close one client-side RPC exchange opened at ``t0_ns`` (a
    :func:`generate_begin` anchor): per-method call counter, frame
    bytes in both directions, latency histogram."""
    if not t0_ns:
        return
    now = time.perf_counter_ns()
    _record(f"Serving.rpc[{method}]", t0_ns, now, "UserDefined")
    if not enabled:
        return
    _m.counter("serving_rpc_calls_total",
               "RPC calls completed, by method",
               ("method",)).labels(method).inc()
    nbytes = _m.counter("serving_rpc_bytes_total",
                        "RPC frame bytes on the wire, by method and "
                        "direction", ("method", "direction"))
    nbytes.labels(method, "out").inc(bytes_out)
    nbytes.labels(method, "in").inc(bytes_in)
    _m.histogram("serving_rpc_latency_ms",
                 "wall milliseconds per RPC exchange", ("method",),
                 buckets=_RPC_MS_BUCKETS).labels(method).observe(
        (now - t0_ns) / 1e6)


def serving_rpc_served(method: str, t0_ns: int):
    """Close one server-side dispatch (handler execution + reply
    encode): the remote half of :func:`serving_rpc_call`."""
    if not t0_ns:
        return
    now = time.perf_counter_ns()
    _record(f"Serving.rpc_served[{method}]", t0_ns, now, "UserDefined")
    if not enabled:
        return
    _m.counter("serving_rpc_served_total",
               "RPC calls dispatched server-side, by method",
               ("method",)).labels(method).inc()
    _m.histogram("serving_rpc_served_ms",
                 "wall milliseconds per server-side RPC dispatch",
                 ("method",), buckets=_RPC_MS_BUCKETS).labels(
        method).observe((now - t0_ns) / 1e6)


def serving_rpc_retry(method: str):
    """One bounded-backoff retry of an RPC after a transport failure
    (torn or corrupt frame, reset, injected fault). A retried call
    replays from the server's dedupe cache, so this counts wire
    flakiness, not duplicated work."""
    if not enabled:
        return
    _m.counter("serving_rpc_retries_total",
               "RPC attempts retried after a transport failure",
               ("method",)).labels(method).inc()


def serving_rpc_timeout(method: str):
    """One RPC attempt abandoned at its deadline: counted apart from
    other transport failures because the server may still have executed
    the call (the dedupe cache makes the retry safe)."""
    if not enabled:
        return
    _m.counter("serving_rpc_timeouts_total",
               "RPC attempts that hit their per-call deadline",
               ("method",)).labels(method).inc()


def serving_rpc_corrupt(kind: str):
    """One inbound RPC frame rejected before decode: ``torn`` (EOF
    mid-frame) or ``crc`` (bit flip, bad magic, bad length). Nothing
    was installed; the connection drops and the peer retries."""
    if not enabled:
        return
    _m.counter("serving_rpc_corrupt_frames_total",
               "RPC frames rejected by framing/CRC validation",
               ("kind",)).labels(kind).inc()


def serving_fabric_demote(t0_ns: int, nbytes: int):
    """Close one demote to the shared KV fabric (a replica shipped a
    prefix, adapter or swap payload to the fabric server) opened at
    ``t0_ns``: count, payload bytes, latency."""
    if not t0_ns:
        return
    now = time.perf_counter_ns()
    _record("Serving.fabric_demote", t0_ns, now, "UserDefined")
    if not enabled:
        return
    _m.counter("serving_fabric_demotes_total",
               "payloads demoted to the shared KV fabric").inc()
    _m.counter("serving_fabric_demote_bytes_total",
               "payload bytes demoted to the shared KV fabric"
               ).inc(nbytes)
    _m.histogram("serving_fabric_demote_ms",
                 "wall milliseconds per fabric demote",
                 buckets=_FABRIC_MS_BUCKETS).observe((now - t0_ns) / 1e6)


def serving_fabric_promote(t0_ns: int, nbytes: int, hit: bool):
    """Close one promote lookup in the shared KV fabric opened at
    ``t0_ns``: hit / miss counters and, on a hit, the payload bytes
    that replaced a cold prefill."""
    if not t0_ns:
        return
    now = time.perf_counter_ns()
    _record("Serving.fabric_promote", t0_ns, now, "UserDefined")
    if not enabled:
        return
    _m.counter("serving_fabric_promotes_total",
               "fabric promote lookups, by outcome",
               ("outcome",)).labels("hit" if hit else "miss").inc()
    if hit:
        _m.counter("serving_fabric_promote_bytes_total",
                   "payload bytes promoted from the shared KV fabric"
                   ).inc(nbytes)
    _m.histogram("serving_fabric_promote_ms",
                 "wall milliseconds per fabric promote lookup",
                 buckets=_FABRIC_MS_BUCKETS).observe((now - t0_ns) / 1e6)


def serving_fabric_quarantine(site: str):
    """A fabric payload failed its CRC check before install and was
    quarantined server-side; the caller falls back to replay."""
    if not enabled:
        return
    _m.counter("serving_fabric_quarantined_total",
               "fabric payloads quarantined on checksum mismatch",
               ("site",)).labels(site).inc()
