"""Fault-tolerant serving: fault injection, supervised recovery, and
drain/restore over the continuous-batching engine.

The port's counterpart of the engine half of
``paddle_tpu/serving/resilience.py``, all HOST-side (no new kernels):

- :class:`FaultInjector` — a deterministic, seeded injector with NAMED
  sites threaded through the hot path (:data:`SITES`: allocator
  alloc/free, prefill-chunk / decode / verify / tree-verify / draft
  step execution, the dispatch and commit seams, the device-to-host
  transfer, the scheduler tick). Each firing can ``raise``, ``stall``
  past a watchdog deadline, or model a detected corruption
  (``corrupt``: the payload never commits — the checksum caught it).
  Hot paths call :func:`fault_point`; with no injector installed the
  cost is one module-attribute read.

- :class:`EngineSupervisor` — wraps a fresh
  :class:`~paddle_tpu_torch.inference.ContinuousBatchingEngine` (built
  by an ``engine_factory`` so it can be rebuilt from scratch) behind a
  :class:`~.scheduler.ServingScheduler`, keeping a host-side
  write-ahead :class:`RequestJournal`: admission params are journaled
  at submit time (before anything executes) and every committed token
  after each successful step. On a failed — or watchdog-stalled — step
  the supervisor tears the poisoned engine down, builds a fresh one
  (fresh pools) and restores every in-flight session through the
  ``resume_sequence`` replay path, so recovery is TOKEN-IDENTICAL to
  an uninterrupted run (greedy; held in tests/test_torch_resilience.py
  at f32 and int8 KV). Between "healthy" and "dead" sit bounded
  exponential-backoff retries, a circuit breaker on repeated failures,
  and a pressure-ordered DEGRADED-MODE ladder (:data:`DEGRADED_MODES`:
  speculation off → one-page prefill chunks → shed LOW-priority
  admissions with ``rejected_overload``), published as the
  ``serving_degraded_mode`` gauge.

- **drain/restore** — :meth:`EngineSupervisor.drain` stops admissions
  and checkpoints every in-flight session (journal records) plus the
  prefix-cache trie — structure AND page KV bytes
  (:meth:`~.paged_cache.PagedKVCache.checkpoint_prefix`) — to one
  ``.npz`` file; :meth:`EngineSupervisor.restore` builds a fresh
  engine, writes the trie pages back into its pool, and requeues the
  sessions, so shared system prompts survive restarts as prefix HITS
  and interrupted decodes finish token-identically.

Recovery cost: the journal replays ``prompt + tokens[:-1]`` through
the continuation prefill, so recovery time grows with RESIDENT tokens,
not with the wall time already served.

Determinism: greedy decode (``temperature == 0``) is identical across
recovery by construction (replay never re-samples). For sampled decode
the supervisor snapshots the engine generator's state
(``torch.Generator.get_state``) at each step commit and sets it into
the rebuilt engine's generator, so the stream survives recovery at
STEP granularity.

The card (one stream, an abandoned step thread): every launch of a
supervised step lands on the stream the caller was on when it called
:meth:`EngineSupervisor.step` — the watchdog's worker thread sets that
stream as its own before it runs the step (PyTorch's current stream is
per thread), so the kernels' launches, ``_up``'s non-blocking copies
and the commit's fetch all order on one stream. A step thread the
watchdog abandons keeps its engine: the supervisor holds a reference
to the poisoned engine until the thread has ended, so no tensor the
old engine owns (its pools, its outputs) returns to PyTorch's caching
allocator while that thread could still launch work that writes it,
and the fresh engine's pools are always different memory. Once the
thread has ended, every launch it made is already on the stream, and
whatever the allocator reuses after the release is ordered after it.
The old engine's host tables are cleared too (:meth:`_fence`), so a
thread that wakes up commits nothing. An injected ``stall`` raises
when it wakes and never launches at all.

- **the durable journal** — ``wal_dir`` attaches an on-disk
  :class:`~.wal.WriteAheadLog` under the journal: admissions, committed
  tokens and ownership transitions become crash-durable, periodic
  incremental checkpoints (``checkpoint_every``, with the trie's pages
  under ``checkpoint_prefix``) compact the log without stopping
  admissions, and :meth:`EngineSupervisor.recover_from_disk` rebuilds a
  cold-started process from the directory alone. Appends, fsyncs and
  checkpoints run on the host after a step's commit, never inside a
  dispatch; a ``steps`` delta holds only tokens the commit has fetched.

An adapter pool the factory shares across rebuilds (the usual shape: it
closes over one pool) rides through a recovery with its pins reset
(:meth:`~.adapters.AdapterPool.reset_pins`): every journaled session
re-admits through the pool's ``acquire``, which pins exactly the live
set, and a restored session keeps its ``adapter_id``.

Under the host tier (``host_tier=True``) a rebuilt engine adopts the
poisoned one's host store (:meth:`~.host_tier.TieredKVCache.
adopt_host_tier`): the journal marks sessions whose KV sits there
(``swapped``), and recovery swaps them in instead of replaying them.
"""
from __future__ import annotations

import base64
import contextlib
import json
import os
import tempfile
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..observability import hooks as _obs
from .policy import FinishReason, Priority

#: the named injection sites threaded through the serving hot path; the
#: site lint (tests/test_torch_resilience.py) holds every name here to
#: exactly one ``fault_point("<site>")`` call in the port (three for
#: the dispatch / commit / transfer seams). "wal_append" fires in the
#: write-ahead log before a frame is written, "wal_fsync" before an
#: fsync, "checkpoint_write" before a checkpoint file is produced.
#: "adapter_load" and "adapter_promote" fire in the
#: adapter pool before a load or a promotion installs anything.
#: "swap_out" fires in the host tier before a swap-out's gather,
#: "swap_in" before a swap-in's allocation (a bounded retry absorbs a
#: transient fault).
#: "dispatch" fires AFTER a decode / verify forward launches (the
#: in-flight handle is lost with the fault — nothing committed, the
#: journal replays); "commit" fires at the top of the
#: commit half, before the device-to-host fetch ("transfer"): the two
#: seams the overlapped runtime opens between launch and commit.
#: "draft_propose" fires before the draft model's catch-up and propose
#: forwards touch its pool, "tree_verify" before the tree verify
#: launches; the draft pool is disposable, so a fault at either
#: recovers by rebuilding it cold.
ENGINE_SITES = ("alloc", "free", "decode_step", "prefill_chunk",
                "verify_step", "transfer", "sched_tick", "swap_out",
                "swap_in", "dispatch", "commit",
                "adapter_load", "adapter_promote",
                "wal_append", "wal_fsync", "checkpoint_write",
                "draft_propose", "tree_verify")

#: cluster-plane sites. Live, one ``fault_point`` each in
#: ``serving/cluster.py``: "handoff_export" (before a prefill replica's
#: export, which commits nothing), "handoff_import" (before each
#: decode-side import attempt, under the bounded retry) and
#: "autoscale_tick" (a fault skips one scaling decision). The
#: multi-process RPC and KV-fabric sites ("rpc_send", "rpc_recv",
#: "fabric_put", "fabric_get") are named so that an injector accepts
#: the reference's site list; their modules are not ported yet
CLUSTER_SITES = ("handoff_export", "handoff_import", "autoscale_tick",
                 "rpc_send", "rpc_recv", "fabric_put", "fabric_get")

SITES = ENGINE_SITES + CLUSTER_SITES

#: engine sites whose modules are not ported yet (they have no
#: ``fault_point`` call in the port): none is left
WAITING_SITES = ()

#: the pressure-ordered degraded-mode ladder (index == level): each
#: recovery escalates one rung, sustained healthy steps climb back down
DEGRADED_MODES = ("healthy", "no_spec", "small_chunks", "shed_low")


def _draft_identity(engine):
    """The draft-model identity a drain checkpoint carries: draft-pool
    STATE is disposable (never checkpointed), so a restore only needs
    ``[draft_layers]`` (linear draft) or ``[draft_layers, width,
    depth]`` (tree speculation) to prove the replacement engine
    re-drafts token-identically. ``None`` without a draft model."""
    dl = getattr(engine, "draft_layers", None)
    if dl is None:
        return None
    tree = getattr(engine, "spec_tree", None)
    return [int(dl)] + ([int(tree[0]), int(tree[1])] if tree else [])


class InjectedFault(RuntimeError):
    """A fault fired by the :class:`FaultInjector` (``site`` / ``mode``
    carry the classification through to the supervisor's counters)."""

    def __init__(self, site: str, mode: str = "raise", detail: str = ""):
        self.site = site
        self.mode = mode
        super().__init__(
            f"injected {mode} fault at site {site!r}"
            + (f": {detail}" if detail else ""))


class CorruptionDetected(InjectedFault):
    """A byte payload failed its checksum verification BEFORE install
    (:func:`verify_checksums`). The corrupted bytes are never committed
    to host or device state. Also raised by the injector's ``corrupt``
    mode, which models the same detection without real bytes."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(site, "corrupt",
                         detail or "checksum mismatch on fetched "
                         "payload; data discarded before commit")


class StepStalled(RuntimeError):
    """The supervisor's watchdog gave up on a step that exceeded its
    deadline (a hung transfer or a wedged device program)."""

    def __init__(self, seconds: float):
        self.site = "watchdog"
        self.mode = "stall"
        super().__init__(f"engine step exceeded the {seconds:.3f}s "
                         f"watchdog deadline")


class EngineDead(RuntimeError):
    """The circuit breaker opened: repeated step failures exhausted the
    recovery budget and the supervisor will not retry further."""


#: the installed injector — hot paths read this ONE module attribute;
#: None (the default) costs nothing beyond the read
_ACTIVE: Optional["FaultInjector"] = None


def fault_point(site: str) -> None:
    """Hot-path injection site: no-op unless a :class:`FaultInjector`
    is installed (:func:`install` / ``with injector:``)."""
    inj = _ACTIVE
    if inj is not None:
        inj.fire(site)


def tamper_point(site: str) -> bool:
    """Payload-corruption injection site: True when the installed
    injector has an armed TAMPER shot due at ``site`` — the caller then
    flips real bytes in the payload it is about to verify, so the
    CHECKSUM path (not the injector) raises :class:`CorruptionDetected`.
    Never raises itself."""
    inj = _ACTIVE
    return inj is not None and inj.tamper(site)


def _stream_of_caller():
    """A context that makes the calling thread's current CUDA stream
    current in another thread (a null context without CUDA in use)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.stream(torch.cuda.current_stream())
    return contextlib.nullcontext()


def run_with_deadline(fn: Callable, seconds: Optional[float]):
    """Run ``fn()`` under a watchdog deadline: raises
    :class:`StepStalled` past ``seconds``; ``None`` runs inline. The
    worker thread runs on the caller's current CUDA stream; an abandoned
    worker is daemonic, with the supervisor's caveat (module
    docstring)."""
    if seconds is None:
        return fn()
    t, box = _start_guarded(fn, "deadline-guarded-call")
    t.join(seconds)
    if t.is_alive():
        raise StepStalled(seconds)
    if "e" in box:
        raise box["e"]
    return box.get("r")


def _start_guarded(fn: Callable, name: str):
    """Start ``fn`` on a daemon thread under the caller's stream;
    returns the thread and the box its result or exception lands in."""
    box: Dict = {}
    ctx = _stream_of_caller()

    def run():
        try:
            with ctx:
                box["r"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed by the caller
            box["e"] = e

    t = threading.Thread(target=run, daemon=True, name=name)
    t.start()
    return t, box


def install(injector: Optional["FaultInjector"]) -> None:
    """Install ``injector`` globally (``None`` uninstalls)."""
    global _ACTIVE
    _ACTIVE = injector


def uninstall() -> None:
    install(None)


class FaultInjector:
    """Deterministic, seeded fault source for the named serving sites.

    Two firing styles compose:

    - **armed** (on demand): :meth:`arm` schedules a fault on the n-th
      FUTURE call at a site — the way to kill the engine at an exact
      point (mid-decode, during a verify step).
    - **rate** (chaos): every :func:`fault_point` call at an enabled
      site draws from a seeded RNG; at most ``max_faults`` total fire.
      Same seed + same call sequence => same faults, every run.

    ``modes`` picks what a rate-fired fault does: ``"raise"`` (raise
    :class:`InjectedFault`), ``"stall"`` (sleep ``stall_s`` — past the
    supervisor's watchdog deadline — then raise, so a stalled site never
    commits), ``"corrupt"`` (raise :class:`CorruptionDetected`,
    modeling a checksum catching a corrupted transfer before commit).

    Every firing is counted per site (``fired``), logged
    (``log``: ``(site, mode, call_index)``) and emitted to the
    ``serving_fault_injected_total{site,kind}`` counter.
    """

    def __init__(self, seed: int = 0, rate: float = 0.0,
                 sites: Optional[List[str]] = None,
                 modes=("raise",), stall_s: float = 0.1,
                 max_faults: Optional[int] = None):
        bad = set(sites or ()) - set(SITES)
        if bad:
            raise ValueError(
                f"FaultInjector: unknown site(s) {sorted(bad)}; "
                f"valid sites: {SITES}")
        bad = set(modes) - {"raise", "stall", "corrupt"}
        if bad:
            raise ValueError(f"FaultInjector: unknown mode(s) "
                             f"{sorted(bad)}")
        self.rate = float(rate)
        self.sites = tuple(sites) if sites is not None else SITES
        self.modes = tuple(modes)
        self.stall_s = float(stall_s)
        self.max_faults = max_faults
        self._rng = np.random.RandomState(seed)
        self.calls: Dict[str, int] = {s: 0 for s in SITES}
        self.fired: Dict[str, int] = {s: 0 for s in SITES}
        self.fired_total = 0
        self.log: List[tuple] = []
        self._armed: Dict[str, List[tuple]] = {}
        # payload-corruption shots: consumed by tamper_point(), never by
        # fire() — a tamper must flow through the caller's checksum
        # verifier, not raise here
        self._tamper_armed: Dict[str, List[int]] = {}
        self.tamper_calls: Dict[str, int] = {s: 0 for s in SITES}
        # stalls in flight, not yet attributed by a supervisor: the
        # watchdog only ever sees a StepStalled, so the supervisor asks
        # the installed injector whether the stall was its own
        self.pending_stalls: List[str] = []

    def arm(self, site: str, mode: str = "raise", nth: int = 1) -> None:
        """Schedule one fault on the ``nth`` future call at ``site``
        (1 = the very next call). Armed faults fire regardless of
        ``rate`` / ``max_faults``."""
        if site not in SITES:
            raise ValueError(f"arm: unknown site {site!r}")
        self._armed.setdefault(site, []).append(
            (self.calls[site] + int(nth), mode))

    def arm_tamper(self, site: str, nth: int = 1) -> None:
        """Schedule one PAYLOAD CORRUPTION on the ``nth`` future
        :func:`tamper_point` visit at ``site``."""
        if site not in SITES:
            raise ValueError(f"arm_tamper: unknown site {site!r}")
        self._tamper_armed.setdefault(site, []).append(
            self.tamper_calls[site] + int(nth))

    def tamper(self, site: str) -> bool:
        """One :func:`tamper_point` visit: True when an armed tamper
        shot is due — counted, logged and metered like any firing
        (mode ``"tamper"``)."""
        self.tamper_calls[site] = n = self.tamper_calls[site] + 1
        armed = self._tamper_armed.get(site)
        if not armed:
            return False
        for i, target in enumerate(armed):
            if n >= target:
                del armed[i]
                self.fired[site] += 1
                self.fired_total += 1
                self.log.append((site, "tamper", n))
                _obs.serving_fault(site, "tamper", injected=True)
                return True
        return False

    def fire(self, site: str) -> None:
        """One hot-path visit to ``site``: decide (armed schedule, then
        seeded rate) and inject. Raises on injection; returns silently
        otherwise."""
        self.calls[site] = n = self.calls[site] + 1
        mode = None
        armed = self._armed.get(site)
        if armed:
            for i, (target, m) in enumerate(armed):
                if n >= target:
                    mode = m
                    del armed[i]
                    break
        if (mode is None and self.rate > 0.0 and site in self.sites
                and (self.max_faults is None
                     or self.fired_total < self.max_faults)
                and self._rng.random_sample() < self.rate):
            mode = self.modes[self._rng.randint(len(self.modes))]
        if mode is None:
            return
        self.fired[site] += 1
        self.fired_total += 1
        self.log.append((site, mode, n))
        _obs.serving_fault(site, mode, injected=True)
        if mode == "stall":
            # sleep past the supervisor's watchdog, then raise: the
            # stalled site never commits. Registered BEFORE the sleep:
            # the watchdog fires mid-sleep and the supervisor
            # attributes the StepStalled to this injection
            self.pending_stalls.append(site)
            time.sleep(self.stall_s)
            raise InjectedFault(site, "stall",
                                f"stalled {self.stall_s}s past deadline")
        if mode == "corrupt":
            raise CorruptionDetected(site)
        raise InjectedFault(site)

    def stats(self) -> Dict:
        return {"fired_total": self.fired_total,
                "fired": {s: n for s, n in self.fired.items() if n},
                "calls": {s: n for s, n in self.calls.items() if n}}

    # installable as a context manager: ``with injector: ...``
    def __enter__(self) -> "FaultInjector":
        install(self)
        return self

    def __exit__(self, *exc) -> None:
        uninstall()


class JournalEntry:
    """One request's journaled state (the supervisor's recovery unit).
    ``swapped``: the request's KV lives in the host tier (a swap-out
    payload exists for its rid), so it recovers by swap-in, not replay.
    ``adapter_id``: its LoRA variant, pinned again at re-admission.
    The ``wal_*`` cursors say what of the entry already reached the
    on-disk log: :meth:`RequestJournal.sync` appends only the deltas,
    and a failed append leaves a cursor behind for the next sync.
    """
    __slots__ = ("req", "rid", "prompt", "max_new_tokens",
                 "eos_token_id", "priority", "deadline_at",
                 "submitted_at", "tokens", "admitted", "preemptions",
                 "swapped", "adapter_id", "constrained",
                 "wal_submitted", "wal_tokens", "wal_prem",
                 "wal_swapped", "wal_admitted")

    def __init__(self, req):
        self.req = req
        self.rid = req.rid
        self.prompt = req.prompt[0].copy()
        self.max_new_tokens = req.max_new_tokens
        self.eos_token_id = req.eos_token_id
        self.priority = int(req.priority)
        self.deadline_at = req.deadline_at
        self.submitted_at = req.submitted_at
        self.tokens: List[int] = list(req.tokens)
        self.admitted = False
        self.preemptions = int(req.preemptions)
        self.swapped = False
        self.adapter_id = int(getattr(req, "adapter_id", 0))
        self.constrained = getattr(req, "constraint", None) is not None
        self.wal_submitted = False
        self.wal_tokens = 0
        self.wal_prem = self.preemptions
        self.wal_swapped = False
        self.wal_admitted = False

    def as_record(self, now: Optional[float] = None,
                  grammars: Optional[Dict] = None) -> Dict:
        """JSON-able checkpoint record (drain/restore). Deadlines are
        serialized as REMAINING seconds against ``now`` (the draining
        supervisor's clock), never as absolute monotonic stamps, which
        mean nothing in another process; restore re-anchors against its
        own clock. A grammar-constrained session carries its DFA table
        (deduplicated into ``grammars`` by content hash), state and
        counters."""
        remaining = None
        if self.deadline_at is not None and now is not None:
            remaining = self.deadline_at - now
        constraint = None
        cs = getattr(self.req, "constraint", None) \
            if self.req is not None else None
        if cs is not None:
            constraint = cs.to_record(grammars)
        return {"rid": self.rid, "prompt": self.prompt.tolist(),
                "max_new_tokens": self.max_new_tokens,
                "eos_token_id": self.eos_token_id,
                "priority": self.priority,
                "deadline_remaining_s": remaining,
                "tokens": list(self.tokens),
                "admitted": self.admitted,
                "preemptions": self.preemptions,
                "swapped": self.swapped,
                "adapter_id": self.adapter_id,
                "constraint": constraint}


class RequestJournal:
    """Host-side write-ahead journal of every live request.

    Admission params are recorded at SUBMIT time — before any device
    work — and committed tokens are copied in at each successful step
    (:meth:`sync`). The journal, not the engine, is the source of truth
    at recovery: a poisoned engine is discarded wholesale and every
    live request is reset to its journaled state, which is exactly the
    host state as of the last committed step (a failed step committed
    nothing — device results only reach ``req.tokens`` after the
    transfer that would have raised).

    ``wal`` attaches a :class:`~.wal.WriteAheadLog`: admission params
    append at submit time (on disk before anything can execute),
    committed-token deltas, preempt / swap transitions and constraint
    state at each :meth:`sync`, and finish / handoff-forget tombstones
    retire sessions from the log. The in-memory journal stays the
    in-process recovery source; the log is what a cold restart replays
    (:meth:`EngineSupervisor.recover_from_disk`)."""

    def __init__(self, wal=None):
        self._entries: Dict[int, JournalEntry] = {}
        self.finished_total = 0
        self.wal = wal
        # finish tombstones waiting for the next due delta pass
        self._pending_fin: List[tuple] = []
        # grammar tables already appended (by hash): the dense table
        # goes to disk once and session records carry the hash. Cleared
        # at every checkpoint, which carries its own grammar dict and
        # may prune the earlier records
        self._wal_grammars: set = set()

    def _wal_submit(self, e: JournalEntry,
                    now: Optional[float] = None) -> None:
        grammars: Dict[str, Dict] = {}
        rec = e.as_record(now, grammars=grammars)
        rec["admitted"] = e.admitted
        for h, dfa_rec in grammars.items():
            if h not in self._wal_grammars:
                self.wal.append("grammar", {"hash": h, "dfa": dfa_rec})
        # flush=True: the write-ahead ACK, OS-durable before the caller
        # gets its handle back
        self.wal.append("submit", rec, flush=True)
        # marked only after both appends landed (a retry re-appends a
        # grammar harmlessly: last wins at replay)
        self._wal_grammars.update(grammars)
        e.wal_submitted = True
        e.wal_tokens = len(e.tokens)
        e.wal_prem = e.preemptions
        e.wal_swapped = e.swapped
        e.wal_admitted = e.admitted

    def record_submit(self, req, now: Optional[float] = None
                      ) -> JournalEntry:
        e = JournalEntry(req)
        if self.wal is not None:
            # write-ahead: a failed append leaves no half-accepted
            # request (the caller sees the error before any execution)
            self._wal_submit(e, now)
        self._entries[req.rid] = e
        return e

    def adopt(self, req, rec: Dict, durable: bool = False,
              now: Optional[float] = None) -> JournalEntry:
        """Re-journal a request rebuilt from a drain checkpoint or a
        cold-restart recovery. ``durable=True`` (recovery) marks the
        entry as already on THIS journal's disk, so only future deltas
        append; otherwise a log appends a fresh submit record, whose
        deadline ``now`` (the adopting supervisor's clock) keeps."""
        e = JournalEntry(req)
        e.admitted = bool(rec.get("admitted"))
        if self.wal is not None:
            if durable:
                e.wal_submitted = True
                e.wal_tokens = len(e.tokens)
                e.wal_prem = e.preemptions
                e.wal_swapped = e.swapped
                e.wal_admitted = e.admitted
            else:
                self._wal_submit(e, now)
        self._entries[req.rid] = e
        return e

    def forget(self, rid: int) -> None:
        """Drop a live entry WITHOUT counting it finished (a request
        handed to another owner). With a log the tombstone is durable
        too, so a cold restart of this directory never brings the
        handed-off session back."""
        e = self._entries.pop(rid, None)
        if e is not None and self.wal is not None and e.wal_submitted:
            try:
                self.wal.append("forget", {"rid": rid})
            except Exception:
                pass    # ownership moved in memory; best-effort stone

    def sync(self, swapped_check=None, wal: bool = True,
             force: bool = False) -> None:
        """Copy committed host state from the live request handles;
        finished requests leave the journal (their results live on the
        caller's handle — nothing to recover). ``swapped_check(rid) ->
        bool`` marks entries whose KV is host-resident. The in-memory
        pass always completes FIRST; the log's delta pass (``wal``)
        runs after it when the log says a delta is due (``force``: the
        drain / idle path), as one batched frame, so an append fault
        never leaves the in-process recovery source stale."""
        finished: List[tuple] = []
        for rid in list(self._entries):
            e = self._entries[rid]
            req = e.req
            if len(e.tokens) != len(req.tokens):
                e.tokens = list(req.tokens)
            e.preemptions = int(req.preemptions)
            if (req.slot is not None or req.tokens
                    or req.preemptions > 0):
                e.admitted = True
            if swapped_check is not None:
                e.swapped = bool(swapped_check(rid))
            if req.done:
                self.finished_total += 1
                finished.append((e, req.finish_reason))
                del self._entries[rid]
        if self.wal is None:
            return
        # a finished entry's tombstone queues unconditionally (the
        # recovery path's wal=False sync too), or its submit record
        # would stand without one and a cold restart would revive it
        for e, reason in finished:
            if e.wal_submitted:
                self._pending_fin.append((e.rid, reason))
        if not wal or not (force or self.wal.delta_due()):
            return
        self.wal.mark_delta()
        deltas: List[Dict] = []
        synced: List[JournalEntry] = []
        for e in list(self._entries.values()) \
                + [f[0] for f in finished]:
            if not e.wal_submitted:
                # a submit-time append failed earlier: heal with the
                # full record
                self._wal_submit(e)
                continue
            delta = {}
            if len(e.tokens) > e.wal_tokens:
                delta["toks"] = [int(t) for t in
                                 e.tokens[e.wal_tokens:]]
            if e.preemptions != e.wal_prem:
                delta["preemptions"] = e.preemptions
            if e.swapped != e.wal_swapped:
                delta["swapped"] = e.swapped
            if e.admitted != e.wal_admitted:
                delta["admitted"] = e.admitted
            if not delta:
                continue
            cs = getattr(e.req, "constraint", None)
            if cs is not None:
                delta["cstate"] = cs.state_record()
            delta["rid"] = e.rid
            deltas.append(delta)
            synced.append(e)
        fins, self._pending_fin = self._pending_fin, []
        deltas += [{"rid": rid, "fin": reason} for rid, reason in fins]
        if deltas:
            try:
                if len(deltas) == 1 and "fin" not in deltas[0]:
                    self.wal.append("step", deltas[0])
                else:
                    self.wal.append("steps", {"entries": deltas})
            except BaseException:
                # nothing committed (frame-boundary rollback): the live
                # deltas re-derive from the cursors, the tombstones
                # queue again
                self._pending_fin = fins + self._pending_fin
                raise
            for e in synced:
                e.wal_tokens = len(e.tokens)
                e.wal_prem = e.preemptions
                e.wal_swapped = e.swapped
                e.wal_admitted = e.admitted

    def live_entries(self) -> List[JournalEntry]:
        return [self._entries[r] for r in sorted(self._entries)]

    @property
    def size(self) -> int:
        return len(self._entries)

    @property
    def token_count(self) -> int:
        return sum(e.prompt.size + len(e.tokens)
                   for e in self._entries.values())


_CRC_POLY = 0xEDB88320
_CRC_CHUNK = 16 << 20           # bytes a worker checksums at a time
_crc_workers = None
_crc_ops: Dict[int, int] = {}


def _multmodp(a: int, b: int) -> int:
    """``a * b`` modulo the CRC-32 polynomial, bit-reflected (zlib's
    ``multmodp``)."""
    m, p = 1 << 31, 0
    while True:
        if a & m:
            p ^= b
            if not a & (m - 1):
                return p
        m >>= 1
        b = (b >> 1) ^ _CRC_POLY if b & 1 else b >> 1


def _x8nmodp(n: int) -> int:
    """``x ** (8 n)`` modulo the polynomial: the operator that shifts a
    CRC past ``n`` zero bytes (zlib's ``x2nmodp(n, 3)``)."""
    p, sq, k = 1 << 31, 1 << 30, 0
    while n or k < 3:
        if k >= 3:
            if n & 1:
                p = _multmodp(sq, p)
            n >>= 1
        sq = _multmodp(sq, sq)
        k += 1
    return p


def _crc32(a) -> int:
    """``zlib.crc32`` of an array's bytes, without copying them. A large
    buffer is checksummed in 16 MiB pieces on worker threads
    (``zlib.crc32`` releases the GIL) and the pieces' CRCs are combined
    as zlib's ``crc32_combine`` does, so the value is the one-pass
    CRC: a swapped-out request's hundreds of MB cost milliseconds, not
    the ~0.1 s a second of one core's CRC rate takes."""
    buf = memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
    n = len(buf)
    if n <= 2 * _CRC_CHUNK:
        return zlib.crc32(buf) & 0xFFFFFFFF
    global _crc_workers
    if _crc_workers is None:
        from concurrent.futures import ThreadPoolExecutor
        _crc_workers = ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            thread_name_prefix="crc32")
    head = n % _CRC_CHUNK or _CRC_CHUNK
    spans = [(0, head)] + [(s, s + _CRC_CHUNK)
                           for s in range(head, n, _CRC_CHUNK)]
    crcs = list(_crc_workers.map(lambda se: zlib.crc32(buf[se[0]:se[1]]),
                                 spans))
    op = _crc_ops.get(_CRC_CHUNK)
    if op is None:
        op = _crc_ops[_CRC_CHUNK] = _x8nmodp(_CRC_CHUNK)
    crc = crcs[0]
    for c in crcs[1:]:
        crc = _multmodp(op, crc) ^ c
    return crc & 0xFFFFFFFF


def payload_checksums(arrays: Dict[str, np.ndarray]) -> Dict[str, int]:
    """Per-array CRC32s of a byte payload, computed where KV bytes are
    materialized and verified by :func:`verify_checksums` before any
    install, so a corrupt or torn payload becomes a
    :class:`CorruptionDetected` at the door, never a wrong KV page. The
    values are ``zlib.crc32`` of each array's bytes, as the JAX
    package's are, so either package verifies the other's payloads."""
    return {n: _crc32(a) for n, a in arrays.items()}


def verify_checksums(arrays: Dict[str, np.ndarray],
                     checksums: Optional[Dict[str, int]],
                     site: str) -> None:
    """Verify ``arrays`` against :func:`payload_checksums` output;
    raises :class:`CorruptionDetected` (tagged ``site``) on any
    mismatch or missing array entry. A payload with no checksum dict
    passes — verification is the consumer's defense, not a format
    break."""
    if not checksums:
        return
    lost = set(checksums) - set(arrays)
    if lost:
        # a checksummed array vanished from the payload: truncation
        raise CorruptionDetected(
            site, f"payload lost checksummed array(s) {sorted(lost)} "
            f"— truncated payload")
    for name, a in arrays.items():
        want = checksums.get(name)
        if want is None:
            raise CorruptionDetected(
                site, f"payload array {name!r} has no checksum — "
                f"truncated or foreign payload")
        got = _crc32(a)
        if got != int(want):
            raise CorruptionDetected(
                site, f"payload array {name!r} checksum mismatch "
                f"(expected {int(want)}, got {got})")


def _np_dtype(name: str) -> np.dtype:
    """Resolve a checkpointed dtype name, including the ml_dtypes
    extension types numpy can't look up by string. The port's own
    checkpoints carry bf16 pages as their uint16 bit patterns
    (:meth:`~.paged_cache.PagedKVCache.checkpoint_prefix`), so they
    never need the extension."""
    try:
        return np.dtype(name)
    except TypeError:
        import ml_dtypes
        return np.dtype(getattr(ml_dtypes, name))


def load_drain_checkpoint(path: str) -> Dict:
    """Decode a :meth:`EngineSupervisor.drain` ``.npz`` back into host
    data: ``meta`` (sessions, geometry, next_rid), ``key_data`` (the
    generator-state snapshot, empty when none) and — when a prefix trie
    was checkpointed — ``prefix`` in the exact dict shape
    :meth:`~.paged_cache.PagedKVCache.restore_prefix` consumes."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        key_data = np.asarray(data["key_data"])
        prefix = None
        if meta["prefix"] is not None:
            pf = meta["prefix"]
            arrays = {
                n: np.frombuffer(
                    bytes(data[f"prefix_{n}"]),
                    _np_dtype(pf["dtypes"][n])).reshape(pf["shapes"][n])
                for n in pf["shapes"]}
            prefix = {"page_ids": pf["page_ids"],
                      "records": pf["records"], "arrays": arrays}
    return {"meta": meta, "key_data": key_data, "prefix": prefix}


def _session_from_record(sup: "EngineSupervisor", rec: Dict,
                         grammars: Optional[Dict] = None):
    """Rebuild one live request handle from a checkpoint session record:
    admission params, committed tokens, re-anchored deadline, adapter id
    (pinned again at admission) and — when the session was
    grammar-constrained — an equivalent
    :class:`~.constraints.ConstraintState` attached through the
    engine's validated surface."""
    from ..inference.predictor import GenerationRequest
    req = GenerationRequest(
        rec["rid"], np.asarray(rec["prompt"], np.int32),
        rec["max_new_tokens"], rec.get("eos_token_id"))
    req.priority = rec.get("priority", 1)
    req.adapter_id = int(rec.get("adapter_id", 0))
    if rec.get("deadline_remaining_s") is not None:
        # re-anchor the SLO on THIS process's clock
        req.deadline_at = sup.clock() + rec["deadline_remaining_s"]
    req.tokens = list(rec.get("tokens") or ())
    # a swapped-out session's payload may have died with its process or
    # survived in a shared store: the swap-in at admission falls back to
    # the replay either way, so the flag carries verbatim
    req.swapped = bool(rec.get("swapped"))
    if rec.get("admitted"):
        req.preemptions = int(rec.get("preemptions", 0)) + 1
        req.finish_reason = FinishReason.PREEMPTED.value
    if rec.get("constraint") is not None:
        from .constraints import ConstraintState
        sup.engine.attach_constraint(
            req, ConstraintState.from_record(rec["constraint"],
                                             grammars=grammars))
    return req


def _prefix_payload(ckpt: Optional[Dict], arrays: Dict) -> Optional[Dict]:
    """The ``prefix`` entry of a drain or WAL checkpoint's meta for a
    :meth:`~.paged_cache.PagedKVCache.checkpoint_prefix` result (None
    for none), its pages' bytes added to ``arrays`` as raw uint8 (the
    JAX package's layout: ``prefix_<pool array>``)."""
    if ckpt is None:
        return None
    for n, a in ckpt["arrays"].items():
        arrays[f"prefix_{n}"] = np.frombuffer(
            np.ascontiguousarray(a).tobytes(), np.uint8)
    return {"page_ids": ckpt["page_ids"], "records": ckpt["records"],
            "shapes": {n: list(a.shape) for n, a in ckpt["arrays"].items()},
            "dtypes": {n: str(a.dtype) for n, a in ckpt["arrays"].items()}}


class EngineSupervisor:
    """Crash-recovering wrapper around engine + scheduler.

    ``engine_factory() -> ContinuousBatchingEngine`` must build a FRESH
    engine with an identical configuration each call — the supervisor
    invokes it at construction and after every teardown (fresh pools).
    ``reuse_compiled`` is accepted for the reference's callers: the JAX
    package carries its compiled step programs across a rebuild, and
    the port has none to carry (its kernels are built once per process
    and shared by every engine), so it changes nothing here.

    Lifecycle knobs:

    - ``watchdog_s``: run each step on a watchdog thread (under the
      caller's CUDA stream) and declare :class:`StepStalled` past the
      deadline (None = no watchdog).
    - ``backoff_s`` / ``backoff_max_s``: exponential backoff slept
      between consecutive failures (injectable ``sleep`` for tests).
    - ``circuit_threshold``: consecutive failed step attempts (no
      successful step in between) before the breaker opens — the
      supervisor marks every live request ``engine_dead``, reports
      ``health == "dead"`` and raises :class:`EngineDead`.
    - ``recover_after``: consecutive successful steps per rung of
      degraded-ladder descent.
    - ``flight_ticks``: size of the flight recorder's tick ring (0
      disables it).

    Degraded ladder (:data:`DEGRADED_MODES`): every recovery escalates
    one rung — 1: speculative decoding off; 2: prefill chunk shrunk to
    one page; 3: LOW-priority admissions shed at submit with the
    ``rejected_overload`` finish reason. The rung is published as the
    ``serving_degraded_mode`` gauge and in :meth:`load_stats`.

    Durable journal: ``wal_dir`` attaches a :class:`~.wal.WriteAheadLog`
    (``wal_fsync``: ``"group"``, ``"commit"`` or ``"off"``; ``wal_kw``:
    its other knobs) and journals the engine's geometry in a ``meta``
    record; ``checkpoint_every`` writes an incremental checkpoint every
    that many successful steps, with the prefix trie's pages when
    ``checkpoint_prefix``. :meth:`recover_from_disk` rebuilds a
    supervisor from the directory after the process died.
    """

    def __init__(self, engine_factory: Callable, *,
                 token_budget: Optional[int] = None,
                 watchdog_s: Optional[float] = None,
                 backoff_s: float = 0.05, backoff_max_s: float = 2.0,
                 circuit_threshold: int = 5, recover_after: int = 32,
                 reuse_compiled: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 scheduler_kw: Optional[Dict] = None,
                 wal_dir: Optional[str] = None,
                 wal_fsync: str = "group",
                 wal_kw: Optional[Dict] = None,
                 checkpoint_every: Optional[int] = None,
                 checkpoint_prefix: bool = False,
                 flight_ticks: int = 256):
        self._factory = engine_factory
        self.token_budget = token_budget
        self.watchdog_s = watchdog_s
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.circuit_threshold = int(circuit_threshold)
        self.recover_after = int(recover_after)
        self.reuse_compiled = reuse_compiled
        self.clock = clock
        self._sleep = sleep
        self._sched_kw = dict(scheduler_kw or {})
        self.wal = None
        self.checkpoint_every = checkpoint_every
        self.checkpoint_prefix = bool(checkpoint_prefix)
        if wal_dir is not None:
            from .wal import WriteAheadLog
            self.wal = WriteAheadLog(wal_dir, fsync=wal_fsync,
                                     **(wal_kw or {}))
        self.journal = RequestJournal(wal=self.wal)
        self.degraded_level = 0
        self.recoveries = 0
        self.injected_faults = 0
        self.real_faults = 0
        self.shed_total = 0
        self.steps_total = 0
        self._consec_failures = 0
        self._successes_since_change = 0
        self._next_rid = 0
        self._key_data: Optional[np.ndarray] = None
        self._spec_shelf = None
        self._chunk_shelf = None
        self._chunk_shrunk = False
        self._dead = False
        self._draining = False
        self.engine = None
        self.scheduler = None
        self.restored: Dict[int, object] = {}
        # the step thread of the last watchdog run, and the poisoned
        # engines whose abandoned step threads may still run (module
        # docstring: their memory stays theirs until the thread ends)
        self._step_thread: Optional[threading.Thread] = None
        self._abandoned: List[tuple] = []
        self._replica_id = -1
        self.flight = None
        if flight_ticks:
            from ..observability.flight import FlightRecorder
            self.flight = FlightRecorder(max_ticks=flight_ticks,
                                         meta={"replica": -1})
        self.last_flight_dump: Optional[str] = None
        self._build()
        self._snapshot_key()
        if self.wal is not None:
            # the geometry record: cold recovery validates the
            # replacement engine against it
            self.wal.append("meta", dict(self._geometry(),
                                         next_rid=self._next_rid))
            self.wal.commit(force=True)

    # ---- health ----
    @property
    def health(self) -> str:
        if self._dead:
            return "dead"
        return "healthy" if self.degraded_level == 0 else "degraded"

    @property
    def degraded_mode(self) -> str:
        return DEGRADED_MODES[self.degraded_level]

    @property
    def replica_id(self) -> int:
        """Replica index carried by trace spans and flight dumps; -1 for
        a standalone supervisor. The setter propagates to the engine
        (and :meth:`_build` re-stamps it across rebuilds)."""
        return self._replica_id

    @replica_id.setter
    def replica_id(self, value: int) -> None:
        self._replica_id = int(value)
        if self.engine is not None:
            self.engine.replica_id = self._replica_id
        if self.flight is not None:
            self.flight.meta["replica"] = self._replica_id

    def _check_alive(self):
        if self._dead:
            raise EngineDead(
                "circuit breaker open after "
                f"{self.circuit_threshold} consecutive step failures")
        if self._draining:
            raise RuntimeError(
                "EngineSupervisor was drained; restore the checkpoint "
                "into a fresh supervisor (EngineSupervisor.restore)")

    # ---- build / teardown ----
    def _build(self):
        """(Re)build the engine + scheduler pair from scratch: pools,
        allocator, trie and slots all start empty; the generator takes
        the last committed step's state, and a host tier carries over
        from the old engine (its store is host state, committed only
        after gathers that completed), as does an adapter pool the
        factory shares, with its pins reset."""
        from .scheduler import ServingScheduler
        old = self.engine
        eng = self._factory()
        if not eng.idle:
            raise ValueError(
                "engine_factory must return a FRESH engine (no queued "
                "or running requests)")
        eng._next_rid = max(eng._next_rid, self._next_rid)
        if (old is not None
                and hasattr(eng.cache, "adopt_host_tier")
                and hasattr(old.cache, "adopt_host_tier")):
            eng.cache.adopt_host_tier(old.cache)
        pool = eng.adapters
        if (pool is not None and old is not None
                and old.adapters is pool):
            # stale pins of the poisoned engine's rows must not leak
            # slots: recovery re-admits every journaled session through
            # acquire(), which pins exactly the live set
            pool.reset_pins()
        if self._key_data is not None:
            eng.generator.set_state(torch.from_numpy(self._key_data))
        self.engine = eng
        eng.replica_id = getattr(self, "_replica_id", -1)
        self.scheduler = ServingScheduler(
            eng, token_budget=self.token_budget, clock=self.clock,
            **self._sched_kw)
        self._apply_degraded()

    def _fence(self, old):
        """Best-effort fence on the poisoned engine: an abandoned
        (stalled) step thread that wakes later finds empty slot and
        pending tables and commits nothing; dispatched but uncommitted
        work is dropped with it (the journal holds the last COMMITTED
        state, so the replay recomputes it token-identically)."""
        if old is None:
            return
        old._slots = [None] * old.max_batch
        old._rids[:] = -1
        old._pending = {}
        old._queue = []
        old._inflight = None
        old._inflight_chunks = []

    def _snapshot_key(self):
        self._key_data = self.engine.generator.get_state().numpy().copy()

    def _geometry(self) -> Dict:
        """The engine identity a WAL ``meta`` record and checkpoint
        carry, in the JAX package's keys and values."""
        cache = self.engine.cache
        return {"page_size": cache.page_size, "max_len": cache.max_len,
                "max_batch": cache.max_batch,
                "kv_dtype": cache.kv_dtype_name,
                "constraints": bool(self.engine.constraints),
                "draft": _draft_identity(self.engine)}

    # ---- degraded ladder ----
    def _apply_degraded(self):
        """Impose the current rung on the live engine (called on every
        rebuild and escalation; shelves keep what descent restores)."""
        eng = self.engine
        if self.degraded_level >= 1:
            if eng.spec is not None:
                self._spec_shelf = eng.spec
                eng.spec = None
        elif eng.spec is None and self._spec_shelf is not None:
            eng.spec = self._spec_shelf
            self._spec_shelf = None
        if self.degraded_level >= 2:
            if not self._chunk_shrunk:
                self._chunk_shelf = eng.prefill_chunk
                self._chunk_shrunk = True
            eng.prefill_chunk = eng.cache.page_size
        elif self._chunk_shrunk:
            eng.prefill_chunk = self._chunk_shelf
            self._chunk_shrunk = False
        if self.scheduler is not None:
            # mirror the rung onto the scheduler so load_stats() is a
            # complete health snapshot even with metrics disabled
            self.scheduler.degraded_level = self.degraded_level
        _obs.serving_degraded(self.degraded_level)

    def _escalate(self):
        if self.degraded_level < len(DEGRADED_MODES) - 1:
            self.degraded_level += 1
        self._successes_since_change = 0
        self._apply_degraded()

    def _deescalate_maybe(self):
        if self.degraded_level == 0:
            return
        self._successes_since_change += 1
        if self._successes_since_change >= self.recover_after:
            self.degraded_level -= 1
            self._successes_since_change = 0
            self._apply_degraded()

    # ---- intake ----
    def submit(self, prompt, max_new_tokens: int = 16, *,
               priority=Priority.NORMAL,
               deadline_s: Optional[float] = None, eos_token_id=None,
               adapter_id: int = 0, constraint=None):
        """Journaled submit (write-ahead: the admission params are on
        the journal before anything can execute). At degraded level 3
        (``shed_low``) LOW-priority requests are rejected at once with
        the ``rejected_overload`` finish reason instead of queueing
        into an engine that keeps failing. ``adapter_id`` as the
        engine's ``create_request`` takes it."""
        self._check_alive()
        req = self.engine.create_request(
            prompt, max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id, adapter_id=adapter_id,
            constraint=constraint)
        req.priority = int(priority)
        self._next_rid = self.engine._next_rid
        return self.submit_request(req, deadline_s=deadline_s)

    def submit_request(self, req, *, deadline_s: Optional[float] = None):
        """Journaled intake of an EXISTING request handle. The shed-LOW
        rung applies only to FRESH requests: a handle that already
        committed tokens (or was preempted) is in-flight work, and
        shedding it would lose it."""
        self._check_alive()
        fresh = not req.tokens and req.preemptions == 0
        if (fresh and self.degraded_level >= 3
                and int(req.priority) >= int(Priority.LOW)):
            req.done = True
            req.finish_reason = FinishReason.REJECTED_OVERLOAD.value
            self.shed_total += 1
            _obs.serving_cancelled(1, req.finish_reason)
            return req
        self.engine._next_rid = max(self.engine._next_rid, req.rid + 1)
        self._next_rid = max(self._next_rid, self.engine._next_rid)
        if deadline_s is not None:
            req.deadline_at = self.clock() + float(deadline_s)
        # write-ahead BEFORE the queue: a failed durable append rejects
        # the submission here, with the caller watching
        try:
            self.journal.record_submit(req, now=self.clock())
        except BaseException as exc:
            # a submit-path death never reaches step()'s dump
            self._flight_dump_safe(type(exc).__name__, err=str(exc))
            raise
        self.scheduler.requeue(req)
        return req

    def adopt_running(self, req):
        """Journal a request installed DIRECTLY into a running slot
        (bypassing the admission queue): from here this supervisor owns
        its recovery (a crash replays ``prompt + tokens[:-1]``)."""
        self._check_alive()
        self.engine._next_rid = max(self.engine._next_rid, req.rid + 1)
        self._next_rid = max(self._next_rid, self.engine._next_rid)
        e = self.journal.record_submit(req, now=self.clock())
        e.admitted = True
        if self.wal is not None and e.wal_submitted \
                and not e.wal_admitted:
            # this supervisor owns the recovery from here: the admitted
            # flag is durable beside the submit record
            self.wal.append("step", {"rid": e.rid, "admitted": True})
            e.wal_admitted = True
        return req

    # ---- stepping ----
    def _guarded(self, fn):
        if self.watchdog_s is None:
            return fn()
        t, box = _start_guarded(fn, "supervised-engine-step")
        self._step_thread = t
        t.join(self.watchdog_s)
        if t.is_alive():
            raise StepStalled(self.watchdog_s)
        if "e" in box:
            raise box["e"]
        return box.get("r")

    def step(self) -> bool:
        """One supervised scheduler step. A failure triggers teardown +
        journal recovery and the step is retried on the rebuilt engine;
        the circuit breaker bounds consecutive failures. Returns False
        when no work remains. The journal sync after the step is inside
        the failure domain too."""
        self._check_alive()
        try:
            return self._step_supervised()
        except BaseException as exc:
            # black box on the way out: EngineDead (circuit open) and
            # anything a failure handler re-raised leave a flight dump
            self._flight_dump_safe(type(exc).__name__, err=str(exc))
            raise

    def _step_supervised(self) -> bool:
        while True:
            try:
                alive = self._guarded(self.scheduler.step)
                self._on_success()
                self._record_flight_tick()
                if not alive and self.wal is not None:
                    # going idle: the buffered deltas and an fsync now,
                    # so a quiescent supervisor is durably consistent
                    # and a crash never revives finished work
                    self._sync_journal(force=True)
                    self.wal.commit(force=True)
            except EngineDead:
                raise
            except Exception as e:  # noqa: BLE001 — classify + recover
                self._on_failure(e)
                continue
            return alive

    def run(self) -> None:
        """Drive steps until every request finished (raises
        :class:`EngineDead` if the circuit opens first)."""
        while self.step():
            pass

    def _sync_journal(self, wal: bool = True, force: bool = False):
        self.journal.sync(swapped_check=getattr(
            self.engine.cache, "has_swapped", None), wal=wal,
            force=force)

    def _on_success(self):
        """After a step's commit: the journal sync (the log's delta
        frame), the generator snapshot, the group-commit boundary and
        the periodic checkpoint. Host work (a prefix checkpoint also
        fetches the trie's pages): the tokens it writes were fetched by
        the commit, and a forward the overlapped pipeline left in flight
        is not read."""
        self.steps_total += 1
        self._consec_failures = 0
        self._sync_journal()
        self._snapshot_key()
        if self.wal is not None:
            if self.engine.temperature != 0.0:
                # sampled decode: the generator state is recovery state
                # (a greedy replay never reads it)
                from .wal import GEN_STATE
                self.wal.append(GEN_STATE, {
                    "data": base64.b64encode(
                        self._key_data.tobytes()).decode(),
                    "dtype": str(self._key_data.dtype),
                    "shape": list(self._key_data.shape)})
            self.wal.commit()       # the group-commit boundary
            if (self.checkpoint_every
                    and self.steps_total % self.checkpoint_every == 0):
                self.checkpoint_now()
        self._deescalate_maybe()
        self._release_abandoned()
        _obs.serving_journal(self.journal.size, self.journal.token_count)

    def _release_abandoned(self):
        """Drop the poisoned engines whose abandoned step threads have
        ended (module docstring)."""
        if self._abandoned:
            self._abandoned = [(t, e) for t, e in self._abandoned
                               if t.is_alive()]

    # ---- flight recorder ----
    def _record_flight_tick(self, fault: Optional[str] = None) -> None:
        """Fold one scheduler tick into the flight ring: plan summary,
        budget use, degraded rung, failure streak. One small dict
        append; no-op when the recorder is disabled."""
        if self.flight is None:
            return
        sched = self.scheduler
        plan = sched.last_plan if sched is not None else None
        self.flight.record_tick(
            step=self.steps_total,
            committed=(sched.last_committed if sched is not None else 0),
            planned_tokens=(plan.scheduled_tokens if plan is not None
                            else 0),
            reserved_tokens=(plan.reserved_tokens if plan is not None
                             else 0),
            budget=(plan.budget if plan is not None else None),
            decode_slots=(len(plan.decode_slots) if plan is not None
                          else 0),
            prefills=(len(plan.prefills) if plan is not None else 0),
            queued=(sum(len(q) for q in sched._queues.values())
                    if sched is not None else 0),
            degraded=self.degraded_level,
            failures=self._consec_failures,
            host_frac=(sched.last_host_frac if sched is not None
                       else None),
            wal_lsn=(self.wal.lsn if self.wal is not None else None),
            fault=fault)
        _obs.serving_flight_tick()

    def dump_flight(self, reason: str = "manual",
                    out_dir: Optional[str] = None,
                    err: Optional[str] = None) -> Optional[str]:
        """Write the flight-recorder black box (on demand, and the crash
        paths' exit hatch): the tick ring + request-trace tails as a
        CRC-framed ``flight-<ts>.json`` in ``out_dir`` (default: the
        WAL directory, else the system temp dir). Returns the path;
        None when the recorder is disabled."""
        if self.flight is None:
            return None
        if out_dir is None:
            out_dir = (self.wal.path if self.wal is not None
                       else tempfile.gettempdir())
        extra = {"health": self.health,
                 "degraded_level": self.degraded_level,
                 "consec_failures": self._consec_failures,
                 "recoveries": self.recoveries,
                 "steps_total": self.steps_total}
        if err:
            extra["error"] = err
        path = self.flight.dump(out_dir, reason, extra=extra)
        self.last_flight_dump = path
        _obs.serving_flight_dump(reason, os.path.getsize(path))
        return path

    def _flight_dump_safe(self, reason: str, err: str = "") -> None:
        """Best-effort dump on the crash path — a second failure here
        must never mask the one propagating."""
        try:
            self.dump_flight(reason, err=err)
        except Exception:
            pass

    def checkpoint_now(self) -> Optional[str]:
        """One incremental checkpoint: the live journal and the
        generator state (and, with ``checkpoint_prefix``, the prefix
        trie's pages, fetched from the card inline) in an atomic
        ``ckpt-<lsn>.npz`` next to the log, then the segments it covers
        pruned. Admissions never stop; cold recovery is checkpoint +
        log-suffix replay. Returns the file's path (None without a
        log)."""
        if self.wal is None:
            return None
        grammars: Dict[str, Dict] = {}
        now = self.clock()
        meta = dict(self._geometry(),
                    sessions=[e.as_record(now, grammars=grammars)
                              for e in self.journal.live_entries()],
                    grammars=grammars, next_rid=self._next_rid)
        from .wal import GEN_STATE
        arrays: Dict[str, np.ndarray] = {
            GEN_STATE: self._key_data if self._key_data is not None
            else np.zeros((0,), np.uint8)}
        meta["prefix"] = _prefix_payload(
            self.engine.cache.checkpoint_prefix()
            if self.checkpoint_prefix else None, arrays)
        path = self.wal.checkpoint(meta, arrays)
        # the checkpoint carries its own grammars and pruning may drop
        # the earlier grammar records: later submits append theirs
        self.journal._wal_grammars.clear()
        return path

    def _on_failure(self, err: Exception):
        stalled = isinstance(err, StepStalled)
        injected = isinstance(err, InjectedFault)
        site = getattr(err, "site", None) or "step"
        kind = getattr(err, "mode", None) or type(err).__name__
        inj = _ACTIVE
        if stalled and not injected:
            # the watchdog only ever sees a StepStalled — ask the
            # installed injector whether the stall was its own, so chaos
            # runs never inflate the REAL-failure counter
            if inj is not None and inj.pending_stalls:
                site = inj.pending_stalls.pop(0)
                injected = True
        elif injected and kind == "stall":
            # the stall woke BEFORE the watchdog and raised itself:
            # retire its pending entry
            if inj is not None and site in inj.pending_stalls:
                inj.pending_stalls.remove(site)
        if injected:
            self.injected_faults += 1
            # the injector already counted itself at fire time
        else:
            self.real_faults += 1
            _obs.serving_fault(site, kind, injected=False)
        self._consec_failures += 1
        # a faulted tick never reached the success-path recorder
        self._record_flight_tick(fault=f"{site}:{kind}")
        if self._consec_failures >= self.circuit_threshold:
            self._die(err)
        self._sleep(min(self.backoff_max_s,
                        self.backoff_s
                        * (2 ** (self._consec_failures - 1))))
        self._recover(sync=not stalled)

    def _die(self, err: Exception):
        """Open the circuit: mark every live request with the structured
        ``engine_dead`` reason (nothing is silently lost — the journal is
        retained) and stop retrying."""
        self._dead = True
        for e in self.journal.live_entries():
            req = e.req
            if req is not None and not req.done:
                req.done = True
                req.finish_reason = "engine_dead"
        if self.scheduler is not None:
            self.scheduler.degraded_level = len(DEGRADED_MODES)
        _obs.serving_degraded(len(DEGRADED_MODES))  # off-ladder: dead
        raise EngineDead(
            f"circuit breaker open after {self._consec_failures} "
            f"consecutive step failures; last: "
            f"{type(err).__name__}: {err}") from err

    def _recover(self, sync: bool = True):
        """Teardown + rebuild + journal restore. ``sync=False`` for
        stalls: the abandoned thread may still be running, so the
        journal keeps its last-committed state instead of reading the
        handles mid-race, and the poisoned engine is held until that
        thread ends (module docstring)."""
        t0 = _obs.generate_begin()
        if sync:
            # in memory only: a recovery that a log fault triggered must
            # not re-enter the faulting append; the cursors catch up at
            # the next successful step's sync
            self._sync_journal(wal=False)
        live = self.journal.live_entries()
        replay = sum(e.prompt.size + max(0, len(e.tokens) - 1)
                     for e in live if e.admitted and not e.swapped)
        old = self.engine
        self._fence(old)
        t = self._step_thread
        if not sync and t is not None and t.is_alive():
            self._abandoned.append((t, old))
        self._build()
        for e in live:
            req = e.req
            req.slot = None
            req.done = False
            req.tokens = list(e.tokens)
            if e.admitted:
                # a crashed-out session is an eviction the request never
                # asked for: resume semantics (transient reason, replay
                # accounting, deadline exemption) apply verbatim
                req.preemptions = e.preemptions + 1
                req.finish_reason = FinishReason.PREEMPTED.value
            else:
                req.finish_reason = None
            self.scheduler.requeue(req)
        self.recoveries += 1
        self._escalate()
        _obs.serving_fault_recovery(t0, len(live), replay)

    # ---- drain / restore ----
    def drain(self, path: str) -> Dict:
        """Stop admissions and checkpoint to ``path`` (one ``.npz``):
        every live session's journal record (grammar state included),
        the prefix-cache trie (structure + page KV bytes), the generator
        state and the engine geometry for restore-time validation. The
        supervisor is frozen afterwards (submit/step raise) — restore
        the file into a fresh supervisor via :meth:`restore`. Returns a
        summary dict."""
        self._check_alive()
        t0 = _obs.generate_begin()
        # an overlapped step may be dispatched but uncommitted: commit
        # it so sessions checkpoint with every token the card produced
        self.engine.commit_inflight()
        self._sync_journal(force=True)
        self._snapshot_key()
        now = self.clock()
        cache = self.engine.cache
        ckpt = cache.checkpoint_prefix()
        grammars: Dict[str, Dict] = {}
        meta = {
            "sessions": [e.as_record(now, grammars=grammars)
                         for e in self.journal.live_entries()],
            "grammars": grammars,
            "next_rid": self._next_rid,
            "page_size": cache.page_size,
            "max_len": cache.max_len,
            "max_batch": cache.max_batch,
            "kv_dtype": cache.kv_dtype_name,
            "draft": _draft_identity(self.engine),
        }
        arrays: Dict[str, np.ndarray] = {
            "key_data": self._key_data if self._key_data is not None
            else np.zeros((0,), np.uint8)}
        meta["prefix"] = _prefix_payload(ckpt, arrays)
        with open(path, "wb") as f:
            np.savez(f, meta=np.frombuffer(
                json.dumps(meta).encode(), np.uint8), **arrays)
        # freeze ONLY once the checkpoint is safely on disk: a failed
        # write leaves the supervisor serving
        self._draining = True
        if self.wal is not None:
            # the drain file owns these sessions now: tombstone them in
            # the log (and fsync), so a cold recovery of the directory
            # never revives what restore() revives elsewhere
            try:
                for e in self.journal.live_entries():
                    if e.wal_submitted:
                        self.wal.append("finish", {"rid": e.rid,
                                                   "reason": "drained"})
                self.wal.commit(force=True)
                self.wal.close()
            except Exception:
                pass        # the drain file is authoritative regardless
        nbytes = os.path.getsize(path)
        n_pages = len(meta["prefix"]["page_ids"]) if meta["prefix"] \
            else 0
        _obs.serving_drain_checkpoint(t0, nbytes,
                                      len(meta["sessions"]), n_pages)
        return {"path": path, "bytes": nbytes,
                "sessions": len(meta["sessions"]),
                "trie_pages": n_pages}

    @classmethod
    def restore(cls, engine_factory: Callable, path: str,
                **kw) -> "EngineSupervisor":
        """Build a fresh supervisor and restore a :meth:`drain`
        checkpoint into it: trie pages are written back into the new
        pool FIRST (so session replays — and future admissions — hit the
        restored prefix cache), then every checkpointed session is
        requeued through the resume path. Restored request handles live
        in ``.restored`` (rid -> request)."""
        sup = cls(engine_factory, **kw)
        t0 = _obs.generate_begin()
        ckpt = load_drain_checkpoint(path)
        meta = ckpt["meta"]
        cache = sup.engine.cache
        for knob in ("page_size", "max_len", "max_batch"):
            if meta[knob] != getattr(cache, knob):
                raise ValueError(
                    f"restore: checkpoint {knob}={meta[knob]} does "
                    f"not match the fresh engine's "
                    f"{getattr(cache, knob)} — the factory must "
                    f"rebuild the drained engine's geometry")
        if meta["kv_dtype"] != cache.kv_dtype_name:
            raise ValueError(
                f"restore: checkpoint kv_dtype={meta['kv_dtype']} "
                f"!= engine kv_dtype={cache.kv_dtype_name}")
        draft = _draft_identity(sup.engine)
        if meta.get("draft") != draft:
            raise ValueError(
                f"restore: checkpoint draft identity="
                f"{meta.get('draft')} != engine {draft} — the factory "
                f"must rebuild the same draft_layers/spec_tree (the "
                f"draft pool itself rebuilds cold)")
        key_data = ckpt["key_data"]
        if key_data.size:
            sup._key_data = key_data.astype(np.uint8)
            sup.engine.generator.set_state(
                torch.from_numpy(sup._key_data.copy()))
        n_pages = 0
        if ckpt["prefix"] is not None:
            cache.restore_prefix(ckpt["prefix"])
            n_pages = len(ckpt["prefix"]["page_ids"])
        sup._next_rid = int(meta["next_rid"])
        sup.engine._next_rid = max(sup.engine._next_rid, sup._next_rid)
        sup.restored = {}
        for rec in meta["sessions"]:
            req = _session_from_record(sup, rec,
                                       grammars=meta.get("grammars"))
            sup.journal.adopt(req, rec, now=sup.clock())
            sup.scheduler.requeue(req)
            sup.restored[req.rid] = req
        _obs.serving_drain_restore(t0, os.path.getsize(path),
                                   len(meta["sessions"]), n_pages)
        return sup

    @classmethod
    def recover_from_disk(cls, engine_factory: Callable, wal_dir: str,
                          **kw) -> "EngineSupervisor":
        """Rebuild a supervisor from its journal directory after the
        whole process died (``kill -9``, OOM kill, reboot: no drain, no
        in-memory journal): scan the log (:func:`~.wal.recover_state`:
        torn tail truncated, corrupt media quarantined, newest valid
        checkpoint + suffix), build a fresh engine, and requeue every
        live session through the replay path. The recovered supervisor
        appends to the SAME directory, in a fresh segment, so repeated
        crashes recover repeatedly. Restored handles are in
        ``.restored`` (rid -> request)."""
        from .wal import recover_state
        t0 = _obs.generate_begin()
        state = recover_state(wal_dir, repair=True)
        kw = dict(kw)
        wk = dict(kw.get("wal_kw") or {})
        # the scan just ran: the fresh log takes its lsn
        wk.setdefault("last_lsn", state["report"]["last_lsn"])
        kw["wal_kw"] = wk
        sup = cls(engine_factory, wal_dir=wal_dir, **kw)
        try:
            sup._install_recovered(state, t0)
        except Exception:
            # a refused recovery (geometry, kv tier or draft mismatch)
            # leaves the journal as it found it: construction appended
            # this factory's meta record, so the dead incarnation's goes
            # in again after it, for a retry with the right factory
            geo = state.get("geometry")
            if geo is not None and sup.wal is not None:
                sup.wal.append("meta", dict(
                    geo, next_rid=int(state.get("next_rid", 0))))
                sup.wal.commit(force=True)
            raise
        # the dead incarnation's black box, if it wrote one
        from ..observability import flight as _flight
        dumps = _flight.find_dumps(wal_dir)
        if dumps:
            sup.last_flight_dump = dumps[-1]
        return sup

    def _install_recovered(self, state: Dict, t0: int = 0) -> None:
        """Apply a :func:`~.wal.recover_state` fold: validate the
        geometry, set the generator state, restore the prefix trie
        BEFORE the sessions (their replays and later admissions hit
        it), then requeue every live session as a durable journal
        entry (only future deltas append)."""
        geo = state.get("geometry")
        if geo is not None:
            mine = self._geometry()
            for knob in ("page_size", "max_len", "max_batch"):
                if geo.get(knob) is not None and geo[knob] != mine[knob]:
                    raise ValueError(
                        f"recover_from_disk: journaled {knob}="
                        f"{geo[knob]} does not match the fresh "
                        f"engine's {mine[knob]} — the factory must "
                        f"rebuild the dead engine's geometry")
            if geo.get("kv_dtype") != mine["kv_dtype"]:
                raise ValueError(
                    f"recover_from_disk: journaled kv_dtype="
                    f"{geo.get('kv_dtype')} != engine kv_dtype="
                    f"{mine['kv_dtype']}")
            if geo.get("draft") != mine["draft"]:
                raise ValueError(
                    f"recover_from_disk: journaled draft identity="
                    f"{geo.get('draft')} != engine {mine['draft']} — "
                    f"the factory must rebuild the same draft_layers/"
                    f"spec_tree (the draft pool itself rebuilds cold)")
        gen = state.get("gen_state")
        if gen is not None and gen.size:
            self._key_data = np.asarray(gen, np.uint8).copy()
            self.engine.generator.set_state(
                torch.from_numpy(self._key_data.copy()))
        if state.get("prefix") is not None:
            self.engine.cache.restore_prefix(state["prefix"])
        self._next_rid = max(self._next_rid,
                             int(state.get("next_rid", 0)))
        self.engine._next_rid = max(self.engine._next_rid,
                                    self._next_rid)
        report = state.get("report", {})
        self.restored = {}
        for rid in sorted(state.get("sessions", {})):
            trs = _obs.serving_trace_now()
            rec = state["sessions"][rid]
            req = _session_from_record(self, rec,
                                       grammars=state.get("grammars"))
            self.journal.adopt(req, rec, durable=True)
            # requeue attaches the trace; the replay span lands after
            self.scheduler.requeue(req)
            if trs:
                _obs.serving_trace_span(
                    req, "wal_replay", trs,
                    replica=self.replica_id, seq=len(req.tokens))
            self.restored[req.rid] = req
        _obs.serving_wal_recovery(
            t0, len(self.restored),
            int(report.get("replayed_records", 0)),
            int(report.get("torn_tail_truncated", 0)),
            int(report.get("corrupt_quarantined", 0))
            + int(report.get("ckpt_quarantined", 0)))

    # ---- introspection ----
    def load_stats(self) -> Dict:
        """The scheduler's load snapshot plus the supervisor's own
        health and draining state."""
        s = (self.scheduler.load_stats()
             if self.scheduler is not None else {
                 "queue_depths": {}, "queued_total": 0,
                 "queued_tokens": 0, "inflight_tokens": 0, "running": 0,
                 "pending_prefills": 0, "free_slots": 0,
                 "oldest_deadline_slack_s": None, "pool_occupancy": 1.0,
                 "pool_free_pages": 0,
                 "degraded_level": len(DEGRADED_MODES),
                 "degraded_mode": "dead"})
        s["health"] = self.health
        s["draining"] = self._draining
        if self.wal is not None:
            # how far the on-disk journal trails: a router can bound
            # crash exposure as it reads backlog
            s["wal"] = self.wal.stats()
        return s

    def stats(self) -> Dict:
        s = self.scheduler.stats() if self.scheduler is not None else {}
        s.update({
            "health": self.health,
            "degraded_level": self.degraded_level,
            "degraded_mode": self.degraded_mode,
            "recoveries": self.recoveries,
            "injected_faults": self.injected_faults,
            "real_faults": self.real_faults,
            "shed_total": self.shed_total,
            "supervised_steps": self.steps_total,
            "journal_entries": self.journal.size,
            "journal_tokens": self.journal.token_count,
        })
        return s
