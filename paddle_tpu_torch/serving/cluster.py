"""Disaggregated serving cluster: supervised engine replicas behind a
prefix-affinity router, with the prefill→decode KV handoff.

The port's counterpart of ``paddle_tpu/serving/cluster.py``, the same
control plane line for line (tp-sharded replicas excepted: the port's
engines have no mesh yet). One engine is one pool of device memory, one
blast radius, and no way to upgrade without dropping sessions.
:class:`ServingCluster` is the horizontal layer above it: N
:class:`~paddle_tpu_torch.serving.EngineSupervisor`-wrapped replicas
behind a :class:`~paddle_tpu_torch.serving.router.ClusterRouter`. The
replicas live in one process and step one after another on the
caller's thread; on one card they share its memory and its stream.

- **Routing** — submissions queue at the cluster and dispatch in
  per-tenant fair-share order (ascending token account); placement is
  prefix-affinity first (the prompt's leading full pages hash to the
  replica whose :class:`~paddle_tpu_torch.serving.PrefixCache` trie
  already holds the tenant's system prompt), least-loaded and
  healthiest otherwise, read from the public
  :meth:`~paddle_tpu_torch.serving.ServingScheduler.load_stats`
  snapshot (mirrored to the metrics registry as the
  ``serving_replica_*`` gauges). Per-tenant
  :class:`~paddle_tpu_torch.serving.router.TenantQuota` rate limits
  reject over-quota submissions with ``rejected_ratelimit`` before any
  replica sees them; a request a degraded replica sheds
  (``rejected_overload``) re-dispatches to untried replicas under a
  per-request retry budget and a per-tenant retry-rate cap before the
  rejection surfaces (``serving_router_retries_total`` /
  ``serving_router_retry_exhausted_total``).

- **Prefill/decode disaggregation** (``prefill_replicas > 0``) —
  dedicated prefill replicas run chunked prefill to completion, then
  hand the finished pages to a decode replica:
  :meth:`~paddle_tpu_torch.serving.PagedKVCache.export_request` (the
  raw page bytes of the request's block table, with per-array CRC32s)
  → :meth:`~paddle_tpu_torch.serving.PagedKVCache.import_request` (the
  CRCs verified, then one scatter into the decode pool), or with
  ``direct_handoff=True`` a page-to-page copy between the two pools on
  the card (:meth:`~paddle_tpu_torch.serving.PagedKVCache.
  import_request_direct`). Either way the decode side's pages are
  byte-equal to prefilling in place; when no decode slot is free the
  prefill replica keeps serving the request (disaggregation is an
  optimization, never a stall). The cluster, not the engine, closes
  the ``serving_handoff_export`` / ``serving_handoff_import`` hooks,
  once per handoff.

- **Failover and rolling upgrade** — a replica whose circuit opens
  (:class:`~paddle_tpu_torch.serving.EngineDead`) is rebuilt in place
  and its journaled sessions re-dispatch onto survivors (resume
  semantics: token-identical replay, or a swap-in from the shared host
  tier; nothing lost); :meth:`retire_replica` drains one replica
  through the supervisor's drain path, requeues its sessions elsewhere
  MID-DECODE, and restores the drained prefix trie into the
  replacement so the tenant's next prompt still hits its prefix.

- **Overload hardening** — an optional
  :class:`~paddle_tpu_torch.serving.router.AdmissionController` sheds
  deadline-infeasible submissions at the door
  (``rejected_infeasible``), a :class:`ClusterAutoscaler` breathes the
  decode-replica count with backlog and degraded rungs (hysteresis and
  cooldown; scale-down drains through :meth:`retire_replica`, so
  sessions rehome with nothing lost), and the handoff verifies payload
  CRCs before install (a corrupt payload is detected, counted, and the
  request keeps decoding on its prefill replica) with bounded
  idempotent retries on transient import faults.

- **Durability** — ``wal_dir`` gives every replica its own write-ahead
  log directory (``replica<i>/``); :meth:`recover_from_disk` rebuilds
  the whole cluster after process death.

Token identity holds by construction: per-request greedy decode is
independent of batch composition, so routed output matches a single
engine serving the same request set (in f32; bf16 near-ties may split
when batch composition changes on the card).
"""
from __future__ import annotations

import os
import tempfile
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from ..observability import hooks as _obs
from .host_tier import _tampered_entry
from .paged_cache import PoolExhausted
from .policy import FinishReason, Priority
from .resilience import (CorruptionDetected, EngineDead,
                         EngineSupervisor, StepStalled, fault_point,
                         load_drain_checkpoint, run_with_deadline,
                         tamper_point)
from .router import AdmissionController, ClusterRouter, TenantQuota


class ClusterAutoscaler:
    """Hysteresis policy + state for the cluster's closed scaling loop:
    each :meth:`ServingCluster.step` feeds it the decode
    tier's backlog-per-serviceable-replica and worst degraded rung, and
    it answers ``"up"`` / ``"down"`` / ``None``.

    Flap-proofing is structural: scale-up needs ``up_after``
    CONSECUTIVE over-threshold ticks (backlog at or above
    ``up_backlog_per_replica``, or any replica at or past
    ``degraded_rung_trigger`` — a rung that deep means the degraded-mode
    ladder is already shedding, so more silicon beats more shedding), scale-
    down needs ``down_after`` consecutive under-threshold ticks with
    every replica healthy, the two thresholds leave a dead band
    between them, and ANY action starts a ``cooldown_ticks`` refractory
    window. ``min_replicas``/``max_replicas`` bound the serviceable
    decode-replica count."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4, *,
                 up_backlog_per_replica: float = 4.0,
                 down_backlog_per_replica: float = 0.5,
                 up_after: int = 2, down_after: int = 4,
                 cooldown_ticks: int = 8,
                 degraded_rung_trigger: int = 2):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"ClusterAutoscaler: need 1 <= min_replicas="
                f"{min_replicas} <= max_replicas={max_replicas}")
        if down_backlog_per_replica >= up_backlog_per_replica:
            raise ValueError(
                f"ClusterAutoscaler: down threshold "
                f"{down_backlog_per_replica} must sit strictly below "
                f"the up threshold {up_backlog_per_replica} — the dead "
                f"band between them is the anti-flap margin")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_backlog = float(up_backlog_per_replica)
        self.down_backlog = float(down_backlog_per_replica)
        self.up_after = max(1, int(up_after))
        self.down_after = max(1, int(down_after))
        self.cooldown_ticks = max(0, int(cooldown_ticks))
        self.degraded_rung_trigger = int(degraded_rung_trigger)
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0
        self.up_events = 0
        self.down_events = 0

    def decide(self, backlog_per_replica: float, serviceable: int,
               max_rung: int) -> Optional[str]:
        """One tick's decision; mutates the hysteresis state."""
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        pressure = (backlog_per_replica >= self.up_backlog
                    or max_rung >= self.degraded_rung_trigger)
        calm = (backlog_per_replica <= self.down_backlog
                and max_rung == 0)
        if pressure:
            self._up_streak += 1
            self._down_streak = 0
        elif calm:
            self._down_streak += 1
            self._up_streak = 0
        else:
            # the dead band: neither streak advances, neither resets
            # the other's progress to zero-and-back flapping
            self._up_streak = 0
            self._down_streak = 0
        if (pressure and self._up_streak >= self.up_after
                and serviceable < self.max_replicas):
            self._up_streak = 0
            self._cooldown = self.cooldown_ticks
            self.up_events += 1
            return "up"
        if (self._down_streak >= self.down_after
                and serviceable > self.min_replicas):
            self._down_streak = 0
            self._cooldown = self.cooldown_ticks
            self.down_events += 1
            return "down"
        return None

    def stats(self) -> Dict:
        return {"up_events": self.up_events,
                "down_events": self.down_events,
                "cooldown_remaining": self._cooldown,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas}


class ServingCluster:
    """N supervised engine replicas behind a cluster router.

    ``engine_factory() -> ContinuousBatchingEngine`` builds one FRESH
    replica engine (identical config each call — the same contract
    :class:`~paddle_tpu_torch.serving.EngineSupervisor` already imposes;
    replicas share the params tree read-only). ``prefill_replicas``
    carves the first K replicas out as dedicated prefill engines
    (0 = every replica serves end-to-end). ``quotas`` maps tenant ->
    :class:`~paddle_tpu_torch.serving.router.TenantQuota`. ``supervisor_kw``
    passes through to every replica's supervisor (watchdog, backoff,
    circuit threshold). ``clock`` is shared by the router, every
    scheduler and every supervisor so deadlines mean one thing
    cluster-wide.
    """

    def __init__(self, engine_factory: Callable, replicas: int = 2, *,
                 prefill_replicas: int = 0,
                 token_budget: Optional[int] = None,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 router: Optional[ClusterRouter] = None,
                 clock: Callable[[], float] = time.monotonic,
                 supervisor_kw: Optional[Dict] = None,
                 share_host_tier: bool = True,
                 direct_handoff: bool = False,
                 overlap: Optional[bool] = None,
                 admission: Optional[AdmissionController] = None,
                 autoscaler: Optional[ClusterAutoscaler] = None,
                 handoff_retries: int = 2,
                 handoff_timeout_s: Optional[float] = None,
                 retry_sleep: Callable[[float], None] = time.sleep,
                 wal_dir: Optional[str] = None,
                 _recover: bool = False):
        if replicas < 1:
            raise ValueError(f"replicas={replicas} must be >= 1")
        if not 0 <= prefill_replicas < replicas:
            raise ValueError(
                f"prefill_replicas={prefill_replicas} must leave at "
                f"least one decode replica (replicas={replicas})")
        self._factory = engine_factory
        self.token_budget = token_budget
        self.clock = clock
        self._sup_kw = dict(supervisor_kw or {})
        # crash-durable cluster: wal_dir gives EVERY replica
        # its own journal directory (replica<i>/) — failover
        # replacements adopt the dead replica's directory (journal
        # continuity), and recover_from_disk() rebuilds the whole
        # cluster after whole-process death, replica by replica
        self.wal_dir = wal_dir
        self._recovering = bool(_recover)
        if overlap is not None:
            # async overlapped runtime: every supervised
            # replica's scheduler runs the double-buffered pipeline —
            # threaded through scheduler_kw so supervisor rebuilds
            # (failover, retirement replacements) keep the mode. None
            # defers to the factory's engines (their overlap knob).
            kw = dict(self._sup_kw.get("scheduler_kw") or {})
            kw["overlap"] = bool(overlap)
            self._sup_kw["scheduler_kw"] = kw
        self.overlap = overlap
        self._next_rid = 0
        self._host_store = None
        self.replicas: List[EngineSupervisor] = [
            self._new_supervisor(i) for i in range(replicas)]
        self._recovering = False
        if share_host_tier:
            # hierarchical KV: when the factory builds
            # host-tiered engines, every replica shares ONE
            # HostPageStore — rids are cluster-unique, and page bytes
            # are position-addressed, so a session swapped out on a
            # dying replica SWAPS IN on whichever replica it rehomes
            # to (no replay), and a failover/retirement replacement
            # starts warm from the standing prefix tier
            store = getattr(self.replicas[0].engine.cache, "host", None)
            if store is not None:
                self._host_store = store
                for sup in self.replicas[1:]:
                    self._attach_host_store(sup)
        self.prefill_replicas = prefill_replicas
        page = self.replicas[0].engine.cache.page_size
        for sup in self.replicas[1:]:
            if sup.engine.cache.page_size != page:
                raise ValueError(
                    "engine_factory returned replicas with different "
                    "page sizes — handoff and affinity need one "
                    "geometry")
        self.router = router if router is not None else ClusterRouter(
            page, quotas=quotas, clock=clock)
        self._rq: List[Dict] = []       # undispatched submissions
        self._live: Dict[int, object] = {}  # rid -> live request handle
        self._meta: Dict[int, Dict] = {}  # rid -> {tenant, cost}
        self._owner: Dict[int, int] = {}  # rid -> replica idx
        # direct prefill→decode handoff: replicas sharing this process
        # (and device) copy pages pool to pool
        # (PagedKVCache.import_request_direct) instead of staging raw
        # bytes through host memory — byte-identical. Opt-in: a
        # cross-host cluster (and the CRC-checked payload) needs the
        # host-staged path.
        self.direct_handoff = bool(direct_handoff)
        self._seq = 0
        self._steps = 0
        # SLO-guarded admission + autoscaling: the
        # controller sheds deadline-infeasible submissions at the door
        # (rejected_infeasible — BEFORE the degraded-mode ladder pays
        # for them), the autoscaler breathes the decode-replica count
        # with load through the existing retire_replica drain path
        self.admission = admission
        self.autoscaler = autoscaler
        # bounded idempotent handoff retry (+ optional per-import
        # deadline): a transient decode-side import fault retries with
        # backoff before it costs that replica a recovery
        self.handoff_retries = int(handoff_retries)
        self.handoff_timeout_s = handoff_timeout_s
        self._retry_sleep = retry_sleep
        self.handoffs_total = 0
        self.handoff_retries_total = 0
        self.handoff_corruptions_total = 0
        self.autoscale_faults_total = 0
        self.failovers_total = 0
        self.retirements_total = 0
        self.deadline_cancels_total = 0

    def _replica_wal_dir(self, idx: int) -> Optional[str]:
        if self.wal_dir is None:
            return None
        return os.path.join(self.wal_dir, f"replica{idx:03d}")

    def _new_supervisor(self, idx: int) -> EngineSupervisor:
        kw = dict(self._sup_kw)
        wdir = self._replica_wal_dir(idx)
        if wdir is not None:
            kw.setdefault("wal_dir", wdir)
        if wdir is not None and self._recovering \
                and os.path.isdir(wdir) and os.listdir(wdir):
            # cold cluster recovery: the replica adopts its (or its
            # dead predecessor's) journal directory wholesale — torn
            # tail repaired, checkpoint + suffix replayed, sessions
            # requeued through the resume path
            sup = EngineSupervisor.recover_from_disk(
                self._factory, wdir,
                token_budget=self.token_budget, clock=self.clock,
                **{k: v for k, v in kw.items() if k != "wal_dir"})
        else:
            sup = EngineSupervisor(self._factory,
                                   token_budget=self.token_budget,
                                   clock=self.clock, **kw)
        sup.engine._next_rid = max(sup.engine._next_rid, self._next_rid)
        self._next_rid = max(self._next_rid, sup.engine._next_rid)
        # replica identity for trace spans + flight dumps:
        # the supervisor propagates it into scheduler/engine and
        # re-stamps across its own rebuilds
        sup.replica_id = idx
        self._attach_host_store(sup)
        return sup

    def _attach_host_store(self, sup: EngineSupervisor) -> None:
        """Point a (tiered) replica's cache at the cluster-shared
        :class:`~paddle_tpu_torch.serving.host_tier.HostPageStore`; the
        supervisor's own rebuilds then carry it forward
        (``adopt_host_tier``), so the share survives recoveries."""
        store = getattr(self, "_host_store", None)
        if store is not None and hasattr(sup.engine.cache, "host"):
            sup.engine.cache.host = store

    # ---- roles ----
    def _prefill_idxs(self) -> List[int]:
        return list(range(self.prefill_replicas))

    def _decode_idxs(self) -> List[int]:
        return list(range(self.prefill_replicas, len(self.replicas)))

    def _alive(self, idxs) -> Dict[int, Dict]:
        """load_stats snapshots of the serviceable replicas among
        ``idxs`` — the router's whole worldview."""
        out = {}
        for i in idxs:
            sup = self.replicas[i]
            if sup.health == "dead" or sup._draining:
                continue
            out[i] = sup.load_stats()
        return out

    # ---- intake ----
    def submit(self, prompt, max_new_tokens: int = 16, *,
               tenant: str = "default", priority=Priority.NORMAL,
               deadline_s: Optional[float] = None, eos_token_id=None,
               adapter_id: int = 0, constraint=None):
        """Queue a prompt for routed dispatch. The handle fills in as
        cluster steps run, exactly like a single engine's. Over-quota
        tenants get an immediate ``rejected_ratelimit``; everything
        else dispatches on the next :meth:`step` in fair-share order.

        ``adapter_id``: the request's LoRA variant — every
        replica must have been built with an adapter pool over a
        SHARED registry (the factory closes over one
        :class:`~paddle_tpu_torch.serving.adapters.AdapterRegistry`), so any
        replica can load the adapter and the router is free to place
        by affinity. ``constraint``: a per-request grammar
        (``constraints=True`` engines)."""
        eng = self.replicas[self._first_alive()].engine
        eng._next_rid = max(eng._next_rid, self._next_rid)
        req = eng.create_request(prompt, max_new_tokens=max_new_tokens,
                                 eos_token_id=eos_token_id,
                                 adapter_id=adapter_id,
                                 constraint=constraint)
        self._next_rid = eng._next_rid
        req.priority = int(priority)
        cost = req.prompt.shape[1] + req.max_new_tokens
        self._live[req.rid] = req
        self._meta[req.rid] = {"tenant": tenant, "cost": cost}
        # trace minted at CLUSTER intake — replica -1 is the
        # router lane; the handle carries the trace through dispatch,
        # handoff and failover rehomes, stitching them into one trace
        _obs.serving_trace_submit(req)
        if not self.router.admit_rate_limit(tenant, cost):
            req.done = True
            req.finish_reason = FinishReason.REJECTED_RATELIMIT.value
            self.router.note_ratelimited(tenant)
            _obs.serving_cancelled(1, req.finish_reason)
            _obs.serving_trace_finish(req, req.finish_reason)
            return req
        if deadline_s is not None and self.admission is not None:
            # SLO-guarded admission: feasibility is judged
            # against the tier that will produce this request's FIRST
            # token — fresh submissions dispatch to the prefill tier
            # when one exists (_dispatch_one's role rule), so an idle
            # decode replica must not mask a buried prefill queue.
            # The load_stats walk (O(queued requests) per replica)
            # only runs when the service-rate model is on; without
            # tokens_per_s feasible() never reads the loads.
            if self.admission.tokens_per_s is not None:
                role = (self._prefill_idxs() if self.prefill_replicas
                        else self._decode_idxs())
                loads = (self._alive(role) or self._alive(
                    range(len(self.replicas)))).values()
            else:
                loads = ()
            if not self.admission.feasible(
                    float(deadline_s), req.prompt.shape[1], loads):
                # the deadline cannot be met against current backlog —
                # reject at the door instead of queueing work that will
                # expire (or push replicas onto the degraded ladder)
                # without ever producing goodput
                req.done = True
                req.finish_reason = FinishReason.REJECTED_INFEASIBLE.value
                self.router.note_slo_rejected(tenant)
                _obs.serving_cancelled(1, req.finish_reason)
                _obs.serving_trace_finish(req, req.finish_reason)
                return req
        if deadline_s is not None:
            req.deadline_at = self.clock() + float(deadline_s)
        _obs.serving_trace_enqueued(req)
        self._rq.append({"req": req, "tenant": tenant, "cost": cost,
                         "seq": self._seq})
        self._seq += 1
        return req

    def _first_alive(self) -> int:
        for i, sup in enumerate(self.replicas):
            if sup.health != "dead" and not sup._draining:
                return i
        raise EngineDead("every replica in the cluster is dead")

    # ---- dispatch ----
    def _dispatch(self):
        """Drain the router queue in fair-share order: per-tenant FIFO
        deques, always serving the tenant with the smallest token
        account next (ties break on submission order) — O(n log n)
        over the whole queue, and the ordering bound the fairness
        guarantee rests on: a light tenant's request outranks every
        request of any tenant that already consumed more. Dispatch =
        journaled intake on the chosen replica
        (:meth:`~paddle_tpu_torch.serving.EngineSupervisor.submit_request`);
        a shed (``rejected_overload``) dispatch retries on untried
        replicas up to the router's per-request retry budget, bounded
        by the tenant's retry-rate cap. Queued requests whose deadline
        lapsed
        at the router cancel here — the same admission SLO the replica
        schedulers enforce."""
        if not self._rq:
            return
        now = self.clock()
        by_tenant: Dict[str, Deque] = {}
        for e in self._rq:              # already in ascending seq order
            by_tenant.setdefault(e["tenant"], deque()).append(e)
        self._rq = []
        accounts = self.router.accounts
        while by_tenant:
            tenant = min(by_tenant,
                         key=lambda t: (accounts.get(t, 0),
                                        by_tenant[t][0]["seq"]))
            q = by_tenant[tenant]
            e = q.popleft()
            if not q:
                del by_tenant[tenant]
            req = e["req"]
            if req.done:
                continue
            if req.deadline_at is not None and now >= req.deadline_at:
                req.done = True
                req.finish_reason = FinishReason.DEADLINE_EXCEEDED.value
                self.deadline_cancels_total += 1
                _obs.serving_cancelled(1, req.finish_reason)
                _obs.serving_trace_finish(req, req.finish_reason)
                continue
            self._dispatch_one(e)

    def _dispatch_one(self, entry: Dict):
        req = entry["req"]
        tenant = entry["tenant"]
        fresh = not req.tokens and req.preemptions == 0
        role = (self._prefill_idxs()
                if self.prefill_replicas and fresh
                else self._decode_idxs())
        loads = self._alive(role) or self._alive(
            range(len(self.replicas)))
        key = self.router.affinity_key(req.prompt[0])
        akey = self.router.adapter_key(getattr(req, "adapter_id", 0))
        idx, hit = self.router.pick_replica(key, loads,
                                            adapter_key=akey)
        _obs.serving_trace_mark(req, "dispatch", replica=idx,
                                meta={"affinity_hit": bool(hit),
                                      "tenant": tenant})
        self.replicas[idx].submit_request(req)
        self.router.note_dispatch(idx, hit, tenant)
        self._owner[req.rid] = idx

        def shed():
            return (req.done and req.finish_reason
                    == FinishReason.REJECTED_OVERLOAD.value)
        # router-level retry of shed work: a
        # per-request budget of re-dispatches to untried replicas
        # (ignore affinity — the bound replica just proved it cannot
        # take new work), bounded by the tenant's retry-rate cap so a
        # degraded replica cannot amplify one tenant's burst into a
        # cluster-wide retry storm. Exhaustion (budget/cap ran out, or
        # every replica tried) counts separately from a first-try
        # rejection with nowhere else to go.
        tried = {idx}
        attempts = 0
        while (shed() and len(loads) > len(tried)
               and self.router.may_retry(tenant, attempts)):
            self.router.note_retry(tenant)
            attempts += 1
            req.done = False
            req.finish_reason = None
            idx2, _ = self.router.pick_replica(None, loads,
                                               exclude=tried)
            _obs.serving_trace_mark(req, "dispatch_retry", replica=idx2)
            self.replicas[idx2].submit_request(req)
            self.router.note_dispatch(idx2, False, tenant)
            tried.add(idx2)
            self._owner[req.rid] = idx2
        if shed():
            req.finish_reason = FinishReason.REJECTED_OVERLOAD.value
            if attempts > 0 or (len(loads) > len(tried)
                                and not self.router.may_retry(
                                    tenant, attempts)):
                self.router.note_retry_exhausted()
        else:
            # the fair-share account charges only work a replica
            # actually accepted — a tenant whose requests are shed
            # during a degraded blip must not also sink in the
            # dispatch order for service it never received
            self.router.charge(tenant, entry["cost"])

    # ---- stepping ----
    def step(self) -> bool:
        """One cluster step: dispatch the router queue, step every
        serviceable replica (a replica whose circuit opens fails over
        in place), harvest completed prefills into decode replicas,
        publish replica load gauges. Returns False when no work remains
        anywhere."""
        self._dispatch()
        for i in range(len(self.replicas)):
            sup = self.replicas[i]
            if sup.health == "dead" or sup._draining:
                continue
            try:
                sup.step()
            except EngineDead:
                self._failover(i)
        if self.prefill_replicas:
            self._harvest_handoffs()
        self._autoscale_tick()
        self._publish()
        self._prune_finished()
        self._steps += 1
        return self._has_work()

    def run(self) -> None:
        """Drive steps until every submitted request finished."""
        while self.step():
            pass

    def _prune_finished(self) -> None:
        """Drop router bookkeeping for finished requests (the results
        live on the callers' handles) — without this, _live/_meta/
        _owner would grow with every request ever served, the same
        leak the RequestJournal's sync() avoids."""
        for rid in [r for r, req in self._live.items() if req.done]:
            del self._live[rid]
            self._meta.pop(rid, None)
            self._owner.pop(rid, None)

    def _has_work(self) -> bool:
        if any(not e["req"].done for e in self._rq):
            return True
        for sup in self.replicas:
            if sup.health == "dead" or sup._draining:
                continue
            if (any(sup.scheduler._queues.values())
                    or not sup.engine.idle):
                return True
        return False

    def _publish(self):
        """Refresh the ``serving_replica_*`` gauges — the metrics
        registry is the cluster's signal bus: replicas publish,
        dashboards (and any external balancer) read."""
        if not _obs.enabled:
            return
        for i, sup in enumerate(self.replicas):
            s = sup.load_stats()
            _obs.serving_router_replica(
                i, s["queued_total"], s["pool_occupancy"],
                s["degraded_level"])

    # ---- autoscaling ----
    def _spawn_replica(self) -> int:
        """Install one fresh decode replica: reuse a drained/dead husk
        slot first (replica INDICES are identity — the owner map and
        affinity bindings key on them, so the list must not shift),
        else append. The fresh supervisor shares the cluster host
        tier/clock like any construction-time replica."""
        for i in self._decode_idxs():
            sup = self.replicas[i]
            if sup.health == "dead" or sup._draining:
                self.replicas[i] = self._new_supervisor(i)
                self.router.drop_replica(i)
                return i
        self.replicas.append(self._new_supervisor(len(self.replicas)))
        return len(self.replicas) - 1

    def _autoscale_tick(self):
        """One closed-loop scaling decision (no-op without an
        :class:`ClusterAutoscaler`): feed the decode tier's backlog
        per serviceable replica + worst degraded rung through the
        hysteresis policy; ``up`` installs a fresh replica, ``down``
        retires the least-loaded one through the
        :meth:`retire_replica` drain path — its sessions rehome
        MID-DECODE with resume semantics, so scale-down loses and
        duplicates nothing (the soak gate). The tick itself is a
        best-effort control plane: a fault here (the
        ``autoscale_tick`` site) skips ONE decision and the next step
        re-evaluates from fresh signals — it must never take serving
        down with it."""
        if self.autoscaler is None:
            return
        try:
            fault_point("autoscale_tick")
        except Exception:
            self.autoscale_faults_total += 1
            return
        # one load_stats pass over the whole fleet (load_stats walks
        # every queued request since queued_tokens landed — the decode
        # subset is derived, not re-computed)
        every = self._alive(range(len(self.replicas)))
        alive = {i: s for i, s in every.items()
                 if i >= self.prefill_replicas}
        if not alive:
            return
        # pressure signal: the WHOLE cluster's undone work (router
        # queue + every serviceable replica's queues — a disaggregated
        # prefill replica's backlog is future decode work in disguise)
        # over the decode capacity the autoscaler actually controls
        backlog = (
            sum(1 for e in self._rq if not e["req"].done)
            + sum(s["queued_total"] + s["pending_prefills"]
                  for s in every.values()))
        per = backlog / len(alive)
        max_rung = max(s["degraded_level"] for s in every.values())
        action = self.autoscaler.decide(per, len(alive), max_rung)
        if action == "up":
            self._spawn_replica()
            _obs.serving_autoscale("up", len(alive) + 1, per)
        elif action == "down":
            # retire the healthiest/least-loaded replica: fewest live
            # sessions to rehome, and the survivors keep the hot tries
            victim = min(alive,
                         key=lambda i: self.router._score(alive[i])
                         + (i,))
            self.retire_replica(victim, replace=False)
            _obs.serving_autoscale("down", len(alive) - 1, per)

    # ---- prefill→decode handoff ----
    def _harvest_handoffs(self):
        """Move every decode-ready request off the prefill replicas:
        export the slot's live pages (pure read), import + journal them
        on a decode replica, then detach from the prefill side
        (slot-clear before page-release, so no fault can leave two
        engines decoding one request). A request that cannot place (no
        free decode slot / pool full) stays on its prefill replica and
        keeps decoding there — the handoff is opportunistic."""
        decode = self._alive(self._decode_idxs())
        if not decode:
            return
        for i in self._prefill_idxs():
            sup = self.replicas[i]
            if sup.health == "dead" or sup._draining:
                continue
            eng = sup.engine
            for req in list(eng.running_requests()):
                if (req.done or not req.tokens
                        or req.slot in eng._pending):
                    continue
                try:
                    self._handoff_one(sup, req, decode)
                except EngineDead:
                    self._failover(i)
                    break
                except Exception as exc:  # noqa: BLE001 — injected or
                    # real fault on the PREFILL side of the handoff
                    # (page release inside finish_handoff; decode-side
                    # faults are attributed inside _handoff_one): route
                    # it through the prefill supervisor's
                    # classify+recover machinery, same as a step fault.
                    # The request is safe: finish_handoff clears the
                    # slot before anything fallible, and the journal
                    # already moved to the decode side.
                    try:
                        sup._on_failure(exc)
                    except EngineDead:
                        self._failover(i)
                    # recovery REBUILT the engine: the remaining
                    # snapshot entries are no longer running there
                    # (they were requeued), so exporting them now
                    # would raise and masquerade as fresh failures —
                    # stop and let the next step re-harvest
                    break

    def _handoff_one(self, sup, req, decode_loads: Dict[int, Dict]):
        eng = sup.engine
        direct = self.direct_handoff
        t0 = _obs.generate_begin()
        # export-side fault site: fires before the pure
        # read — a fault here commits nothing and routes through the
        # PREFILL supervisor's recovery (the _harvest_handoffs catch)
        fault_point("handoff_export")
        src = getattr(sup, "replica_id", -1)
        tx = _obs.serving_trace_now()
        # pure host-side read; the direct path exports metadata only —
        # the page bytes move device-to-device inside the import
        payload = eng.export_prefilled(req, with_kv=not direct)
        if not direct and tamper_point("handoff_export"):
            # injected payload corruption: real bytes flip here, the
            # import-side CRC verifier must catch them before install
            payload["kv"] = _tampered_entry(payload["kv"])
        pages = eng.cache.pages_for(payload["length"])
        nbytes = (eng.cache.page_payload_bytes(pages) if direct else
                  sum(a.nbytes for a in payload["kv"]["arrays"].values()))
        _obs.serving_handoff_export(t0, nbytes, pages)
        _obs.serving_trace_span(req, "handoff_export", tx, replica=src,
                                slot=payload["slot"],
                                seq=len(req.tokens),
                                meta={"bytes": int(nbytes),
                                      "pages": int(pages)})
        placed = None
        for didx in sorted(decode_loads,
                           key=lambda d: self.router._score(
                               decode_loads[d]) + (d,)):
            dsup = self.replicas[didx]
            t1 = _obs.generate_begin()
            t1t = _obs.serving_trace_now()
            attempts = 0
            while True:
                try:
                    fault_point("handoff_import")
                    if run_with_deadline(
                            lambda: dsup.engine.import_prefilled(
                                req, payload,
                                src_engine=eng if direct else None),
                            self.handoff_timeout_s):
                        placed = didx
                        _obs.serving_handoff_import(t1)
                        _obs.serving_trace_span(
                            req, "handoff_import", t1t, replica=didx,
                            slot=(req.slot if req.slot is not None
                                  else -1),
                            seq=len(req.tokens),
                            meta={"src": int(src)})
                    break               # placed, or no free slot there
                except PoolExhausted:
                    break               # full pool: try the next replica
                except CorruptionDetected:
                    # the payload failed its checksum BEFORE install
                    # nothing was committed on the decode
                    # side, and the request is untouched on the
                    # PREFILL replica — it simply keeps decoding there,
                    # token-identically (the handoff is opportunistic).
                    # The corrupt payload dies with this attempt: it is
                    # never offered to another replica.
                    self.handoff_corruptions_total += 1
                    _obs.serving_integrity("handoff", "detected")
                    _obs.serving_integrity("handoff", "quarantined")
                    return
                except EngineDead:
                    self._failover(didx)
                    break
                except StepStalled as exc:
                    # a TIMED-OUT import is NOT retryable in place:
                    # the abandoned watchdog thread may still complete
                    # the original install, so a retry could run
                    # concurrently and double-install. Charge the
                    # replica a recovery instead — the rebuild fences
                    # the poisoned engine (slot tables cleared), so a
                    # late-completing import commits into a discarded
                    # engine, never a live one.
                    try:
                        dsup._on_failure(exc)
                    except EngineDead:
                        self._failover(didx)
                    break
                except Exception as exc:  # noqa: BLE001 — transient or
                    # real fault inside the DECODE-side import
                    # (allocator, scatter, injected). First the
                    # bounded idempotent retry (a failed import frees
                    # everything it allocated before re-raising, and
                    # journal ownership moves only at adopt_running —
                    # so a retry can never double-install pages or
                    # double-own recovery); past the budget it is that
                    # replica's failure: its supervisor pays the
                    # recovery and its circuit counts it — never the
                    # healthy prefill replica's.
                    attempts += 1
                    if attempts <= self.handoff_retries:
                        self.handoff_retries_total += 1
                        _obs.serving_integrity_retry("handoff_import")
                        self._retry_sleep(
                            min(0.2, 0.005 * 2 ** (attempts - 1)))
                        continue
                    try:
                        dsup._on_failure(exc)
                    except EngineDead:
                        self._failover(didx)
                    break
            if placed is not None:
                break
        if placed is None:
            return                      # keep decoding on the prefill side
        dsup = self.replicas[placed]
        dsup.adopt_running(req)
        self._owner[req.rid] = placed
        sup.journal.forget(req.rid)
        eng.finish_handoff(req, payload["slot"])
        self.handoffs_total += 1

    # ---- failover / rolling upgrade ----
    def _rehome(self, entries):
        """Re-dispatch journaled sessions from a dead/retiring replica:
        in-flight ones re-enter elsewhere with resume semantics (the
        resume replay — token-identical), never-admitted ones go back
        through the router queue as fresh work."""
        rehomed = 0
        for e in entries:
            req = e.req
            if req is None or (req.done
                               and req.finish_reason != "engine_dead"):
                continue
            req.done = False
            req.slot = None
            req.tokens = list(e.tokens)
            if e.admitted:
                req.preemptions = e.preemptions + 1
                req.finish_reason = FinishReason.PREEMPTED.value
                loads = self._alive(self._decode_idxs()) or self._alive(
                    range(len(self.replicas)))
                idx, _ = self.router.pick_replica(None, loads)
                _obs.serving_trace_mark(req, "rehome", replica=idx,
                                        seq=len(req.tokens))
                self.replicas[idx].submit_request(req)
                self.router.note_dispatch(idx, False)
                self._owner[req.rid] = idx
            else:
                req.finish_reason = None
                meta = self._meta.get(req.rid, {"tenant": "default",
                                                "cost": 0})
                self._rq.append({"req": req, "tenant": meta["tenant"],
                                 "cost": meta["cost"],
                                 "seq": self._seq})
                self._seq += 1
            rehomed += 1
        _obs.serving_router_failover(rehomed)
        return rehomed

    def _failover(self, idx: int):
        """A replica's circuit opened: rebuild it in place (fresh
        pools, empty trie — its affinity bindings drop) and rehome its
        journaled sessions onto the survivors. Requests the dying
        supervisor marked ``engine_dead`` un-finish and resume
        elsewhere — cluster-wide, nothing is lost."""
        dead = self.replicas[idx]
        self.failovers_total += 1
        entries = dead.journal.live_entries()
        if dead.wal is not None:
            # ownership moves with the rehome: tombstone every live
            # session in the DEAD replica's journal directory (and
            # fsync + close it) BEFORE the replacement adopts the dir —
            # a later cold recovery of this directory must not
            # resurrect sessions the survivors are already serving,
            # and two writers must never interleave frames in one file
            try:
                for e in entries:
                    dead.journal.forget(e.rid)
                dead.wal.commit(force=True)
            except Exception:
                pass    # best-effort: cold recovery dedupes by rid
            dead.wal.close()
        self.replicas[idx] = self._new_supervisor(idx)
        self.router.drop_replica(idx)
        self._rehome(entries)

    def retire_replica(self, idx: int, *, path: Optional[str] = None,
                       replace: bool = True) -> Dict:
        """Rolling drain/upgrade: drain replica ``idx`` through the
        supervisor's drain path (journal + prefix-trie checkpoint to one
        ``.npz``), requeue its live sessions onto other replicas
        MID-DECODE (resume semantics — they finish token-identically),
        and — with ``replace`` — install a fresh replica with the
        drained prefix trie restored, so the tenant's next prompt still
        prefix-HITs and the router's affinity bindings stay valid.
        Returns the drain summary."""
        if not replace:
            # count SERVICEABLE survivors, not list length — drained
            # husks stay in self.replicas, so repeated non-replace
            # retirements would otherwise drain the whole cluster
            # through this guard one replica at a time
            survivors = [i for i, s in enumerate(self.replicas)
                         if i != idx and s.health != "dead"
                         and not s._draining]
            if not survivors:
                raise ValueError(
                    "retire_replica(replace=False) would leave no "
                    "serviceable replica — nothing left to serve or "
                    "absorb the drained sessions")
        sup = self.replicas[idx]
        tmp = None
        if path is None:
            fd, tmp = tempfile.mkstemp(suffix=".npz",
                                       prefix="retire_replica_")
            os.close(fd)
            path = tmp
        try:
            summary = sup.drain(path)
            entries = sup.journal.live_entries()
            if replace:
                new = self._new_supervisor(idx)
                ckpt = load_drain_checkpoint(path)
                if ckpt["prefix"] is not None:
                    new.engine.cache.restore_prefix(ckpt["prefix"])
                self.replicas[idx] = new
            else:
                self.router.drop_replica(idx)
            summary["rehomed"] = self._rehome(entries)
            self.retirements_total += 1
            return summary
        finally:
            if tmp is not None and os.path.exists(tmp):
                os.unlink(tmp)

    # ---- whole-process cold recovery ----
    @classmethod
    def recover_from_disk(cls, engine_factory: Callable,
                          wal_dir: str, *, replicas: Optional[int] = None,
                          **kw) -> "ServingCluster":
        """Rebuild a cluster after WHOLE-PROCESS death from its
        per-replica journal directories: each ``replica<i>/`` WAL
        recovers into replica ``i``
        (:meth:`~paddle_tpu_torch.serving.EngineSupervisor.recover_from_disk`
        — torn tails truncated, checkpoints + log suffixes replayed),
        sessions that a crash caught MID-HANDOFF (adopted on the
        decode side, not yet tombstoned on the prefill side) dedupe by
        rid — the copy with more committed tokens wins, the loser is
        durably forgotten — and every recovered handle re-enters the
        cluster's owner map so :meth:`step`/:meth:`run` drive it to
        completion. Recovered handles live in ``.recovered``
        (rid → request)."""
        sub = sorted(d for d in (os.listdir(wal_dir)
                                 if os.path.isdir(wal_dir) else ())
                     if d.startswith("replica"))
        n = replicas if replicas is not None else max(len(sub), 1)
        cluster = cls(engine_factory, replicas=n, wal_dir=wal_dir,
                      _recover=True, **kw)
        cluster.recovered: Dict[int, object] = {}
        best: Dict[int, tuple] = {}     # rid -> (idx, req)
        for i, sup in enumerate(cluster.replicas):
            for rid, req in getattr(sup, "restored", {}).items():
                prev = best.get(rid)
                if prev is None:
                    best[rid] = (i, req)
                    continue
                # mid-handoff duplicate: keep the furthest-along copy
                # (the adopt side committed at least as many tokens);
                # the loser forgets durably so the NEXT cold recovery
                # of that directory is already clean
                keep_new = len(req.tokens) > len(prev[1].tokens)
                (lose_i, lose_req) = prev if keep_new else (i, req)
                if keep_new:
                    best[rid] = (i, req)
                loser = cluster.replicas[lose_i]
                loser.journal.forget(rid)
                loser.engine.cancel_request(lose_req, "superseded")
        for rid, (idx, req) in best.items():
            cluster._live[rid] = req
            cluster._owner[rid] = idx
            cluster._meta[rid] = {"tenant": "default",
                                  "cost": req.prompt.shape[1]
                                  + req.max_new_tokens}
            cluster.recovered[rid] = req
            cluster._next_rid = max(cluster._next_rid, rid + 1)
        return cluster

    # ---- introspection ----
    def stats(self) -> Dict:
        per = []
        for i, sup in enumerate(self.replicas):
            s = sup.load_stats()
            s["role"] = ("prefill" if i < self.prefill_replicas
                         else "decode")
            per.append(s)
        return {
            "replicas": len(self.replicas),
            "replicas_serviceable": len(
                self._alive(range(len(self.replicas)))),
            "prefill_replicas": self.prefill_replicas,
            "cluster_steps": self._steps,
            "router_queued": len(self._rq),
            "handoffs_total": self.handoffs_total,
            "handoff_retries_total": self.handoff_retries_total,
            "handoff_corruptions_total": self.handoff_corruptions_total,
            "autoscale_faults_total": self.autoscale_faults_total,
            "failovers_total": self.failovers_total,
            "retirements_total": self.retirements_total,
            "deadline_cancels_total": self.deadline_cancels_total,
            "router": self.router.stats(),
            "per_replica": per,
            **({"autoscaler": self.autoscaler.stats()}
               if self.autoscaler is not None else {}),
            **({"host_tier": self._host_store.stats()}
               if self._host_store is not None else {}),
        }
