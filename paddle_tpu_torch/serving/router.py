"""Cluster routing policy: prefix affinity, load- and SLO-aware
placement, per-tenant fair share and rate limits.

The port's counterpart of ``paddle_tpu/serving/router.py``, the same
policy line for line: pure host code, consumed by
:class:`~paddle_tpu_torch.serving.cluster.ServingCluster`. The router's
only view of a replica is the
:meth:`~paddle_tpu_torch.serving.ServingScheduler.load_stats` snapshot
the cluster hands it (queue depths, pool occupancy, degraded-mode
rung); it reads signals and never touches engine state.

- **Prefix affinity** — the dispatch key is the prompt's leading
  FULL pages (page-aligned, exactly the span the
  :class:`~paddle_tpu_torch.serving.PrefixCache` trie can hold), hashed
  as raw int32 token bytes. The first dispatch of a key binds it to the
  chosen replica; later requests with the same system prompt follow the
  binding to the replica whose trie already holds their prefix KV
  (admission maps the shared pages instead of prefilling them again).
  Unbound keys fall back to least-loaded placement.
- **Load- and SLO-aware placement** — replicas order by ``(degraded
  rung, backlog, pool occupancy)``; the healthiest wins. Affinity
  outranks load (prefix locality is worth a longer queue; the
  cluster's shed-and-retry path is the safety net when a bound replica
  degrades all the way to ``shed_low``), but never a dead or draining
  replica.
- **Fair share** — a per-tenant token account (prompt plus budgeted
  new tokens, charged at dispatch). The cluster dispatches its queue in
  ascending-account order, which bounds starvation: a light tenant's
  request outranks every queued request of any tenant that has already
  consumed more tokens, however many the heavy tenant submitted first.
- **Rate limits** — an optional per-tenant :class:`TenantQuota`
  (tokens per fixed window); an over-quota submission finishes
  ``rejected_ratelimit`` without touching any replica.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..observability import hooks as _obs


class TenantQuota:
    """Token budget per tenant per FIXED window (anchored at the
    tenant's first charge, reset once ``window_s`` elapses — so a
    worst-case boundary burst can reach 2x the quota inside one
    wall-clock window, the standard fixed-window trade): a submission
    costs ``prompt tokens + max_new_tokens`` (the pages it could pin),
    and a window's spend above ``tokens_per_window`` rejects further
    submissions until the window rolls."""

    def __init__(self, tokens_per_window: int, window_s: float = 60.0):
        if tokens_per_window < 1:
            raise ValueError(
                f"TenantQuota: tokens_per_window={tokens_per_window} "
                f"must be >= 1")
        self.tokens_per_window = int(tokens_per_window)
        self.window_s = float(window_s)


class AdmissionController:
    """SLO-guarded admission at the cluster door: a
    deadline-bearing submission whose deadline is INFEASIBLE against
    the cluster's current backlog rejects immediately with the
    structured ``rejected_infeasible`` finish reason — shed BEFORE any
    replica queues, prefills, or degrades for a request that could
    never meet its SLO (the door is cheaper than the degraded-mode
    ladder, which only sheds after replicas are already hurting).

    The feasibility model is deliberately simple and injectable:
    estimated TTFT = (least-loaded replica's backlog tokens + the
    request's own prompt) / ``tokens_per_s``, scaled by ``safety``.
    ``tokens_per_s`` is the operator's service-rate estimate (the
    bench's decode tokens/s is the natural source); an estimate of 0
    or None disables the backlog term and only rejects
    already-lapsed deadlines."""

    def __init__(self, tokens_per_s: Optional[float] = None, *,
                 safety: float = 1.0, min_slack_s: float = 0.0):
        self.tokens_per_s = (float(tokens_per_s)
                             if tokens_per_s else None)
        self.safety = float(safety)
        self.min_slack_s = float(min_slack_s)

    def feasible(self, deadline_s: Optional[float],
                 prompt_tokens: int, loads) -> bool:
        """``loads``: the serviceable replicas' ``load_stats``
        snapshots. Deadline-less requests always pass; so does an
        empty cluster view (the dispatch path owns that failure)."""
        if deadline_s is None:
            return True
        if deadline_s <= 0:
            return False
        loads = list(loads)
        if not loads or self.tokens_per_s is None:
            return True
        backlog = min(
            s.get("queued_tokens", 0) + s.get("inflight_tokens", 0)
            for s in loads)
        est_ttft = (self.safety * (backlog + int(prompt_tokens))
                    / self.tokens_per_s)
        return deadline_s >= est_ttft + self.min_slack_s


class ClusterRouter:
    """Placement + accounting policy for a :class:`ServingCluster`.

    ``page_size`` aligns affinity keys with the replicas' prefix tries;
    ``affinity_pages`` caps how many leading full pages feed the key
    (system prompts longer than the cap still share — the key is a
    routing hint, the trie matches the full span). ``quotas`` maps
    tenant name -> :class:`TenantQuota`; absent tenants are unlimited.
    ``clock`` is injectable (monotonic seconds) so windows are
    testable.

    ``retry_budget`` / ``tenant_retry_cap``: a
    request a degraded replica sheds re-dispatches up to
    ``retry_budget`` times (was: exactly once), but a tenant's total
    retries may never exceed ``tenant_retry_cap`` x its dispatches —
    one degraded replica must not turn a single tenant's burst into a
    cluster-wide retry storm. Exhaustion (budget or cap ran out before
    a replica accepted) is counted separately from first-try
    rejection (``retry_exhausted_total``)."""

    def __init__(self, page_size: int, *, affinity_pages: int = 2,
                 max_bindings: int = 65536,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 retry_budget: int = 2,
                 tenant_retry_cap: float = 0.5):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if retry_budget < 0:
            raise ValueError(
                f"retry_budget={retry_budget} must be >= 0")
        if tenant_retry_cap <= 0:
            raise ValueError(
                f"tenant_retry_cap={tenant_retry_cap} must be > 0")
        self.page_size = page_size
        self.affinity_pages = max(1, int(affinity_pages))
        self.max_bindings = max(1, int(max_bindings))
        self.quotas = dict(quotas or {})
        self.clock = clock
        self.retry_budget = int(retry_budget)
        self.tenant_retry_cap = float(tenant_retry_cap)
        # LRU-bounded (dict insertion order = recency; hits re-insert):
        # mostly-unique prompts would otherwise bind one entry per
        # request forever — the same leak class _prune_finished and
        # journal.sync exist to prevent. An evicted binding costs one
        # affinity miss on the tenant's next request, nothing more.
        self._affinity: Dict[bytes, int] = {}
        self._windows: Dict[str, Tuple[float, int]] = {}
        #: tenant -> tokens dispatched (the fair-share deficit counter)
        self.accounts: Dict[str, int] = {}
        self.dispatch_by_replica: Dict[int, int] = {}
        self.dispatch_by_tenant: Dict[str, int] = {}
        self.retries_by_tenant: Dict[str, int] = {}
        self.dispatches_total = 0
        self.affinity_hits = 0
        self.affinity_misses = 0
        self.adapter_affinity_hits = 0
        self.adapter_affinity_misses = 0
        self.retries_total = 0
        self.retry_exhausted_total = 0
        self.ratelimited_total = 0
        self.slo_rejected_total = 0

    # ---- prefix affinity ----
    def affinity_key(self, prompt) -> Optional[bytes]:
        """The prompt's prefix-trie-aligned dispatch key: its leading
        full pages' raw token bytes (capped at ``affinity_pages``).
        None for prompts shorter than one page — nothing the trie
        could share."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        k = min(prompt.size // self.page_size, self.affinity_pages)
        if k < 1:
            return None
        return prompt[:k * self.page_size].tobytes()

    @staticmethod
    def adapter_key(adapter_id) -> Optional[bytes]:
        """The adapter-affinity dispatch key: requests of
        the same LoRA variant bind to the replica whose pool already
        holds its slot — a repeat dispatch costs zero adapter
        load/promote bytes, the slot-residency sibling of prefix
        affinity. None for the base model (every replica serves it for
        free). The ``adapter:/`` namespace keeps these keys disjoint
        from prompt-prefix keys in practice: a prefix key is a raw
        little-endian int32 token record whose every 4th byte is a
        token's high byte — zero at real vocab sizes, never ASCII."""
        aid = int(adapter_id)
        if aid == 0:
            return None
        return b"adapter:/" + str(aid).encode()

    def drop_replica(self, idx: int) -> int:
        """Forget every affinity binding to ``idx`` (its trie died with
        it — a dead replica's bindings would keep routing a tenant to
        guaranteed prefix misses). Returns bindings dropped. A RETIRED
        replica whose trie was restored into its replacement keeps its
        bindings instead."""
        dead = [k for k, v in self._affinity.items() if v == idx]
        for k in dead:
            del self._affinity[k]
        return len(dead)

    # ---- placement ----
    @staticmethod
    def _score(load: Dict) -> Tuple:
        """Health-then-load ordering: degraded rung first (a shedding
        replica is worse than a long queue), then total backlog, then
        pool occupancy."""
        return (load.get("degraded_level", 0),
                load.get("queued_total", 0) + load.get("running", 0)
                + load.get("pending_prefills", 0),
                load.get("pool_occupancy", 0.0))

    def pick_replica(self, key: Optional[bytes], loads: Dict[int, Dict],
                     exclude: Sequence[int] = (),
                     adapter_key: Optional[bytes] = None
                     ) -> Tuple[int, bool]:
        """Choose a replica from ``loads`` (idx -> load_stats snapshot
        of the ALIVE candidates): the affinity binding for ``key`` when
        it points at a candidate, else — for an adapter request — the
        binding for ``adapter_key`` (the replica whose pool
        already holds the LoRA slot), else the healthiest/least-loaded
        (which then becomes the binding for BOTH keys). Prefix affinity
        outranks adapter affinity: a prefix hit saves ``O(prefix
        tokens)`` of prefill, an adapter hit one ``O(rank·hidden)``
        factor load. Returns ``(idx, affinity_hit)`` — the flag counts
        prefix hits only; adapter hits have their own counters."""
        cands = {i: s for i, s in loads.items() if i not in set(exclude)}
        if not cands:
            raise ValueError("pick_replica: no eligible replicas")
        if key is not None:
            bound = self._affinity.get(key)
            if bound in cands:
                del self._affinity[key]         # LRU touch: move to
                self._affinity[key] = bound     # the recent end
                self.affinity_hits += 1
                if adapter_key is not None:
                    self._bind(adapter_key, bound)
                return bound, True
        if adapter_key is not None:
            bound = self._affinity.get(adapter_key)
            if bound in cands:
                del self._affinity[adapter_key]
                self._affinity[adapter_key] = bound
                self.adapter_affinity_hits += 1
                if key is not None:
                    self._bind(key, bound)
                return bound, False
        idx = min(cands, key=lambda i: self._score(cands[i]) + (i,))
        if key is not None:
            self._bind(key, idx)
            self.affinity_misses += 1
        if adapter_key is not None:
            self._bind(adapter_key, idx)
            self.adapter_affinity_misses += 1
        return idx, False

    def _bind(self, key: bytes, idx: int) -> None:
        """(Re)bind ``key`` to ``idx`` under the LRU bound."""
        self._affinity.pop(key, None)
        while len(self._affinity) >= self.max_bindings:
            self._affinity.pop(next(iter(self._affinity)))
        self._affinity[key] = idx

    # ---- accounting ----
    def admit_rate_limit(self, tenant: str, cost: int) -> bool:
        """Charge ``cost`` tokens against ``tenant``'s quota window;
        False (and nothing charged) when it would overflow. Unlimited
        tenants always pass."""
        quota = self.quotas.get(tenant)
        if quota is None:
            return True
        now = self.clock()
        start, spent = self._windows.get(tenant, (now, 0))
        if now - start >= quota.window_s:
            start, spent = now, 0
        if spent + cost > quota.tokens_per_window:
            self._windows[tenant] = (start, spent)
            return False
        self._windows[tenant] = (start, spent + cost)
        return True

    def charge(self, tenant: str, cost: int):
        """Debit the fair-share account once a replica ACCEPTS the
        dispatch (shed work is never charged). The cluster dispatches
        per-tenant FIFO queues in ascending-account order — that
        ordering is the fairness mechanism; priority classes stay the
        REPLICA scheduler's job (the router's fairness is across
        tenants, not within one)."""
        self.accounts[tenant] = self.accounts.get(tenant, 0) + int(cost)

    # ---- shed-work retry accounting ----
    def may_retry(self, tenant: str, attempts: int) -> bool:
        """True when a shed dispatch may re-dispatch: the request has
        per-request budget left AND the tenant's aggregate retry rate
        (retries / dispatches) stays under the cap — the bound that
        stops one degraded replica amplifying one tenant's traffic
        into a retry storm."""
        if attempts >= self.retry_budget:
            return False
        d = max(1, self.dispatch_by_tenant.get(tenant, 0))
        r = self.retries_by_tenant.get(tenant, 0)
        return r < max(1.0, self.tenant_retry_cap * d)

    # ---- telemetry (the serving_router_* hook family) ----
    def note_dispatch(self, replica: int, affinity_hit: bool,
                      tenant: Optional[str] = None):
        self.dispatches_total += 1
        self.dispatch_by_replica[replica] = \
            self.dispatch_by_replica.get(replica, 0) + 1
        if tenant is not None:
            self.dispatch_by_tenant[tenant] = \
                self.dispatch_by_tenant.get(tenant, 0) + 1
        _obs.serving_router_dispatch(replica, affinity_hit)

    def note_retry(self, tenant: Optional[str] = None):
        self.retries_total += 1
        if tenant is not None:
            self.retries_by_tenant[tenant] = \
                self.retries_by_tenant.get(tenant, 0) + 1
        _obs.serving_router_retry(1)

    def note_retry_exhausted(self):
        self.retry_exhausted_total += 1
        _obs.serving_router_retry_exhausted()

    def note_ratelimited(self, tenant: str):
        self.ratelimited_total += 1
        _obs.serving_router_ratelimited(tenant)

    def note_slo_rejected(self, tenant: str):
        self.slo_rejected_total += 1
        _obs.serving_slo_rejected(tenant)

    def stats(self) -> Dict:
        total = self.affinity_hits + self.affinity_misses
        return {
            "dispatches_total": self.dispatches_total,
            "dispatch_by_replica": dict(self.dispatch_by_replica),
            "affinity_hits": self.affinity_hits,
            "affinity_misses": self.affinity_misses,
            "affinity_hit_rate": (self.affinity_hits / total
                                  if total else 0.0),
            "affinity_bindings": len(self._affinity),
            "adapter_affinity_hits": self.adapter_affinity_hits,
            "adapter_affinity_misses": self.adapter_affinity_misses,
            "retries_total": self.retries_total,
            "retry_exhausted_total": self.retry_exhausted_total,
            "ratelimited_total": self.ratelimited_total,
            "slo_rejected_total": self.slo_rejected_total,
            "tenant_accounts": dict(self.accounts),
        }
