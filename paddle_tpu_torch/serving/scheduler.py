"""SLO-aware serving scheduler: the control plane over the
continuous-batching engine.

Counterpart of ``paddle_tpu/serving/scheduler.py`` driving the port's
:class:`~paddle_tpu_torch.inference.ContinuousBatchingEngine` on one
device (design shape: Orca/vLLM-style schedulers on page-granular
preemption):

- **Priority queues** — requests carry a priority class
  (:class:`~.policy.Priority`; lower = more important) and admit
  strictly by class, FIFO within a class.
- **Token-budgeted step planning** — per step a
  :class:`~.policy.TokenBudgetPlanner` packs decode slots (1 token
  each) and prefill chunks (page-rounded widths) in priority order under
  ``token_budget``, bounding the work of every engine step; ready work
  the budget defers runs on later steps.
- **Preempt / resume over paged KV** — when a higher-priority admission
  cannot be satisfied, a :class:`~.policy.PreemptionPolicy` victim's
  pages go back to the pool (:meth:`~.paged_cache.PagedKVCache.
  evict_for_preempt`; pages shared with the prefix trie survive under
  the trie's references) and the victim requeues at the FRONT of its
  class. Resume replays ``prompt + tokens[:-1]`` through the
  continuation prefill and decodes on from the last sampled token,
  token-identical to an uninterrupted run. On an engine with the host
  tier (``host_tier=True``) the policy prefers victims whose pages swap
  out to host memory, and their resume is one scatter; the tokens of
  pages a swap-in writes are charged against the next steps' budgets
  at the prefill rate (the swap-in debt), so the budget stays a hard
  ceiling on each step's KV writes.
- **Deadlines** — a queued request whose ``deadline_s`` lapses before
  it produced a token is cancelled with ``deadline_exceeded``. A request
  admitted in time and later preempted already met it, so preempted
  requests resume instead.
- **Overlap** — with ``overlap=True`` each step plans step N+1 while
  step N's forwards run on the card, commits N at the one fence just
  before N+1's dispatch, and returns with N+1 in flight.
- **Grammar constraints** — ``submit(constraint=...)`` passes a DFA
  through to the engine's intake (an engine built with
  ``constraints=True``). The DFA state advances at the engine's commit,
  and an overlapped decode dispatch runs only after the previous
  step's commit (it reads the tokens that commit lands), so the mask it
  uploads is the one for the current state.
- **Adapters** — ``submit(adapter_id=...)`` passes the request's LoRA
  variant to the engine's intake. An admission whose adapter needs a
  slot when every slot is pinned defers
  (:class:`~.adapters.AdapterPoolExhausted` is a
  :class:`~.paged_cache.PoolExhausted`); it preempts only a
  strictly-lower-class victim that itself pins a slot, never a base
  row whose eviction frees none.

- **Observability and faults** — each step feeds the scheduler hooks
  (queue depths, budget use, the host share, time in queue, idle
  fences; :mod:`~paddle_tpu_torch.observability.hooks`) and opens with
  the ``sched_tick`` fault point (:mod:`.resilience`), which an
  :class:`~.resilience.EngineSupervisor` recovers from.

Left out until its step of ROADMAP.md's queue A: ``mesh=`` (7).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Dict, Optional

import numpy as np

from ..observability import hooks as _obs
from .adapters import AdapterPoolExhausted
from .paged_cache import PoolExhausted
from .policy import (FinishReason, PreemptionPolicy, Priority, StepPlan,
                     TokenBudgetPlanner)
from .resilience import DEGRADED_MODES, fault_point


class ServingScheduler:
    """Request-lifecycle scheduler between callers and a
    :class:`~paddle_tpu_torch.inference.ContinuousBatchingEngine`.

    The scheduler OWNS the engine: callers submit through
    :meth:`submit` (never ``engine.submit``) and drive :meth:`step` /
    :meth:`run`; the engine's own FIFO queue stays empty. ``clock`` is
    injectable (monotonic seconds) so deadline behaviour is testable.
    ``overlap=None`` inherits the engine's ``overlap``.
    """

    def __init__(self, engine, *, token_budget: Optional[int] = None,
                 enable_preemption: bool = True,
                 planner: Optional[TokenBudgetPlanner] = None,
                 preemption_policy: Optional[PreemptionPolicy] = None,
                 clock: Callable[[], float] = time.monotonic,
                 mesh=None, overlap: Optional[bool] = None):
        if mesh is not None:
            raise NotImplementedError(
                "ServingScheduler: mesh is not ported yet — see "
                "ROADMAP.md, queue A step 7")
        if not engine.idle:
            raise ValueError(
                "ServingScheduler requires a fresh engine: it owns "
                "admission, and requests already queued or running "
                "through the engine's FIFO path would bypass priority")
        self.engine = engine
        self.planner = planner or TokenBudgetPlanner(
            token_budget, engine.cache.page_size)
        self.preemption = (preemption_policy or PreemptionPolicy()
                           if enable_preemption else None)
        self.clock = clock
        self._queues: Dict[int, Deque] = {}
        self._drafts: Optional[Dict] = {}  # this step's proposals
        self.last_plan: Optional[StepPlan] = None
        self._steps = 0
        self.preemptions_total = 0
        self.resumes_total = 0
        self.deadline_cancels_total = 0
        self._swap_debt = 0     # host-tier swap-in tokens not yet charged
        #: the engine's degraded-mode rung, set by whoever owns the
        #: ladder; read by :meth:`load_stats`
        self.degraded_level = 0
        self.overlap = bool(getattr(engine, "overlap", False)
                            if overlap is None else overlap)
        # live requests that carry a deadline: 0 skips the expiry scan
        self._deadlines_live = 0
        #: committed units (tokens / slots) of the last step
        self.last_committed = 0
        #: share of the last step's wall time spent on host work the
        #: card did not hide (the overlapped pipeline hides the host
        #: phases that run while a step is in flight), and its EMA
        self.last_host_frac: Optional[float] = None
        self.host_frac_ema: Optional[float] = None
        self.idle_fences_total = 0

    # ---- identity ----
    @property
    def replica_id(self) -> int:
        """The replica id trace spans carry — one source of truth (the
        engine's), stamped by a supervisor; -1 = unplaced."""
        return getattr(self.engine, "replica_id", -1)

    @replica_id.setter
    def replica_id(self, value: int) -> None:
        self.engine.replica_id = int(value)

    # ---- intake ----
    def submit(self, prompt, max_new_tokens: int = 16, *,
               priority=Priority.NORMAL,
               deadline_s: Optional[float] = None, eos_token_id=None,
               adapter_id: int = 0, constraint=None):
        """Queue a prompt with a priority class and an optional deadline
        (seconds from now; a request that has produced no token when it
        lapses is cancelled with ``deadline_exceeded``). Returns the
        request handle (``.done`` / ``.tokens`` / ``.output`` /
        ``.finish_reason`` fill in as steps run). ``adapter_id`` and
        ``constraint`` pass through to the engine's ``create_request``."""
        req = self.engine.create_request(
            prompt, max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id, adapter_id=adapter_id,
            constraint=constraint)
        req.priority = int(priority)
        req.submitted_at = req.enqueued_at = self.clock()
        if deadline_s is not None:
            req.deadline_at = req.submitted_at + float(deadline_s)
            self._deadlines_live += 1
        # the trace is minted here and rides the handle from now on
        _obs.serving_trace_submit(req, replica=self.replica_id)
        _obs.serving_trace_enqueued(req)
        self._queues.setdefault(int(priority), deque()).append(req)
        return req

    def requeue(self, req, *, front: bool = False):
        """Re-enqueue an EXISTING request handle into its priority class
        (``front``: ahead of the class, as a preemption requeues) — the
        supervisor's recovery and restore path."""
        req.enqueued_at = self.clock()
        if req.submitted_at is None:
            req.submitted_at = req.enqueued_at
        if req.deadline_at is not None:
            self._deadlines_live += 1
        # attach is idempotent: a handle that already rides a trace keeps
        # it; a handle rebuilt from a checkpoint gets one here
        _obs.serving_trace_submit(req, replica=self.replica_id)
        _obs.serving_trace_enqueued(req)
        q = self._queues.setdefault(int(req.priority), deque())
        if front:
            q.appendleft(req)
        else:
            q.append(req)

    # ---- per-step phases ----
    def _expire_deadlines(self, now: float):
        """Cancel requests whose deadline lapsed before they produced a
        token: QUEUED ones (never admitted), and MID-PREFILL admissions
        before their next chunk is planned, which returns their reserved
        pages to the pool (pages shared with the prefix trie survive
        under its references). A request the scheduler admitted in time
        and then preempted (``preemptions > 0``) already met its SLO and
        simply resumes."""
        if not self._deadlines_live:
            return

        def expired(r):
            return (r.deadline_at is not None and now >= r.deadline_at
                    and r.preemptions == 0)
        for prio, q in self._queues.items():
            if not any(expired(r) for r in q):
                continue
            keep: Deque = deque()
            for req in q:
                if expired(req):
                    self.engine.cancel_request(
                        req, FinishReason.DEADLINE_EXCEEDED.value)
                    self.deadline_cancels_total += 1
                else:
                    keep.append(req)
            self._queues[prio] = keep
        for slot, (req, _rem) in list(
                self.engine.pending_prefills().items()):
            if expired(req) and not req.tokens:
                self.engine.cancel_request(
                    req, FinishReason.DEADLINE_EXCEEDED.value)
                self.deadline_cancels_total += 1

    def _preempt_for(self, req, candidates=None) -> bool:
        """Evict one strictly-lower-class running request to make room
        for ``req``; the victim requeues at the FRONT of its class (it
        already waited its turn once). Under the host tier the policy
        prefers victims whose eviction swaps to host memory.
        ``candidates`` restricts the victims (an adapter-slot shortfall:
        only a victim that pins a slot can relieve it). False when no
        victim exists."""
        if self.preemption is None:
            return False
        running = self.engine.running_requests()
        if candidates is not None:
            running = [r for r in running if r in candidates]
        victim = self.preemption.pick_victim(
            running, req.priority,
            swappable=getattr(self.engine, "swap_candidate", None))
        if victim is None:
            return False
        self.engine.preempt_request(victim)
        self.preemptions_total += 1
        victim.enqueued_at = self.clock()   # queue wait restarts here
        _obs.serving_trace_enqueued(victim)
        self._queues.setdefault(int(victim.priority),
                                deque()).appendleft(victim)
        return True

    def _preemption_feasible(self, req) -> bool:
        """Optimistic bound before evicting anyone for a pool shortfall:
        every usable page not pinned by an equal-or-higher-class table
        is reclaimable in principle. If even that cannot cover the
        request, preempting would cost each victim an eviction and a
        replay and the admission would still fail."""
        cache = self.engine.cache
        pinned = set()
        for r in self.engine.running_requests():
            if r.priority <= int(req.priority):
                pinned.update(cache.pages_held(r.slot))
        need = cache.pages_for(req.prompt.shape[1] + req.max_new_tokens)
        return need <= cache.allocator.num_usable - len(pinned)

    def _adapter_feasible(self, req) -> bool:
        """Can ``req``'s adapter be seated at all now? False when it
        needs a new slot, none is free or reclaimable, and no
        strictly-lower-class running request pins one: then every
        preemption would be pointless, and the admission defers with
        no victim."""
        pool = getattr(self.engine, "adapters", None)
        if not req.adapter_id or pool is None or pool.resident(
                req.adapter_id):
            return True                 # base row, or a pin in place
        if pool.slot_available():
            return True
        return any(r.adapter_id != 0 and int(r.priority) > int(req.priority)
                   for r in self.engine.running_requests())

    def _admit_one(self, req) -> bool:
        eng = self.engine
        while True:
            if not self._adapter_feasible(req):
                return False
            if not eng.cache.free_slots():
                # no slot: preempt only when the pool side can work out
                # too, else the victim pays for nothing
                if not (self._preemption_feasible(req)
                        and self._preempt_for(req)):
                    return False
                continue                # a slot is free now; retry
            try:
                return eng.admit_request(req)
            except AdapterPoolExhausted:
                # every adapter slot is pinned: page reclaim cannot help,
                # so only a lower-class victim that pins a slot is worth
                # evicting; with none, defer
                pinning = [r for r in eng.running_requests()
                           if r.adapter_id != 0]
                if not (pinning
                        and self._preempt_for(req, candidates=pinning)):
                    return False
            except PoolExhausted:
                # a slot is free but the pool can't cover the request:
                # evict a lower-class victim's pages and retry. Each
                # round removes one running request, so this ends.
                if not (self._preemption_feasible(req)
                        and self._preempt_for(req)):
                    return False

    def _admit(self, now: float):
        """Admit strictly by class (FIFO within a class). A blocked head
        of class blocks everything below it: admitting a smaller
        lower-class request around a starved higher-class one would be
        priority inversion by another name. ``now`` (the step's clock
        reading) dates each admission's time in queue."""
        for prio in sorted(self._queues):
            q = self._queues[prio]
            while q:
                req = q[0]
                if req.done:
                    # cancelled while queued: admitting would decode it
                    # and overwrite the cancellation
                    q.popleft()
                    continue
                if not self._admit_one(req):
                    return
                q.popleft()
                if req.preemptions > 0:
                    self.resumes_total += 1
                # time in queue since the LATEST enqueue; a victim
                # preempted and re-admitted within this pass waited 0
                _obs.serving_queue_wait(
                    max(0.0, now - req.enqueued_at), prio)

    def _plan(self, reserved: int = 0) -> StepPlan:
        eng = self.engine
        ready = eng.ready_mask()
        decode = [(r.priority, r.rid, r.slot)
                  for r in eng.running_requests() if ready[r.slot]]
        pending = [(req.priority, req.rid, slot, remaining)
                   for slot, (req, remaining)
                   in eng.pending_prefills().items()]
        # speculative engines draft at plan time so each row's verify
        # width (1 + drafts) is charged before anything runs. The
        # overlapped pipeline plans before the previous step commits,
        # when the history is not final: it charges the pessimistic
        # width (spec_plan_widths) and proposes after the commit,
        # trimmed to the allowance
        if getattr(eng, "spec", None) is None:
            self._drafts = {}
            widths = None
        elif self.overlap:
            self._drafts = None
            widths = eng.spec_plan_widths(ready) or None
        else:
            self._drafts = eng.propose_drafts(ready)
            widths = {s: d.size for s, d in self._drafts.items()} or None
        return self.planner.plan(decode, pending,
                                 chunk_cap=eng.prefill_chunk,
                                 spec_drafts=widths,
                                 reserved_tokens=reserved)

    def _trim_plan(self, plan: StepPlan) -> StepPlan:
        """Reconcile an overlapped plan with the commit that just
        landed: it was drawn against the state before that commit, so
        slots whose request finished, was preempted, or whose prefill
        completed are dropped. Trimming only removes work, so the
        budget the plan was packed under still holds."""
        eng = self.engine

        def alive(s):
            req = eng._slots[s]
            return (req is not None and not req.done
                    and s not in eng._pending)
        plan.decode_slots = [s for s in plan.decode_slots if alive(s)]
        if plan.spec_drafts:
            keep = set(plan.decode_slots)
            plan.spec_drafts = {s: k for s, k in plan.spec_drafts.items()
                                if s in keep}
        plan.prefills = [(s, c) for s, c in plan.prefills
                         if s in eng._pending]
        return plan

    def _mask(self, slots) -> np.ndarray:
        mask = np.zeros((self.engine.max_batch,), bool)
        mask[slots] = True
        return mask

    def _dispatch_plan(self, plan: StepPlan) -> None:
        """Launch the plan's forwards WITHOUT committing: prefill chunks
        first, then the masked decode or verify step. Speculative rows
        propose their real drafts here — after the commit, so the
        history is final — trimmed to the planner's allowance."""
        eng = self.engine
        for slot, cap in plan.prefills:
            eng.prefill_dispatch(slot, max_tokens=cap)
        if not plan.decode_slots:
            return
        mask = self._mask(plan.decode_slots)
        if plan.spec_drafts and getattr(eng, "spec", None) is not None:
            fresh = eng.propose_drafts(mask)
            eng.spec_dispatch(mask, {
                s: fresh[s][:k] for s, k in plan.spec_drafts.items()
                if s in fresh})
        else:
            eng.decode_dispatch(mask)

    def _execute_plan(self, plan: StepPlan) -> int:
        """The synchronous execution: each forward dispatches and
        commits in place (prefill chunks, then the masked decode or
        verify step). Returns committed units."""
        eng = self.engine
        n = 0
        for slot, cap in plan.prefills:
            eng.prefill_step(slot, max_tokens=cap)
            n += 1
        if plan.decode_slots:
            mask = self._mask(plan.decode_slots)
            if plan.spec_drafts:
                # the budgeted verify: proposals trimmed to the
                # planner's allowance (a row the budget degraded to
                # plain decode rides along with zero drafts)
                n += eng.spec_step(mask, {
                    s: self._drafts[s][:k]
                    for s, k in plan.spec_drafts.items()})
            else:
                n += eng.decode_step(mask)
        return n

    def step(self) -> bool:
        """One scheduler step: expire deadlines, admit (preempting if
        needed), plan under the token budget, then execute. With
        ``overlap=False`` execution is the synchronous chain (prefill
        chunks, then the masked decode step, each committed in place).
        With ``overlap=True`` the host phases above run while the
        PREVIOUS step is still in flight on the card; that step commits
        only when its result is needed (just before this step's
        dispatch), the plan is trimmed against what the commit changed,
        and this step's forwards dispatch and are left in flight.
        Returns False when no work remains (the overlapped path drains
        its last step first). ``last_plan`` holds the step's
        :class:`~.policy.StepPlan`."""
        fault_point("sched_tick")
        eng = self.engine
        if eng.queued_requests():
            raise ValueError(
                "requests were queued through engine.submit() after "
                "the scheduler attached — submit through "
                "ServingScheduler.submit so priority admission is "
                "not bypassed")
        t_wall0 = time.perf_counter_ns()
        # host work done while a step is in flight is hidden; with the
        # card idle it is exposed (all of the synchronous path's)
        hidden = self.overlap and eng.has_inflight()
        eng.take_fence_ns()                 # reset the device-wait tally
        now = self.clock()
        self._expire_deadlines(now)
        self._admit(now)
        # swap-ins during _admit already wrote KV this step: charge them
        # at the prefill rate (page_size tokens a page). A swap-in larger
        # than the budget carries over as debt into later steps'
        # reserves, so every step's planned + reserved stays under it
        consume = getattr(eng.cache, "consume_swap_charge", None)
        if consume is not None:
            self._swap_debt += consume()
        budget = self.planner.token_budget
        reserved = (min(self._swap_debt, budget) if budget
                    else self._swap_debt)
        self._swap_debt -= reserved
        plan = self._plan(reserved)
        t_planned = time.perf_counter_ns()
        if self.overlap:
            # the one commit fence: step N's tokens seed N+1's inputs
            committed = eng.commit_inflight()
            plan = self._trim_plan(plan)
            self._dispatch_plan(plan)
        else:
            committed = self._execute_plan(plan)
        self.last_plan = plan
        self.last_committed = committed
        self._steps += 1
        t_end = time.perf_counter_ns()
        wall = max(1, t_end - t_wall0)
        exposed = max(0, (t_end - t_wall0) - eng.take_fence_ns()
                      - ((t_planned - t_wall0) if hidden else 0))
        frac = min(1.0, exposed / wall)
        self.last_host_frac = frac
        self.host_frac_ema = (frac if self.host_frac_ema is None
                              else 0.9 * self.host_frac_ema + 0.1 * frac)
        _obs.serving_sched_step(
            {p: len(q) for p, q in self._queues.items()},
            plan.scheduled_tokens + plan.reserved_tokens, plan.budget)
        _obs.serving_overlap_step(exposed, wall, committed, self.overlap)
        return (any(self._queues.values()) or not eng.idle
                or eng.has_inflight())

    def _idle_fence(self) -> None:
        """A step that planned and committed nothing means every
        remaining obligation waits on the card: commit what is in flight
        (the blocked work becomes plannable next step) instead of
        re-planning empty steps, else fence the pending non-blocking
        swap-outs, else yield the thread."""
        eng = self.engine
        self.idle_fences_total += 1
        fenced = False
        if eng.has_inflight():
            self.last_committed = eng.commit_inflight()
            fenced = True
        else:
            fence = getattr(eng.cache, "fence_swaps", None)
            if fence is not None and fence():
                fenced = True
            else:
                time.sleep(0)
        _obs.serving_sched_idle(fenced)

    def run(self) -> None:
        """Drive steps until every submitted request finished (or was
        cancelled by its deadline). A step that planned zero tokens and
        committed nothing fences or yields (:meth:`_idle_fence`)."""
        while self.step():
            plan = self.last_plan
            if (plan is not None and plan.scheduled_tokens == 0
                    and plan.reserved_tokens == 0
                    and self.last_committed == 0):
                self._idle_fence()

    def flush(self) -> int:
        """Commit any in-flight work now (the overlapped path's fence
        for callers that read ``req.tokens`` between steps). No-op on
        the synchronous path."""
        return self.engine.commit_inflight()

    def load_stats(self) -> Dict:
        """One load and health snapshot for a router: per-class queue
        depths, the tightest queued deadline's slack, backlog and
        in-flight tokens, slot and page occupancy and the degraded-mode
        rung. Host bookkeeping only (no device sync)."""
        now = self.clock()
        eng = self.engine
        alloc = eng.cache.allocator
        depths = {int(p): len(q) for p, q in self._queues.items() if q}
        slack = None
        queued_tokens = 0
        for q in self._queues.values():
            for r in q:
                if not r.done:
                    queued_tokens += (r.prompt.shape[1] + r.max_new_tokens
                                      - len(r.tokens))
                if r.deadline_at is not None and not r.done:
                    s = r.deadline_at - now
                    slack = s if slack is None else min(slack, s)
        inflight_tokens = int(sum(
            r.max_new_tokens - len(r.tokens)
            for r in eng.running_requests() if not r.done))
        level = self.degraded_level
        s = {
            "queue_depths": depths,
            "queued_total": sum(depths.values()),
            "queued_tokens": int(queued_tokens),
            "inflight_tokens": inflight_tokens,
            "running": len(eng.running_requests()),
            "pending_prefills": len(eng.pending_prefills()),
            "free_slots": len(eng.cache.free_slots()),
            "oldest_deadline_slack_s": slack,
            "pool_occupancy": alloc.utilization(),
            "pool_free_pages": alloc.num_free,
            "degraded_level": level,
            "degraded_mode": (DEGRADED_MODES[level]
                              if level < len(DEGRADED_MODES) else "dead"),
        }
        host = getattr(eng.cache, "host", None)
        if host is not None:
            # the host tier's residency is part of the load picture
            s["host_pool_pages"] = host.pages_resident
            s["host_pool_bytes"] = host.bytes_resident
        pool = getattr(eng, "adapters", None)
        if pool is not None:
            # slot headroom and residency: a router's adapter-affinity
            # signal (a replica holding a tenant's adapter serves it
            # with no load or promote)
            s["adapter_slots_free"] = pool.slots - pool.used_slots
            s["adapter_slots_used"] = pool.used_slots
        return s

    def stats(self) -> Dict:
        s = self.engine.stats()
        s["sched_steps"] = self._steps
        s["sched_queued"] = {int(p): len(q)
                             for p, q in self._queues.items() if q}
        s["preemptions_total"] = self.preemptions_total
        s["resumes_total"] = self.resumes_total
        s["deadline_cancels_total"] = self.deadline_cancels_total
        s["overlap"] = self.overlap
        s["idle_fences_total"] = self.idle_fences_total
        if self.host_frac_ema is not None:
            s["host_overhead_fraction"] = round(self.host_frac_ema, 4)
        if self.last_plan is not None:
            s["last_step_tokens"] = self.last_plan.scheduled_tokens
            s["token_budget"] = self.last_plan.budget
        return s
