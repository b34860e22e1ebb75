"""Scheduling policy for the SLO-aware serving scheduler.

The port's own copy of ``paddle_tpu/serving/policy.py``: pure host-side
policy objects (no torch, no device state) consumed by
:class:`~.scheduler.ServingScheduler`:

- :class:`Priority`: the request priority classes (lower value = more
  important; plain ints are accepted anywhere a Priority is).
- :class:`FinishReason`: the structured per-request finish reasons the
  engine reports (``eos`` / ``max_len`` on completion, the transient
  ``preempted`` while a request sits evicted awaiting resume, and
  ``deadline_exceeded`` when the scheduler cancels a request whose SLO
  already lapsed).
- :class:`StepPlan` / :class:`TokenBudgetPlanner`: the per-step
  token-budget packing — how many decode slots advance and how many
  prefill-chunk tokens forward this step, bounding step latency.
- :class:`PreemptionPolicy`: victim selection when a higher-priority
  admission cannot be satisfied from the free list.

Design shape: Orca/vLLM-style continuous-batching scheduling on
page-granular preemption.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple


class Priority(enum.IntEnum):
    """Request priority classes; LOWER value = MORE important (class 0
    preempts class 1 preempts class 2). Any int is accepted where a
    Priority is expected — the named classes are the common tiers."""
    HIGH = 0
    NORMAL = 1
    LOW = 2


class FinishReason(str, enum.Enum):
    """Structured per-request finish reasons (``str``-valued, so
    ``req.finish_reason == "eos"`` keeps working for callers that
    compare against plain strings)."""
    EOS = "eos"                               # hit the eos token
    MAX_LEN = "max_len"                       # exhausted max_new_tokens
    PREEMPTED = "preempted"                   # transient: evicted, will resume
    DEADLINE_EXCEEDED = "deadline_exceeded"   # cancelled before its first token
    REJECTED_OVERLOAD = "rejected_overload"   # shed by a degraded supervisor
    REJECTED_RATELIMIT = "rejected_ratelimit" # over the tenant's token quota
    REJECTED_INFEASIBLE = "rejected_infeasible" # deadline unmeetable at the door
    REPLICA_UNREACHABLE = "replica_unreachable" # transport-level loss

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


@dataclasses.dataclass
class StepPlan:
    """One engine step's work, as the planner budgeted it.

    ``decode_slots``: slot ids that advance one decode token (cost: one
    token each). ``spec_drafts``: ``slot -> draft count`` for decode
    slots whose advance is a SPECULATIVE verify this step — each draft
    costs one extra token on top of the slot's base decode token (a
    k-draft verify forwards ``1 + k`` positions and can commit up to
    ``1 + k`` tokens), and the planner trims drafts to the budget tail
    rather than deferring the whole row. Under TREE speculation the
    count is the tree's NODE count (a (width, depth) tree verifies
    ``1 + width*depth`` positions in one forward and is charged
    identically); a budget trim reaches the engine as a leading slice
    of the node array, whose chain-first ordering drops sibling leaves
    and chain tail first — the root path survives, so a tight budget
    narrows the tree instead of breaking it. ``prefills``: ``(slot,
    token_cap)`` pairs — each named pending admission forwards at most
    ``token_cap`` prompt tokens of chunked prefill this step
    (page-multiple caps; the engine takes ``min(cap, remaining,
    prefill_chunk)``). ``deferred_decodes`` counts ready slots the
    budget pushed to a later step — the observable fairness cost of a
    tight budget. ``reserved_tokens`` is the debit already spent BEFORE
    planning: the planner packs into ``budget - reserved_tokens``, so
    the configured budget stays a hard per-step ceiling."""
    decode_slots: List[int] = dataclasses.field(default_factory=list)
    prefills: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    budget: Optional[int] = None
    deferred_decodes: int = 0
    spec_drafts: Dict[int, int] = dataclasses.field(default_factory=dict)
    reserved_tokens: int = 0

    @property
    def scheduled_tokens(self) -> int:
        """The step's token debit: one per decode slot + that slot's
        budgeted draft tokens + every prefill cap — the quantity the
        budget bounds."""
        return (len(self.decode_slots) + sum(self.spec_drafts.values())
                + sum(c for _, c in self.prefills))


class TokenBudgetPlanner:
    """Greedy priority-ordered packing of one step under a token budget.

    Work items are unified: a ready decode slot costs ONE token, a
    pending prefill chunk costs its page-rounded width. Items are taken
    in ``(priority, rid)`` order — so a HIGH-priority admission's
    prefill outranks a LOW-priority decode, and within a class age wins
    (FIFO). A prefill is taken only when at least one whole page of
    budget remains (its width is floored to a page multiple, so the
    budget is a hard ceiling, never rounded through); a decode costs 1
    and can always use the tail of the budget.

    ``token_budget=None`` disables budgeting: every ready slot decodes
    and the single highest-priority pending admission advances one
    chunk (the engine's native one-chunk-per-step latency bound).
    """

    def __init__(self, token_budget: Optional[int], page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if token_budget is not None and token_budget < page_size:
            # a budget below one page can never schedule a prefill
            # chunk: a queue holding only pending prefills would spin
            # forever. Reject at construction, loudly.
            raise ValueError(
                f"token_budget={token_budget} is smaller than one "
                f"{page_size}-token page — chunked prefill could never "
                f"be scheduled and pending admissions would starve")
        self.token_budget = token_budget
        self.page_size = page_size

    def plan(self, decode_ready: Sequence[Tuple[int, int, int]],
             pending: Sequence[Tuple[int, int, int, int]],
             chunk_cap: Optional[int] = None,
             spec_drafts: Optional[Dict[int, int]] = None,
             reserved_tokens: int = 0,
             dp_group: Optional[Dict[int, int]] = None) -> StepPlan:
        """Build one step's :class:`StepPlan`.

        decode_ready: ``(priority, rid, slot)`` per decodable slot
        pending:      ``(priority, rid, slot, remaining_tokens)`` per
                      mid-prefill admission
        chunk_cap:    the engine's ``prefill_chunk`` (already
                      page-rounded) or None
        spec_drafts:  ``slot -> proposed draft count`` for decode slots
                      the engine wants to advance via speculative
                      verify — a k-draft verify is charged ``1 + k``
                      tokens (tree speculation proposes its NODE
                      count: same charge, same trim). Drafts are
                      TRIMMED to the remaining budget (the base decode
                      token is taken first, drafts only fill what is
                      left), so the ceiling stays hard and a tight
                      budget degrades a row to plain decode instead of
                      deferring it.
        reserved_tokens: tokens of budget already spent before the
                      plan; the plan packs into the remainder, keeping
                      the budget a hard per-step ceiling. With no
                      budget configured the reserve is recorded but
                      unused.
        dp_group:     ``slot -> dp shard row-block`` on a 2-D serving
                      mesh. The step's wall time is the max over dp
                      shards, so a budget that truncates the decode set
                      must spread the taken rows ACROSS shards: within
                      each priority class the decode items are re-keyed
                      so the sorted merge visits them round-robin
                      across dp groups (FIFO within a group). The
                      (priority, rid) key multiset is unchanged, so
                      fairness against prefills and the hard budget
                      ceiling are untouched. The port's engine runs on
                      one device and passes None.
        """
        page = self.page_size
        spec = spec_drafts or {}
        if self.token_budget is None:
            plan = StepPlan([s for _, _, s in
                             sorted(decode_ready)], [], None)
            plan.reserved_tokens = int(reserved_tokens)
            plan.spec_drafts = {s: int(k) for s, k in spec.items()
                                if s in plan.decode_slots and k > 0}
            if pending:
                _, _, slot, remaining = min(pending)
                width = -(-remaining // page) * page
                if chunk_cap is not None:
                    width = min(width, chunk_cap)
                plan.prefills.append((slot, width))
            return plan
        left = max(0, self.token_budget - int(reserved_tokens))
        plan = StepPlan(budget=self.token_budget,
                        reserved_tokens=int(reserved_tokens))
        items = [(p, rid, "decode", slot, 1 + int(spec.get(slot, 0)))
                 for p, rid, slot in decode_ready]
        if dp_group:
            items = self._balance_dp(items, dp_group)
        for p, rid, slot, remaining in pending:
            width = -(-remaining // page) * page
            if chunk_cap is not None:
                width = min(width, chunk_cap)
            items.append((p, rid, "prefill", slot, width))
        for p, rid, kind, slot, cost in sorted(
                items, key=lambda it: (it[0], it[1])):
            if kind == "decode":
                if left >= 1:
                    plan.decode_slots.append(slot)
                    take = min(cost - 1, left - 1)   # drafts: budget tail
                    if take > 0:
                        plan.spec_drafts[slot] = take
                    left -= 1 + max(0, take)
                else:
                    plan.deferred_decodes += 1
            else:
                afford = (left // page) * page
                if afford >= page:
                    take = min(cost, afford)
                    plan.prefills.append((slot, take))
                    left -= take
        return plan

    @staticmethod
    def _balance_dp(decode_items, dp_group):
        """Re-key decode items for a 2-D mesh (see :meth:`plan`):
        within each priority class, hand the class's sorted rid keys
        out to the items in round-robin-across-dp-group order (FIFO
        within a group). The (priority, rid) multiset — and therefore
        every decode-vs-prefill merge decision and the budget math — is
        exactly what it was; only WHICH decode row a truncation drops
        changes, from "the youngest rids" to "the youngest rid of the
        most-loaded shard, repeatedly"."""
        out = []
        by_p: Dict[int, list] = {}
        for it in decode_items:
            by_p.setdefault(it[0], []).append(it)
        for p, its in by_p.items():
            its.sort(key=lambda it: it[1])
            rids = [it[1] for it in its]
            gq: Dict[int, list] = {}
            for it in its:
                gq.setdefault(dp_group.get(it[3], 0), []).append(it)
            queues = [q for _, q in sorted(gq.items())]
            order = []
            while any(queues):
                for q in queues:
                    if q:
                        order.append(q.pop(0))
            out.extend((p, rid, kind, slot, cost)
                       for rid, (_, _, kind, slot, cost)
                       in zip(rids, order))
        return out


class PreemptionPolicy:
    """Victim selection for evict-for-preempt admissions.

    A victim must be STRICTLY lower class (numerically greater priority
    value) than the incoming request — preemption never reorders within
    a class. Among eligible victims the policy picks the lowest class
    first, then — when a ``swappable`` predicate is supplied (a host
    tier) — victims whose eviction SWAPS (one page copy to host,
    near-free resume) over ones that would evict-and-replay, then the
    fewest generated tokens (the cheapest replay if one does happen),
    then the youngest request (highest rid) — so the work already sunk
    into older, further-along requests is preserved.
    """

    def pick_victim(self, running, priority: int, swappable=None):
        """``running``: live request objects (``.priority`` /
        ``.tokens`` / ``.rid``); ``swappable(req) -> bool`` marks
        victims whose preemption swaps out instead of replaying.
        Returns one victim or None."""
        cands = [r for r in running if r.priority > int(priority)]
        if not cands:
            return None
        sw = swappable if swappable is not None else (lambda r: False)
        return max(cands,
                   key=lambda r: (r.priority, bool(sw(r)),
                                  -len(r.tokens), r.rid))
