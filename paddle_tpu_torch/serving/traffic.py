"""Trace-driven traffic harness: open-loop load generation and
goodput-under-SLO measurement for the serving cluster.

The port's counterpart of ``paddle_tpu/serving/traffic.py``, pure host
code. Its numpy draws are the reference's, draw for draw, so one seed
gives one trace in both packages.

- :func:`synth_trace` — a seeded open-loop trace generator: tenant
  populations sharing page-aligned prefix families (each tenant's
  system prompt routes through the router's affinity), a
  non-homogeneous Poisson arrival process with DIURNAL modulation and
  a BURST window (the overload the autoscaler must absorb), and mixed
  priority / deadline / length distributions. Same seed and same
  parameters give the same trace, every run.

- :class:`FakeClock` — the injectable clock every cluster component
  accepts: the driver advances virtual time per step, so arrival
  dynamics, deadlines and TTFT are deterministic and independent of
  the host's speed (no wall clock anywhere in the SLO arithmetic).

- :func:`run_trace` — the open-loop driver: submissions land when the
  virtual clock reaches their arrival stamp WHATEVER the cluster's
  state (open loop is what makes overload visible: a closed loop
  would slow its own offered load), steps the cluster, watches every
  handle for its first committed token, and folds the outcomes into an
  :class:`SLOReport`.

- :class:`SLOReport` — goodput-under-SLO metrics: p50/p99 TTFT,
  p50/p99 per-token latency, deadline-met fraction, goodput (tokens of
  SLO-met requests per WALL second) and the rejection split
  (ratelimit / infeasible / overload), plus the autoscaler's up/down
  event counts when one is attached.

The harness drives :class:`~paddle_tpu_torch.serving.ServingCluster`
but accepts anything with ``submit`` / ``step``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np

from ..observability import hooks as _obs
from .policy import Priority

#: finish reasons that mean the cluster DECLINED the request at a
#: door (no tokens owed) rather than serving or losing it
REJECTED_REASONS = ("rejected_ratelimit", "rejected_infeasible",
                    "rejected_overload")


class FakeClock:
    """Injectable monotonic clock (virtual seconds): the single time
    source for the trace driver, every scheduler deadline and every
    rate-limit window — advanced ONLY by :func:`run_trace`, so a run's
    SLO arithmetic is the same on any host."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


@dataclasses.dataclass
class TraceRequest:
    """One trace entry: everything :meth:`ServingCluster.submit`
    needs, plus the open-loop arrival stamp (virtual seconds)."""
    arrival_s: float
    tenant: str
    prompt: np.ndarray
    max_new_tokens: int
    priority: int = int(Priority.NORMAL)
    deadline_s: Optional[float] = None
    #: the tenant's LoRA variant; 0 = the base model — a
    #: trace generated without an adapter population runs unchanged on
    #: adapter-less clusters
    adapter_id: int = 0


def synth_trace(seed: int = 0, *, duration_s: float = 4.0,
                base_rps: float = 6.0, tenants: int = 4,
                page_size: int = 8, prefix_pages: int = 2,
                vocab: int = 256,
                tail_tokens: tuple = (2, 10),
                new_tokens: tuple = (3, 8),
                burst_start_frac: float = 0.35,
                burst_frac: float = 0.25, burst_mult: float = 4.0,
                diurnal_amp: float = 0.5,
                deadline_frac: float = 0.6,
                deadline_s: tuple = (0.5, 2.0),
                priority_weights=(0.2, 0.6, 0.2),
                adapters: int = 0,
                adapter_zipf: float = 1.2,
                text: bool = False) -> List[TraceRequest]:
    """Generate a seeded open-loop trace.

    Arrivals draw from a non-homogeneous Poisson process by thinning:
    the instantaneous rate is ``base_rps`` modulated by one diurnal
    sine cycle over ``duration_s`` (amplitude ``diurnal_amp``) and
    multiplied by ``burst_mult`` inside the burst window
    (``[burst_start_frac, burst_start_frac + burst_frac] *
    duration_s``) — the compressed shape of a production day with one
    traffic spike. Each request belongs to one of ``tenants`` tenant
    populations, carries its tenant's page-aligned system prompt
    (``prefix_pages * page_size`` tokens — the shared prefix family)
    plus a unique tail of ``uniform(*tail_tokens)`` tokens, decodes
    ``uniform(*new_tokens)`` new tokens, draws its priority class from
    ``priority_weights`` (HIGH/NORMAL/LOW) and — with probability
    ``deadline_frac`` — a first-token deadline of
    ``uniform(*deadline_s)`` virtual seconds.

    ``adapters``: size of the LoRA variant population. When
    > 0 each TENANT is assigned one ``adapter_id`` drawn
    Zipf(``adapter_zipf``)-weighted over ``1..adapters`` — the
    head-heavy popularity curve of real fine-tune fleets (a few hot
    variants pinned resident, a long cold tail that exercises the
    slot-reclaim/demote/promote path) — and every request of that
    tenant carries it, so the trace drives adapter affinity and slot
    residency through the same open-loop arrivals as everything else.
    0 (default) leaves every request on the base model.

    ``text``: NON-REPETITIVE text mode. Every prompt —
    system prefix AND tail — is drawn WITHOUT REPLACEMENT from a
    Zipf-weighted token population (head-heavy marginals like natural
    prose, but no token ever occurs twice in one prompt), so an
    in-context n-gram lookup finds NOTHING to draft from by
    construction. This is the scoreboard workload for model-based
    draft/tree speculation: the prompt-lookup proposer's acceptance
    rounds to zero here while a draft model's does not — exactly the
    traffic where speculation pays most and the n-gram proposer
    pays least. Requires ``vocab >= prefix_pages*page_size +
    tail_tokens[1]``."""
    if duration_s <= 0 or base_rps <= 0:
        raise ValueError(
            f"synth_trace: duration_s={duration_s} and base_rps="
            f"{base_rps} must be > 0")
    if adapters < 0:
        raise ValueError(f"synth_trace: adapters={adapters} must be "
                         f">= 0")
    plen = prefix_pages * page_size
    if text and vocab - 3 < plen + tail_tokens[1]:
        raise ValueError(
            f"synth_trace: text mode needs vocab >= "
            f"{3 + plen + tail_tokens[1]} (prefix {plen} + tail "
            f"{tail_tokens[1]} distinct tokens), got {vocab}")
    rs = np.random.RandomState(seed)
    if text:
        # Zipf marginals over a seeded permutation of the usable ids
        # (so popularity is decoupled from token-id order), sampled
        # WITHOUT replacement per prompt — head-heavy like prose, but
        # zero in-context repetition for an n-gram lookup to find
        ids = rs.permutation(np.arange(3, vocab, dtype=np.int32))
        zw = np.arange(1, ids.size + 1, dtype=np.float64) ** -1.1
        zw /= zw.sum()
        sys_prompts = {
            t: rs.choice(ids, size=plen, replace=False, p=zw).astype(
                np.int32)
            for t in range(tenants)}
        tail_pool = {}
        for t in range(tenants):
            keep = ~np.isin(ids, sys_prompts[t])
            w = zw[keep]
            tail_pool[t] = (ids[keep], w / w.sum())
    else:
        sys_prompts = {
            t: rs.randint(3, vocab, (plen,)).astype(np.int32)
            for t in range(tenants)}
    tenant_adapter = {t: 0 for t in range(tenants)}
    if adapters:
        ranks = np.arange(1, adapters + 1,
                          dtype=np.float64) ** -adapter_zipf
        tenant_adapter = {
            t: int(rs.choice(np.arange(1, adapters + 1),
                             p=ranks / ranks.sum()))
            for t in range(tenants)}
    peak = base_rps * (1 + diurnal_amp) * max(1.0, burst_mult)

    def rate(t: float) -> float:
        r = base_rps * (1.0 + diurnal_amp
                        * math.sin(2 * math.pi * t / duration_s))
        b0 = burst_start_frac * duration_s
        if b0 <= t < b0 + burst_frac * duration_s:
            r *= burst_mult
        return max(r, 1e-6)

    out: List[TraceRequest] = []
    t = 0.0
    while True:
        # Poisson thinning against the constant majorant `peak`
        t += float(rs.exponential(1.0 / peak))
        if t >= duration_s:
            break
        if rs.random_sample() >= rate(t) / peak:
            continue
        tenant = int(rs.randint(tenants))
        nt = int(rs.randint(tail_tokens[0], tail_tokens[1] + 1))
        if text:
            pool, pw = tail_pool[tenant]
            tail = rs.choice(pool, size=nt, replace=False,
                             p=pw).astype(np.int32)
        else:
            tail = rs.randint(3, vocab, (nt,)).astype(np.int32)
        prio = int(rs.choice(
            [int(Priority.HIGH), int(Priority.NORMAL),
             int(Priority.LOW)], p=np.asarray(priority_weights)
            / sum(priority_weights)))
        dl = None
        if rs.random_sample() < deadline_frac:
            dl = float(rs.uniform(deadline_s[0], deadline_s[1]))
        out.append(TraceRequest(
            arrival_s=round(t, 6), tenant=f"tenant{tenant}",
            prompt=np.concatenate([sys_prompts[tenant], tail]),
            max_new_tokens=int(rs.randint(new_tokens[0],
                                          new_tokens[1] + 1)),
            priority=prio, deadline_s=dl,
            adapter_id=tenant_adapter[tenant]))
    return out


@dataclasses.dataclass
class SLOReport:
    """Goodput-under-SLO outcome of one :func:`run_trace` run."""
    requests: int = 0
    completed: int = 0
    rejected: Dict[str, int] = dataclasses.field(default_factory=dict)
    lost: int = 0
    deadline_met_fraction: float = 1.0
    p50_ttft_s: Optional[float] = None
    p99_ttft_s: Optional[float] = None
    p50_per_token_s: Optional[float] = None
    p99_per_token_s: Optional[float] = None
    goodput_tokens: int = 0
    badput_tokens: int = 0
    goodput_tokens_per_s: float = 0.0
    wall_s: float = 0.0
    virtual_s: float = 0.0
    steps: int = 0
    autoscale_up: int = 0
    autoscale_down: int = 0
    #: per-phase TTFT attribution — {phase: {p50_ms,
    #: p99_ms}} over completed first-token requests, harvested from
    #: each handle's request trace; None unless tracing was enabled
    ttft_breakdown: Optional[Dict] = None

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        for k in ("p50_ttft_s", "p99_ttft_s", "p50_per_token_s",
                  "p99_per_token_s"):
            if d[k] is not None:
                d[k] = round(d[k], 6)
        d["goodput_tokens_per_s"] = round(d["goodput_tokens_per_s"], 2)
        d["deadline_met_fraction"] = round(d["deadline_met_fraction"], 4)
        d["wall_s"] = round(d["wall_s"], 3)
        if d["ttft_breakdown"] is not None:
            d["ttft_breakdown"] = {
                ph: {q: round(v, 3) for q, v in pcts.items()}
                for ph, pcts in d["ttft_breakdown"].items()}
        return d


def run_trace(cluster, trace: List[TraceRequest], clock: FakeClock, *,
              step_dt: float = 0.02, max_steps: int = 100000,
              drain: bool = True, on_submit=None) -> SLOReport:
    """Drive ``trace`` through ``cluster`` open-loop and measure.

    Each iteration submits every arrival whose stamp the virtual clock
    has reached (open-loop: the offered load never waits for the
    cluster), steps the cluster once, scans the live handles for first
    tokens (TTFT is stamped the step the token appears, in virtual
    seconds), and advances the clock by ``step_dt``. With ``drain``
    the loop runs until every submitted request finished; without, it
    stops when the trace is exhausted and the cluster idles.

    The deadline SLO is the scheduler's own semantics (first-token):
    a deadline-bearing request MET its SLO iff it produced a first
    token by ``arrival + deadline``; deadline-less requests are met by
    completing. Rejections (ratelimit / infeasible / overload) are
    counted separately — they are the admission machinery doing its
    job — and never score as met, but also never as lost: ``lost``
    counts only requests that vanished without a structured reason,
    and the soak gates it at zero."""
    order = sorted(range(len(trace)),
                   key=lambda i: (trace[i].arrival_s, i))
    nxt = 0
    live: List[Dict] = []
    report = SLOReport(requests=len(trace))
    ttfts: List[float] = []
    per_tok: List[float] = []
    # per-phase TTFT rows: harvested from each COMPLETED
    # handle's own trace, so a shared tracer polluted by other runs
    # (or LRU aging) never skews this run's percentiles
    bd_rows: List[Dict] = []
    met = missed = 0
    # arrivals are RELATIVE to the clock at entry, so one cluster (and
    # its compiled programs) can serve a warm pass and a timed pass of
    # the same trace back to back
    t_virt0 = clock()
    t_wall0 = time.perf_counter()
    auto = getattr(cluster, "autoscaler", None)
    up0 = auto.up_events if auto is not None else 0
    down0 = auto.down_events if auto is not None else 0

    def harvest(rec) -> bool:
        """Fold one finished (or first-token) handle observation."""
        req = rec["req"]
        if rec["first_s"] is None and req.tokens:
            rec["first_s"] = clock()
        if not req.done:
            return False
        return True

    while True:
        now = clock()
        while nxt < len(order) and \
                trace[order[nxt]].arrival_s <= now - t_virt0:
            tr = trace[order[nxt]]
            nxt += 1
            req = cluster.submit(
                tr.prompt, max_new_tokens=tr.max_new_tokens,
                tenant=tr.tenant, priority=tr.priority,
                deadline_s=tr.deadline_s,
                adapter_id=getattr(tr, "adapter_id", 0))
            if on_submit is not None:
                # the chaos soak's handle collector: invariants like
                # zero-lost/zero-duplicated need every request handle,
                # not just the aggregated report
                on_submit(tr, req)
            live.append({"req": req, "tr": tr, "arrival": now,
                         "first_s": None})
        more = cluster.step()
        report.steps += 1
        still = []
        for rec in live:
            if not harvest(rec):
                still.append(rec)
                continue
            req, tr = rec["req"], rec["tr"]
            reason = req.finish_reason
            ntok = len(req.tokens)
            if reason in REJECTED_REASONS or \
                    reason == "deadline_exceeded":
                # a structured decline (door rejection, or the
                # scheduler expired it before any token): the cluster
                # did its job — scored as an SLO miss, never as lost
                report.rejected[reason] = \
                    report.rejected.get(reason, 0) + 1
                missed += 1
                continue
            if reason is None or reason == "engine_dead":
                report.lost += 1
                continue
            report.completed += 1
            rtr = getattr(req, "trace", None)
            if rtr is not None:
                bd = rtr.ttft_breakdown()
                if bd is not None:
                    bd_rows.append(bd)
            ok = True
            if rec["first_s"] is not None:
                ttft = rec["first_s"] - rec["arrival"]
                ttfts.append(ttft)
                if tr.deadline_s is not None:
                    ok = ttft <= tr.deadline_s
                if ntok > 1:
                    per_tok.append(
                        (clock() - rec["first_s"]) / (ntok - 1))
                _obs.serving_slo_ttft(ttft, ok, tr.priority)
            elif tr.deadline_s is not None:
                # finished without any token (deadline_exceeded): the
                # SLO was missed by definition
                ok = False
            if ok:
                met += 1
                report.goodput_tokens += ntok
            else:
                missed += 1
                report.badput_tokens += ntok
            _obs.serving_slo_tokens(ntok, ok)
        live = still
        clock.advance(step_dt)
        if nxt >= len(order) and not live:
            break
        if nxt >= len(order) and not more and not drain:
            break
        if report.steps >= max_steps:
            raise RuntimeError(
                f"run_trace: trace did not drain within {max_steps} "
                f"steps ({len(live)} live, {len(order) - nxt} "
                f"unsubmitted)")
    for rec in live:    # drain=False leftovers: count, don't score
        report.lost += 1
    report.wall_s = time.perf_counter() - t_wall0
    report.virtual_s = clock() - t_virt0
    total_scored = met + missed
    report.deadline_met_fraction = (met / total_scored
                                    if total_scored else 1.0)
    report.goodput_tokens_per_s = (report.goodput_tokens
                                   / report.wall_s
                                   if report.wall_s > 0 else 0.0)
    if ttfts:
        report.p50_ttft_s = float(np.percentile(ttfts, 50))
        report.p99_ttft_s = float(np.percentile(ttfts, 99))
    if per_tok:
        report.p50_per_token_s = float(np.percentile(per_tok, 50))
        report.p99_per_token_s = float(np.percentile(per_tok, 99))
    if bd_rows:
        report.ttft_breakdown = {
            ph: {"p50_ms": float(np.percentile(
                     [r[ph] for r in bd_rows], 50)),
                 "p99_ms": float(np.percentile(
                     [r[ph] for r in bd_rows], 99))}
            for ph in ("queue_ms", "prefill_ms", "handoff_ms",
                       "swap_ms", "sched_overhead_ms", "ttft_ms")}
    if auto is not None:
        # THIS run's scaling activity (a warm pass on the same
        # cluster has its own events)
        report.autoscale_up = auto.up_events - up0
        report.autoscale_down = auto.down_events - down0
    _obs.serving_slo_report(
        report.goodput_tokens_per_s, report.deadline_met_fraction,
        report.p99_ttft_s * 1e3 if report.p99_ttft_s is not None
        else None)
    return report
