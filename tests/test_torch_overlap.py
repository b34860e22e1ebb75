"""The port's overlapped dispatch/commit runtime, on the CPU.

The port's counterparts of ``tests/test_overlap.py``'s contracts, on the
port engine (tiny f32 Llama, ``max_batch=2, page_size=8, max_len=48``):

- a ``ServingScheduler`` with ``overlap=True`` (plan step N+1 while step
  N is in flight, commit N at the one fence before N+1's dispatch) is
  token-identical to the synchronous one for f32 and int8 KV and for
  n-gram speculation, on a mixed-priority workload whose HIGH burst
  preempts;
- the token budget stays a hard ceiling under the overlapped planner;
- the commit's rid guard and seat guard drop a token dispatched for a
  seating that changed before its commit, and a planted stale snapshot
  that hides the change makes the commit credit it;
- ``run()`` fences instead of re-planning empty steps, and ``flush()``
  makes the in-flight tokens visible;
- a preempted slot's pages, handed to the next tenant while the
  victim's decode is in flight, leave the tenant's tokens as they are
  without the race.
"""
import numpy as np
import jax
import pytest
import torch

from paddle_tpu.models import llama as jl
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import params_from_jax
from paddle_tpu_torch.serving import Priority, ServingScheduler, StepPlan

torch.set_num_threads(1)
_CACHE = {}


def _params():
    if "params" not in _CACHE:
        jcfg = jl.LlamaConfig.tiny(num_layers=2, max_seq_len=64)
        jp = jl.init_params(jax.random.key(0), jcfg)
        _CACHE["params"] = (
            params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
            tl.LlamaConfig.tiny(num_layers=2, max_seq_len=64))
    return _CACHE["params"]


def _prompts(lens, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(3, 256, (n,)).astype(np.int32) for n in lens]


def _engine(overlap, **kw):
    tp, tcfg = _params()
    for k, v in dict(max_batch=2, page_size=8, max_len=48).items():
        kw.setdefault(k, v)
    return ContinuousBatchingEngine(tp, tcfg, overlap=overlap, device="cpu",
                                    **kw)


def _run_workload(overlap, *, budget=20, prompts=None, max_new=6,
                  **engine_kw):
    """LOW / NORMAL requests, then after 5 steps a HIGH burst that
    preempts. Returns (per-request outputs, scheduler, per-step plan
    tokens)."""
    prompts = prompts if prompts is not None else _prompts((5, 11, 3), 3)
    sched = ServingScheduler(_engine(overlap, **engine_kw),
                             token_budget=budget)
    assert sched.overlap is overlap
    reqs = [sched.submit(p, max_new_tokens=max_new,
                         priority=Priority.LOW if i % 2 else Priority.NORMAL)
            for i, p in enumerate(prompts[:-1])]
    plans = []
    for _ in range(5):
        sched.step()
        plans.append(sched.last_plan.scheduled_tokens)
    reqs.append(sched.submit(prompts[-1], max_new_tokens=max_new,
                             priority=Priority.HIGH))
    while sched.step():
        plans.append(sched.last_plan.scheduled_tokens)
        assert len(plans) < 400
    assert all(r.done for r in reqs), [(r.rid, r.finish_reason)
                                       for r in reqs]
    return [r.output.tolist() for r in reqs], sched, plans


_MOTIF = np.asarray([7, 11, 13], np.int32)
SCENARIOS = {
    "fp": {},
    "int8": dict(kv_cache_dtype="int8"),
    "ngram": dict(spec_k=2, budget=24, max_new=8,
                  prompts=[np.tile(_MOTIF, 5)[:14], np.tile(_MOTIF, 5)[:13],
                           np.tile(_MOTIF, 4)[:9]]),
}


def _sync(key):
    if ("sync", key) not in _CACHE:
        _CACHE["sync", key] = _run_workload(False, **SCENARIOS[key])
    return _CACHE["sync", key]


@pytest.mark.parametrize("key", sorted(SCENARIOS))
def test_overlap_is_token_identical_to_sync(key):
    want, s_sync, _ = _sync(key)
    got, sched, _ = _run_workload(True, **SCENARIOS[key])
    assert got == want
    for s in (s_sync, sched):
        assert s.preemptions_total >= 1 and s.resumes_total >= 1
    eng = sched.engine
    assert not eng.has_inflight() and eng.idle
    st = sched.stats()
    assert st["overlap"] is True and "host_overhead_fraction" in st
    assert 0.0 <= sched.host_frac_ema <= 1.0
    if key == "ngram":
        assert st["spec_verify_steps"] > 0 and st["spec_accepted_total"] > 0


@pytest.mark.parametrize("overlap", [False, True])
def test_budget_is_a_hard_ceiling(overlap):
    budget = 16
    prompts = _prompts((11, 14, 5), 9)
    _, sched, plans = _run_workload(overlap, budget=budget, prompts=prompts)
    assert max(plans) <= budget and sched.preemptions_total >= 1


def _seated_decode(max_new=4, seed=5, **kw):
    """A one-slot engine with request ``a`` fully prefilled and one
    decode step dispatched, not committed."""
    eng = _engine(False, max_batch=1, **kw)
    a = eng.create_request(_prompts((5,), seed)[0], max_new_tokens=max_new)
    assert eng.admit_request(a)
    while eng.pending_prefills():
        eng.prefill_step()
    h = eng.decode_dispatch(eng.ready_mask())
    assert h is not None and eng.has_inflight()
    return eng, a, h


@pytest.mark.parametrize("planted", [False, True], ids=["guard", "planted"])
def test_rid_guard(planted):
    """Slot 0's request is preempted and another one seated there before
    the commit: the in-flight token must not reach the new occupant.
    With the snapshot planted to match the new seating, it does."""
    pa = _prompts((5,), 5)[0]
    want = _engine(False, max_batch=1).generate([pa], max_new_tokens=4)[0]
    eng, a, h = _seated_decode()
    eng.preempt_request(a)
    b = eng.create_request(_prompts((7,), 6)[0], max_new_tokens=4)
    assert eng.admit_request(b)
    if planted:
        h.rids[:] = eng._rids
        h.seats[:] = eng._seat
    len0 = int(eng.cache.lengths[0])
    eng.commit_inflight()
    if planted:
        assert len(b.tokens) == 1       # the stale token got through
        return
    assert b.tokens == [] and int(eng.cache.lengths[0]) == len0
    eng.cancel_request(b)
    assert eng.admit_request(a)
    eng.run()
    np.testing.assert_array_equal(a.output, want)


@pytest.mark.parametrize("planted", [False, True], ids=["guard", "planted"])
def test_seat_guard(planted):
    """The SAME request preempted and re-seated into its own slot before
    the commit: the rid is unchanged, so only the seat generation can
    reject the stale token. With the seat snapshot planted, the token
    is credited."""
    pa = _prompts((5,), 5)[0]
    want = _engine(False, max_batch=1).generate([pa], max_new_tokens=4)[0]
    eng, a, h = _seated_decode()
    eng.preempt_request(a)
    assert eng.admit_request(a)          # same rid, same slot
    assert int(eng._rids[0]) == int(h.rids[0])
    if planted:
        h.seats[:] = eng._seat
    ntok = len(a.tokens)
    eng.commit_inflight()
    if planted:
        assert len(a.tokens) == ntok + 1
        return
    assert len(a.tokens) == ntok
    eng.run()
    np.testing.assert_array_equal(a.output, want)


def test_stale_chunk_commits_nothing():
    """A prefill chunk whose slot was preempted and re-seated before
    its commit advances nothing; the new seating replays the span."""
    eng = _engine(False, max_batch=1, prefill_chunk=8)
    p = _prompts((20,), 7)[0]
    want = _engine(False, max_batch=1, prefill_chunk=8).generate(
        [p], max_new_tokens=3)[0]
    a = eng.create_request(p, max_new_tokens=3)
    assert eng.admit_request(a)
    assert eng.prefill_dispatch() == 8
    eng.preempt_request(a)
    assert eng.admit_request(a)
    assert eng.commit_prefills() == 0
    assert eng.pending_prefills()[0][1] == 20
    eng.run()
    np.testing.assert_array_equal(a.output, want)


def test_freed_pages_next_tenant_unaffected():
    """The victim's decode is in flight when its pages go to the next
    tenant, whose prefill then overwrites them: the tenant's tokens
    equal those of a run without the race."""
    pb = _prompts((7,), 6)[0]
    want = _engine(False, max_batch=1).generate([pb], max_new_tokens=5)[0]
    eng, a, h = _seated_decode(max_new=8, enable_prefix_cache=False)
    old = set(eng.cache.pages_held(0))
    assert eng.preempt_request(a) == len(old)
    b = eng.create_request(pb, max_new_tokens=5)
    assert eng.admit_request(b)
    assert old & set(eng.cache.pages_held(0))   # b reuses a's pages
    assert eng.prefill_dispatch() == 8   # lands after the stale write
    eng.commit_inflight()
    eng.run()
    np.testing.assert_array_equal(b.output, want)


def test_run_fences_instead_of_spinning():
    """A step that plans nothing and commits nothing fences the
    in-flight work (or yields) instead of re-planning empty steps."""
    sched = ServingScheduler(_engine(True), token_budget=20)
    req = sched.submit(_prompts((5,), 2)[0], max_new_tokens=6)
    sched.step()                         # admit + first dispatch
    real_plan, holes = sched._plan, [3]

    def empty_plan(*args):
        if holes[0] > 0:
            holes[0] -= 1
            return StepPlan(budget=sched.planner.token_budget)
        return real_plan(*args)

    sched._plan = empty_plan
    sched.run()
    assert req.done and len(req.tokens) == 6
    assert sched.idle_fences_total >= 1


def test_flush_makes_tokens_visible():
    sched = ServingScheduler(_engine(True), token_budget=20)
    eng = sched.engine
    req = sched.submit(_prompts((5,), 2)[0], max_new_tokens=6)
    while not req.tokens:
        sched.step()
    n0 = len(req.tokens)
    sched.step()                         # leaves a decode in flight
    assert eng.has_inflight()
    assert sched.flush() == 1
    assert not eng.has_inflight() and len(req.tokens) == n0 + 1
    assert eng.take_fence_ns() >= 0 and eng.take_fence_ns() == 0


def test_uploads_are_copies():
    """On the CPU an upload is a copy: the host array may change at
    once (on the card the upload goes through its own pinned block)."""
    eng = _engine(True)
    host = np.arange(6, dtype=np.int32)
    t = eng._up(host)
    host[:] = -1
    assert t.tolist() == list(range(6))
