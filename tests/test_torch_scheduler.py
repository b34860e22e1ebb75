"""The port's SLO scheduler and engine lifecycle against the JAX package's.

Both sides get the same tiny f32 Llama (``LlamaConfig.tiny(num_layers=2,
max_seq_len=64)``, the JAX weights through ``params_from_jax``) and an
engine of ``max_batch=2, page_size=8, max_len=48``; the same script of
submissions, clock moves and cancels drives the JAX
``ServingScheduler`` and the port's, synchronously or, in the
``*_overlap`` workloads, both with ``overlap=True``. Per workload the
greedy tokens, finish reasons, preemption, resume and deadline-cancel
counts, ``idle_fences_total``, every step's
``last_plan.scheduled_tokens`` and, on a speculative engine, the
``spec_plan_widths`` seen at the start of every step must be equal, and
the port's allocator must be balanced after the drain:

- ``preempt``: a NORMAL and a LOW request, then a HIGH burst that
  preempts the LOW one, which resumes through the replay prefill
  (KV f32 and int8);
- ``mid_prefill``: the victim is still mid chunked prefill;
- ``deadline``: an injected clock lapses one queued and one mid-prefill
  request's deadlines;
- ``cancel``: a queued, a running and a preempted request cancelled;
- ``budget`` / ``no_budget``: the same requests under a 8-token budget
  and none (the budget changes when tokens come, not which);
- ``preempt_overlap``, ``preempt_int8_overlap``, ``mid_prefill_overlap``:
  the first three through the overlapped pipeline;
- ``ngram`` / ``ngram_overlap``: n-gram speculation (``spec_k=2``) on
  repetitive prompts with the HIGH burst, synchronous and overlapped.

Prompt lengths stay within two page buckets so that the JAX programs
compile few shapes; one JAX run per workload is cached for the module.
An overlapped JAX engine steps with ``jnp.asarray`` copying its host
arrays first (``_CopyingJnp``): on the CPU backend a 64-byte-aligned
numpy array is aliased, not copied, and the overlapped scheduler
rewrites the engine's block tables (a preemption and re-admission)
while the decode that read them is still in flight, so an aliased run
may decode from the rewritten table. Whether a buffer is aligned
depends on the process's heap, so the race shows only in some
processes.
The planner and the preemption policy are held to the reference's on
randomized inputs.
"""
import contextlib
import types

import numpy as np
import jax
import pytest
import torch

from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference import predictor as jpred
from paddle_tpu.models import llama as jl
from paddle_tpu.serving import PreemptionPolicy as JaxPolicy
from paddle_tpu.serving import Priority as JaxPriority
from paddle_tpu.serving import ServingScheduler as JaxScheduler
from paddle_tpu.serving import TokenBudgetPlanner as JaxPlanner
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import params_from_jax
from paddle_tpu_torch.serving import (FinishReason, PreemptionPolicy,
                                      Priority, ServingScheduler, StepPlan,
                                      TokenBudgetPlanner)
from test_torch_spec import _CopyingJnp

torch.set_num_threads(1)
ENGINE_KW = dict(max_batch=2, page_size=8, max_len=48)
_CACHE = {}


def _models():
    if "models" not in _CACHE:
        jcfg = jl.LlamaConfig.tiny(num_layers=2, max_seq_len=64)
        jp = jl.init_params(jax.random.key(0), jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        tcfg = tl.LlamaConfig.tiny(num_layers=2, max_seq_len=64)
        _CACHE["models"] = dict(
            jax=(JaxEngine, JaxScheduler, JaxPriority, jp, jcfg, {}),
            port=(ContinuousBatchingEngine, ServingScheduler, Priority, tp,
                  tcfg, {"device": "cpu"}))
    return _CACHE["models"]


def _prompts(lens, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(3, 256, (n,)).astype(np.int32) for n in lens]


@contextlib.contextmanager
def _copying_jnp(on):
    """Step the JAX engine with a ``jnp`` whose ``asarray`` copies (the
    module docstring's aliasing), when ``on``."""
    if not on:
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpred, "jnp", _CopyingJnp())
        yield


#: the first JAX engine of each program signature, and of each draft
#: model's
_PROGRAMS = {}


def _share_programs(eng):
    """A JAX engine runs the compiled programs of the first engine with
    its program signature: the values its programs close over (config,
    ``fused``, temperature, ``use_kernel``, constraints, an adapter pool
    or none, no mesh; for the draft model's programs its config too).
    Everything else reaches them as arguments, whose shapes, dtypes and
    structure the jitted functions key on, so each program is traced
    and compiled once a process, not once an engine."""
    if eng.mesh is not None:
        return
    key = (repr(eng.cfg), eng.fused, eng.temperature, eng.use_kernel,
           eng.constraints, eng.adapters is not None)
    for sig, dicts, fns in (
            (key, ("_chunk_fns", "_spec_fns", "_tree_fns",
                   "_tree_commit_fns"), ("_decode_fn",)),
            (key + (repr(eng.draft_cfg),), ("_draft_fns",),
             ("_draft_dec_fn",))):
        proto = _PROGRAMS.setdefault(sig, eng)
        if proto is eng:
            continue
        for name in dicts:
            setattr(eng, name, getattr(proto, name))
        for name in fns:
            if getattr(proto, name) is not None:
                setattr(eng, name, getattr(proto, name))


class _Run:
    """One side's engine and scheduler, with the per-step plan log. An
    overlapped JAX run steps under :func:`_copying_jnp`."""

    def __init__(self, side, budget=None, clock=None, overlap=False,
                 **engine_kw):
        Engine, Sched, self.P, params, cfg, extra = _models()[side]
        kw = dict(ENGINE_KW, **engine_kw, **extra)
        self.eng = Engine(params, cfg, **kw)
        if side == "jax":
            _share_programs(self.eng)
        skw = {} if clock is None else {"clock": clock}
        self.sched = Sched(self.eng, token_budget=budget, overlap=overlap,
                           **skw)
        assert self.sched.overlap is overlap
        self.copying = side == "jax" and overlap
        self.plans = []
        self.widths = []
        self.reqs = []

    def submit(self, prompt, new, prio, **kw):
        r = self.sched.submit(prompt, max_new_tokens=new,
                              priority=getattr(self.P, prio), **kw)
        self.reqs.append(r)
        return r

    def step(self, n=1):
        with _copying_jnp(self.copying):
            return self._step(n)

    def _step(self, n):
        more = True
        for _ in range(n):
            if getattr(self.eng, "spec", None) is not None:
                full = np.ones((self.eng.max_batch,), bool)
                self.widths.append(
                    (self.eng.spec_plan_widths(self.eng.ready_mask()),
                     self.eng.spec_plan_widths(full)))
            more = self.sched.step()
            self.plans.append(self.sched.last_plan.scheduled_tokens)
        return more

    def drain(self):
        while self.step():
            assert len(self.plans) < 400

    def record(self):
        s = self.sched
        return dict(tokens=[list(map(int, r.tokens)) for r in self.reqs],
                    reasons=[str(r.finish_reason) for r in self.reqs],
                    done=[r.done for r in self.reqs],
                    preemptions=s.preemptions_total,
                    resumes=s.resumes_total,
                    deadline_cancels=s.deadline_cancels_total,
                    idle_fences=s.idle_fences_total,
                    victims=[r.preemptions for r in self.reqs],
                    plans=list(self.plans),
                    widths=[({int(k): int(v) for k, v in a.items()},
                             {int(k): int(v) for k, v in b.items()})
                            for a, b in self.widths])


def _preempt(side, kv=None, overlap=False):
    run = _Run(side, budget=20, kv_cache_dtype=kv, overlap=overlap)
    a, b, c = _prompts((5, 11, 3), seed=3)
    run.submit(a, 6, "NORMAL")
    run.submit(b, 6, "LOW")
    run.step(5)
    run.submit(c, 6, "HIGH")
    run.drain()
    return run


def _mid_prefill(side, overlap=False):
    run = _Run(side, prefill_chunk=8, overlap=overlap)
    a, b, c = _prompts((20, 18, 6), seed=17)
    run.submit(a, 5, "LOW")
    run.step(1)                       # a's first chunk, 8 of 20 tokens
    run.submit(b, 5, "NORMAL")
    run.step(1)                       # b's first chunk outranks a's
    run.submit(c, 4, "HIGH")
    run.step(1)                       # evicts a mid-prefill
    run.drain()
    return run


def _deadline(side):
    t = [0.0]
    run = _Run(side, clock=lambda: t[0], prefill_chunk=8)
    a, b, c = _prompts((5, 20, 4), seed=8)
    run.submit(a, 8, "NORMAL")
    run.submit(b, 4, "NORMAL", deadline_s=5.0)   # admitted, mid-prefill
    run.submit(c, 4, "NORMAL", deadline_s=5.0)   # queued: both slots busy
    run.step(2)
    t[0] = 10.0
    run.drain()
    return run


def _cancel(side):
    run = _Run(side)
    a, b, c, d = _prompts((5, 6, 4, 5), seed=28)
    ra = run.submit(a, 8, "LOW")
    rb = run.submit(b, 8, "LOW")
    run.step(3)
    run.submit(c, 6, "HIGH")
    run.step(1)                       # preempts b (fewest tokens, youngest)
    rd = run.submit(d, 4, "LOW")      # queued behind the busy slots
    run.step(1)
    for r in (rd, ra, rb):            # queued, running, preempted
        run.eng.cancel_request(r, "cancelled")
    run.drain()
    return run


def _budget(side, budget):
    run = _Run(side, budget=budget, enable_prefix_cache=False)
    for p in _prompts((4, 6, 9), seed=11):
        run.submit(p, 5, "NORMAL")
    run.drain()
    return run


_MOTIF = np.asarray([7, 11, 13], np.int32)


def _ngram(side, overlap):
    """n-gram speculation on repetitive prompts, a NORMAL and a LOW
    request, then a HIGH burst that preempts the LOW one."""
    run = _Run(side, budget=24, spec_k=2, overlap=overlap)
    a, b, c = (np.tile(_MOTIF, 5)[:14], np.tile(_MOTIF, 5)[:13],
               np.tile(_MOTIF, 4)[:9])
    run.submit(a, 8, "NORMAL")
    run.submit(b, 8, "LOW")
    run.step(5)
    run.submit(c, 8, "HIGH")
    run.drain()
    return run


WORKLOADS = {
    "preempt": lambda side: _preempt(side),
    "preempt_int8": lambda side: _preempt(side, kv="int8"),
    "preempt_overlap": lambda side: _preempt(side, overlap=True),
    "preempt_int8_overlap": lambda side: _preempt(side, kv="int8",
                                                  overlap=True),
    "mid_prefill": _mid_prefill,
    "mid_prefill_overlap": lambda side: _mid_prefill(side, overlap=True),
    "ngram": lambda side: _ngram(side, False),
    "ngram_overlap": lambda side: _ngram(side, True),
    "deadline": _deadline,
    "cancel": _cancel,
    "budget": lambda side: _budget(side, 8),
    "no_budget": lambda side: _budget(side, None),
}


def _reference(name):
    key = ("ref", name)
    if key not in _CACHE:
        _CACHE[key] = WORKLOADS[name]("jax").record()
    return _CACHE[key]


def _assert_balanced(eng):
    cache = eng.cache
    if cache.prefix is not None:
        cache.prefix.drop_all(cache.allocator)
    a = cache.allocator
    assert a.num_used == 0 and a.allocs_total == a.frees_total, a.stats()
    assert not cache.active.any() and not eng.has_inflight()


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_scheduler_matches_jax(name):
    want = _reference(name)
    run = WORKLOADS[name]("port")
    got = run.record()
    assert got == want
    assert all(got["done"])
    _assert_balanced(run.eng)


def test_workloads_exercise_their_paths():
    """What each workload is there for happened, on the reference."""
    pre = _reference("preempt")
    assert pre["preemptions"] == 1 and pre["resumes"] == 1
    assert pre["victims"] == [0, 1, 0]
    assert _reference("preempt_int8")["preemptions"] == 1
    mid = _reference("mid_prefill")
    assert mid["victims"][0] == 1 and mid["resumes"] == 1
    dl = _reference("deadline")
    assert dl["deadline_cancels"] == 2
    assert dl["reasons"] == ["max_len", "deadline_exceeded",
                             "deadline_exceeded"]
    assert dl["tokens"][1] == [] and dl["tokens"][2] == []
    cn = _reference("cancel")
    assert cn["reasons"] == ["cancelled", "cancelled", "max_len",
                             "cancelled"]
    assert cn["victims"][1] == 1 and cn["tokens"][3] == []
    bud, free = _reference("budget"), _reference("no_budget")
    assert bud["tokens"] == free["tokens"]
    assert max(bud["plans"]) <= 8 < max(free["plans"])
    assert len(bud["plans"]) > len(free["plans"])
    for name in ("preempt", "preempt_int8", "mid_prefill", "ngram"):
        ov = _reference(name + "_overlap")
        assert ov["tokens"] == _reference(name)["tokens"], name
        assert ov["preemptions"] >= 1 and ov["resumes"] >= 1, name
    ng = _reference("ngram_overlap")
    assert any(ready for ready, _ in ng["widths"])


def test_preempted_reason_is_transient():
    """``finish_reason`` reads "preempted" while the victim waits and
    clears when its replay completes; the resumed request's tokens equal
    an uninterrupted run's."""
    _, _, _, tp, tcfg, _ = _models()["port"]
    p = _prompts((6,), seed=2)[0]
    ref = ContinuousBatchingEngine(tp, tcfg, device="cpu", **ENGINE_KW)
    want = ref.generate([p], max_new_tokens=8)[0]
    run = _Run("port")
    a = run.submit(p, 8, "LOW")
    while len(a.tokens) < 3:
        run.step()
    run.submit(_prompts((4,), seed=3)[0], 2, "HIGH")
    run.submit(_prompts((4,), seed=4)[0], 2, "HIGH")
    run.step()
    assert a.finish_reason == "preempted" == FinishReason.PREEMPTED
    assert not a.done and a.slot is None and a.preemptions == 1
    while a.slot is None or a.slot in run.eng.pending_prefills():
        run.step()
    assert a.finish_reason is None
    run.drain()
    assert a.finish_reason == "max_len"
    np.testing.assert_array_equal(a.output, want)
    _assert_balanced(run.eng)


def test_requires_fresh_engine_and_scheduler_submit():
    _, _, _, tp, tcfg, _ = _models()["port"]
    eng = ContinuousBatchingEngine(tp, tcfg, device="cpu", **ENGINE_KW)
    eng.submit(_prompts((4,), seed=5)[0], max_new_tokens=2)
    with pytest.raises(ValueError, match="fresh engine"):
        ServingScheduler(eng)
    eng = ContinuousBatchingEngine(tp, tcfg, device="cpu", **ENGINE_KW)
    sched = ServingScheduler(eng)
    eng.submit(_prompts((4,), seed=5)[0], max_new_tokens=2)
    with pytest.raises(ValueError, match="ServingScheduler.submit"):
        sched.step()


def test_load_stats_and_stats_keys():
    run = _Run("port", budget=16)
    for p in _prompts((5, 6, 7), seed=9):
        run.submit(p, 4, "NORMAL", deadline_s=100.0)
    run.step()
    ls = run.sched.load_stats()
    assert set(ls) == {
        "queue_depths", "queued_total", "queued_tokens", "inflight_tokens",
        "running", "pending_prefills", "free_slots",
        "oldest_deadline_slack_s", "pool_occupancy", "pool_free_pages",
        "degraded_level", "degraded_mode"}
    assert ls["queued_total"] == 1 and ls["running"] == 2
    assert ls["degraded_mode"] == "healthy"
    run.drain()
    st = run.sched.stats()
    for k in ("sched_steps", "preemptions_total", "resumes_total",
              "deadline_cancels_total", "overlap", "idle_fences_total",
              "host_overhead_fraction", "last_step_tokens", "token_budget",
              "fragmentation"):
        assert k in st, k
    assert st["overlap"] is False and st["token_budget"] == 16


def _plan_fields(plan):
    return (list(plan.decode_slots), list(plan.prefills), plan.budget,
            plan.deferred_decodes, dict(plan.spec_drafts),
            plan.reserved_tokens, plan.scheduled_tokens)


@pytest.mark.parametrize("budget", [None, 8, 16, 24, 40])
def test_planner_matches_jax_on_random_inputs(budget):
    rs = np.random.RandomState(budget or 0)
    page = 8
    port, ref = TokenBudgetPlanner(budget, page), JaxPlanner(budget, page)
    for _ in range(200):
        nd, npf = rs.randint(0, 7), rs.randint(0, 4)
        slots = rs.permutation(12)
        decode = [(int(rs.randint(0, 3)), int(rs.randint(0, 50)),
                   int(slots[i])) for i in range(nd)]
        pending = [(int(rs.randint(0, 3)), 100 + i, int(slots[nd + i]),
                    int(rs.randint(1, 64))) for i in range(npf)]
        spec = ({s: int(rs.randint(0, 5)) for _, _, s in decode}
                if rs.rand() < 0.5 else None)
        dpg = ({int(s): int(s) % 2 for s in slots}
               if rs.rand() < 0.3 else None)
        kw = dict(chunk_cap=[None, 8, 16][rs.randint(3)],
                  spec_drafts=spec, reserved_tokens=int(rs.randint(0, 9)),
                  dp_group=dpg)
        got = port.plan(decode, pending, **kw)
        assert _plan_fields(got) == _plan_fields(ref.plan(decode, pending,
                                                          **kw))
        if budget is not None:
            assert got.scheduled_tokens <= budget
            assert all(c % page == 0 and c >= page for _, c in got.prefills)
    with pytest.raises(ValueError, match="smaller than one"):
        TokenBudgetPlanner(7, 8)
    assert StepPlan([0, 2], [(1, 16)], 32).scheduled_tokens == 18


def test_preemption_policy_matches_jax_on_random_inputs():
    rs = np.random.RandomState(1)
    port, ref = PreemptionPolicy(), JaxPolicy()
    for _ in range(300):
        running = [types.SimpleNamespace(priority=int(rs.randint(0, 3)),
                                         tokens=[0] * int(rs.randint(0, 4)),
                                         rid=int(rid))
                   for rid in rs.permutation(20)[:rs.randint(0, 6)]]
        prio = int(rs.randint(0, 3))
        sw = None
        if rs.rand() < 0.5:
            marks = {r.rid: bool(rs.rand() < 0.5) for r in running}
            sw = lambda r, m=marks: m[r.rid]  # noqa: E731
        got = port.pick_victim(running, prio, swappable=sw)
        want = ref.pick_victim(running, prio, swappable=sw)
        assert got is want
    assert int(Priority.HIGH) == int(JaxPriority.HIGH) == 0


def test_requeue_existing_handle():
    """``requeue`` takes a handle made outside ``submit`` (a recovery
    path) into its class, ``front=True`` ahead of the class."""
    run = _Run("port")
    a, b, c = _prompts((5, 6, 7), seed=12)
    ra = run.submit(a, 3, "NORMAL")
    rb = run.eng.create_request(b, max_new_tokens=3)
    rc = run.eng.create_request(c, max_new_tokens=3)
    run.sched.requeue(rb)
    run.sched.requeue(rc, front=True)
    assert [r.rid for r in run.sched._queues[Priority.NORMAL]] == [
        rc.rid, ra.rid, rb.rid]
    assert rc.submitted_at == rc.enqueued_at is not None
    run.drain()
    assert all(r.done and len(r.tokens) == 3 for r in (ra, rb, rc))
    _assert_balanced(run.eng)


def test_evict_for_preempt_keeps_shared_pages():
    """Preemption drops only the victim's own references: a page the
    prefix trie also holds survives at refcount 1, and the count of
    pages freed equals the victim's unshared ones."""
    run = _Run("port")
    a = run.submit(_prompts((19,), seed=13)[0], 8, "LOW")
    while not a.tokens:
        run.step()
    cache = run.eng.cache
    held = cache.pages_held(a.slot)
    shared = [p for p in held if cache.allocator.refcount(p) == 2]
    assert len(shared) == 3                 # two full prompt pages + tail
    used = cache.allocator.num_used
    freed = run.eng.preempt_request(a)
    assert freed == len(held) - len(shared)
    assert cache.allocator.num_used == used - freed
    assert all(cache.allocator.refcount(p) == 1 for p in shared)
    assert cache.pages_held(0) == [] and not cache.active[0]
