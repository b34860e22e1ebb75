"""The port's host KV tier against the JAX package's, on the CPU
(``paddle_tpu_torch/serving/host_tier.py``, the host-tier half of
``serving/paged_cache.py``, and their use by the engine, the scheduler
and the supervisor).

- JAX parity, on ``test_torch_scheduler``'s tiny f32 Llama and engine
  (``max_batch=2, page_size=8, max_len=48``) with ``host_tier=True``:
  swap-resume under the scheduler (KV f32 and int8, synchronous and
  overlapped, under a budget), the replay fallback, demote / promote,
  the standing store across a restart, and supervised recovery that
  swaps in. Greedy tokens, plans, the tier's counters and, with the
  hooks on, every counter and histogram count and every request trace
  must be equal. A store the JAX engine wrote gives the port a prefix
  hit;
- the reference's own contracts (``tests/test_host_tier.py``), port
  against port on its geometry (``max_batch=1, page_size=8,
  max_len=32``): ``TestHostPageStore``'s five, ``TestPolicy``,
  ``TestSwapResume`` without the tp2 test, ``TestPrefixTier`` (the
  restarted engine on a standing store in ``tmp_path``, torn,
  bit-flipped and stale files) and ``TestResilience``'s four. Left
  out: the tp2 swap test (tp-sharded pools are ROADMAP.md step 7, not
  ported), ``TestCluster`` (it runs on the port's serving cluster in
  ``test_torch_cluster.py``, ``TestHostTierCluster``) and
  ``TestLowering`` (a TPU lowering gate);
- the port's own: swapped-in, imported and defragmented pages
  byte-equal to their source (f32, bf16 and int8 pools), a handoff
  between two port engines (host-staged and page to page) whose tokens
  equal in-place decode, ``defrag`` taking fragmentation to 0, and the
  CRC that both packages stamp.

An overlapped JAX engine steps with a copying ``jnp.asarray``
(``test_torch_scheduler``'s ``_Run``).
"""
import dataclasses
import json
import os
import sys
import types
import zlib
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.serving import resilience as jres
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.serving import host_tier as tht
from paddle_tpu_torch.serving import resilience as tres

import test_torch_scheduler as ts
sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_observability as tobs_t  # noqa: E402
from test_torch_observability import sinks  # noqa: E402,F401

torch.set_num_threads(1)
MODS = {"jax": jserving, "port": tserving}
_REF = {}


@pytest.fixture(autouse=True, scope="module")
def _no_compilation_cache():
    """The reference's host-tier tests run without the persistent XLA
    compilation cache; so do the JAX engines here."""
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def _tier(eng):
    c = eng.cache
    return dict(swap_outs=c.swap_outs_total, swap_ins=c.swap_ins_total,
                fallbacks=c.swap_replay_fallbacks,
                retries=c.swap_in_retries_total,
                corrupt=c.corruptions_detected_total,
                demotions=c.demotions_total, promotes=c.promote_hits_total,
                swap_in_pages=c.swap_in_pages_total,
                quarantined=c.host.quarantined_total)


def _record(run):
    return dict(run.record(), plans=list(run.plans), tier=_tier(run.eng))


# ------------------------------------------------------------ JAX parity

def _swap(side, kv=None, overlap=False, budget=20, steps=5, new=6,
          host_kw=None, drop=False):
    """``test_torch_scheduler``'s preempt workload on host-tier engines:
    a NORMAL and a LOW request, then a HIGH one after ``steps`` steps;
    the LOW one (decode-phase) swaps out and back in. ``drop``: a
    one-page host pool sheds the payload once another entry arrives,
    so the resume replays."""
    if drop:
        host_kw = {"host_capacity_pages": 1, "persist_prefix": False}
    run = ts._Run(side, budget=budget, kv_cache_dtype=kv, overlap=overlap,
                  host_tier=True, host_tier_kw=host_kw)
    a, b, c = ts._prompts((5, 11, 3), seed=3)
    run.submit(a, new, "NORMAL")
    run.submit(b, 6, "LOW")
    run.step(steps)
    run.submit(c, 6, "HIGH")
    run.step()
    if drop:
        run.eng.cache.host.put(("pad", 0),
                               {"k": np.zeros((1, 1, 8), np.int8)})
    run.drain()
    return run


def _demote(side):
    """A chain evicted under pool pressure demotes; the next admission
    on its prefix promotes it back."""
    sysp = ts._prompts((16,), seed=5)[0]
    p1, p2 = (np.concatenate([sysp, x])
              for x in ts._prompts((3, 3), seed=6))
    big = ts._prompts((30,), seed=8)[0]
    run = ts._Run(side, num_pages=6, host_tier=True,
                  host_tier_kw={"persist_prefix": False})
    run.submit(p1, 4, "NORMAL")
    run.drain()
    run.submit(big, 2, "NORMAL")
    run.drain()
    run.submit(p2, 4, "NORMAL")
    run.drain()
    return run


def _store(side, path):
    """The standing store across a restart: one engine writes a system
    prompt's chains to ``path``, a second one on the same directory
    hits them."""
    sysp = ts._prompts((16,), seed=9)[0]
    p1, p2 = (np.concatenate([sysp, x])
              for x in ts._prompts((4, 4), seed=10))
    kw = {"prefix_store_dir": str(path)}
    first = ts._Run(side, host_tier=True, host_tier_kw=kw)
    first.submit(p1, 4, "NORMAL")
    first.drain()
    run = ts._Run(side, host_tier=True, host_tier_kw=kw)
    run.submit(p2, 4, "NORMAL")
    run.drain()
    return run


def _supervised(side, nonblocking=False):
    """Supervised recovery that swaps in: the LOW request swaps out,
    then a decode fault tears the engine down; the rebuilt engine
    adopts the host store and swaps the session in."""
    mod = MODS[side]
    Engine, _, P, params, cfg, extra = ts._models()[side]

    def factory():
        kw = dict(ts.ENGINE_KW, **extra, host_tier=True,
                  overlap=nonblocking)
        eng = Engine(params, cfg, **kw)
        if side == "jax":
            ts._share_programs(eng)
        return eng
    sup = mod.EngineSupervisor(factory, token_budget=20,
                               sleep=lambda s: None)
    a, b, c = ts._prompts((5, 11, 3), seed=3)
    inj = mod.FaultInjector()
    with ts._copying_jnp(side == "jax" and nonblocking), inj:
        reqs = [sup.submit(a, max_new_tokens=6, priority=P.NORMAL),
                sup.submit(b, max_new_tokens=6, priority=P.LOW)]
        for _ in range(5):
            sup.step()
        reqs.append(sup.submit(c, max_new_tokens=6, priority=P.HIGH))
        sup.step()
        sup.scheduler.flush()
        sup._sync_journal()
        swapped = sorted(e.rid for e in sup.journal.live_entries()
                         if e.swapped)
        inj.arm("decode_step", "raise", nth=1)
        while sup.step():
            pass
    return types.SimpleNamespace(
        reqs=reqs, eng=sup.engine, sup=sup, swapped=swapped,
        rec=dict(tokens=[list(map(int, r.tokens)) for r in reqs],
                 reasons=[r.finish_reason for r in reqs],
                 recoveries=sup.recoveries, swapped=swapped,
                 tier=_tier(sup.engine)))


PARITY = {
    "swap": lambda side: _swap(side),
    "swap_int8": lambda side: _swap(side, kv="int8"),
    "swap_overlap": lambda side: _swap(side, overlap=True),
    "swap_int8_overlap": lambda side: _swap(side, kv="int8",
                                            overlap=True),
    "swap_budget": lambda side: _swap(side, budget=9, steps=4, new=12),
    "fallback": lambda side: _swap(side, drop=True),
    "demote": _demote,
}


def _reference(name):
    if name not in _REF:
        _REF[name] = _record(PARITY[name]("jax"))
    return _REF[name]


@pytest.mark.parametrize("name", sorted(PARITY))
def test_host_tier_matches_jax(name):
    want = _reference(name)
    run = PARITY[name]("port")
    got = _record(run)
    assert got == want
    tier = got["tier"]
    if name.startswith("swap"):
        assert tier["swap_outs"] == tier["swap_ins"] == 1, tier
        assert tier["fallbacks"] == 0 and got["resumes"] == 1
    elif name == "fallback":
        assert tier["swap_outs"] == 1 and tier["fallbacks"] == 1, tier
    else:
        assert tier["demotions"] >= 1 and tier["promotes"] >= 1, tier
    if run.sched.planner.token_budget:
        # a swap-in's pages are charged: planned + reserved <= budget
        assert max(run.plans) <= run.sched.planner.token_budget
    ts._assert_balanced(run.eng)


@pytest.mark.parametrize("name", ["swap", "swap_overlap", "fallback",
                                  "demote"])
def test_host_tier_counters_and_traces_match_jax(sinks, name):  # noqa: F811
    got = {}
    for side in ("jax", "port"):
        obs, tr = tobs_t.OBS[side]
        obs.REGISTRY.clear()
        tr.enable(clock_ns=tobs_t._Clock())
        reqs = PARITY[name](side).reqs
        got[side] = (tobs_t._counters(obs), tobs_t._traces(reqs))
    (jc, jt), (pc, pt) = got["jax"], got["port"]
    assert pc == jc
    assert pt == jt
    keys = {k[0] for k in pc}
    if name.startswith("swap"):
        assert {"serving_swap_outs_total", "serving_swap_ins_total",
                "serving_swap_pages_total"} <= keys
    elif name == "fallback":
        assert "serving_swap_replay_fallbacks_total" in keys
    else:
        assert {"serving_prefix_demoted_pages_total",
                "serving_prefix_promoted_pages_total"} <= keys


def test_standing_store_across_restart_matches_jax(tmp_path):
    runs = {side: _store(side, tmp_path / side) for side in MODS}
    recs = {side: _record(r) for side, r in runs.items()}
    assert recs["port"] == recs["jax"]
    assert recs["port"]["tier"]["promotes"] == 2
    # the two packages wrote the same files: names, keys and metadata
    # (less the CRCs: the KV values agree to f32 rounding, not bit for
    # bit) and KV within 1e-5
    names = {side: sorted(os.listdir(tmp_path / side)) for side in MODS}
    assert names["port"] == names["jax"] and len(names["port"]) == 2
    for fn in names["port"]:
        with np.load(tmp_path / "jax" / fn) as j, \
                np.load(tmp_path / "port" / fn) as p:
            assert sorted(j.files) == sorted(p.files)
            np.testing.assert_array_equal(j["key"], p["key"])
            jm, pm = (json.loads(bytes(z["meta"]).decode()) for z in (j, p))
            assert jm.pop("checksums").keys() == pm.pop("checksums").keys()
            assert jm == pm
            for k in j.files:
                if k.startswith("a_"):
                    np.testing.assert_allclose(j[k].view(np.float32),
                                               p[k].view(np.float32),
                                               rtol=0, atol=1e-5)


def test_store_written_by_jax_hits_in_the_port(tmp_path):
    """A standing store the JAX engine wrote gives the port's restarted
    engine its prefix hit, token-identically."""
    sysp = ts._prompts((16,), seed=9)[0]
    p1, p2 = (np.concatenate([sysp, x])
              for x in ts._prompts((4, 4), seed=10))
    kw = {"prefix_store_dir": str(tmp_path)}
    jrun = ts._Run("jax", host_tier=True, host_tier_kw=kw)
    jrun.submit(p1, 4, "NORMAL")
    jrun.drain()
    run = ts._Run("port", host_tier=True, host_tier_kw=kw)
    run.submit(p2, 4, "NORMAL")
    run.drain()
    assert run.eng.cache.promote_hits_total == 2
    assert run.eng.cache.host.quarantined_total == 0
    ref = ts._Run("port")
    ref.submit(p2, 4, "NORMAL")
    ref.drain()
    assert run.record()["tokens"] == ref.record()["tokens"]


@pytest.mark.parametrize("nonblocking", [False, True],
                         ids=["sync", "overlap"])
def test_supervised_swap_in_recovery_matches_jax(nonblocking):
    got = {side: _supervised(side, nonblocking) for side in MODS}
    assert got["port"].rec == got["jax"].rec
    rec = got["port"].rec
    assert rec["recoveries"] == 1 and rec["swapped"]
    assert rec["tier"]["swap_ins"] == 1 and rec["tier"]["fallbacks"] == 0
    # recovery replays nothing for the swapped session
    assert got["port"].sup.stats()["recoveries"] == 1
    ts._assert_balanced(got["port"].eng)


# --------------------------------------- the reference's own contracts

_GEOM = dict(max_batch=1, page_size=8, max_len=32, device="cpu")


def _params():
    return ts._models()["port"][3], ts._models()["port"][4]


def _engine(host=True, **kw):
    params, cfg = _params()
    eng_kw = dict(_GEOM, host_tier=host)
    eng_kw.update(kw)
    return ContinuousBatchingEngine(params, cfg, **eng_kw)


def _prompt(n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(3, 256, (n,)).astype(np.int32)


def _ref(p, new, **kw):
    return _engine(host=False, **kw).generate([p], max_new_tokens=new)[0]


def _swap_preempt_run(**eng_kw):
    eng = _engine(**eng_kw)
    sched = tserving.ServingScheduler(eng)
    a = sched.submit(_prompt(6, seed=2), max_new_tokens=8,
                     priority=tserving.Priority.LOW)
    while len(a.tokens) < 3:
        sched.step()
    sched.submit(_prompt(4, seed=3), max_new_tokens=2,
                 priority=tserving.Priority.HIGH)
    sched.step()
    assert a.preemptions == 1 and a.slot is None
    sched.run()
    return a, eng, sched


class TestHostPageStore:
    def test_roundtrip_raw_bytes_and_accounting(self):
        store = tserving.HostPageStore(page_size=8)
        arrays = {
            "k": torch.arange(2 * 3 * 8 * 4, dtype=torch.float32).reshape(
                2, 3, 8, 4).to(torch.bfloat16),
            "ks": torch.ones((2, 3, 8), dtype=torch.int8),
        }
        entry = store.put(("swap", 7), arrays, extra={"length": 20})
        assert store.pages_resident == 3
        assert store.bytes_resident == entry["bytes"] > 0
        assert entry["meta"]["k"] == {"shape": [2, 3, 8, 4],
                                      "dtype": "bfloat16"}
        got = tserving.HostPageStore.decode(store.get(("swap", 7)))
        assert got["k"].dtype == torch.bfloat16
        assert torch.equal(got["k"].view(torch.int16),
                           arrays["k"].view(torch.int16))
        assert torch.equal(got["ks"], arrays["ks"])
        # the raw-bytes form decodes the same without the kept tensors
        raw = {k: v for k, v in store.get(("swap", 7)).items()
               if k != "tensors"}
        again = tserving.HostPageStore.decode(raw)
        assert torch.equal(again["k"].view(torch.int16),
                           arrays["k"].view(torch.int16))
        assert store.pop(("swap", 7))["extra"]["length"] == 20
        assert store.pages_resident == 0 and store.bytes_resident == 0
        assert store.get(("swap", 7), touch=False) is None

    def test_capacity_drops_lru_first(self):
        store = tserving.HostPageStore(page_size=8, capacity_pages=4)
        one_page = {"k": np.zeros((1, 1, 8), np.int8)}
        for i in range(4):
            store.put(("swap", i), one_page)
        store.get(("swap", 0))              # 0 becomes most-recent
        store.put(("swap", 9), one_page)    # over capacity: drop LRU (1)
        assert store.get(("swap", 1), touch=False) is None
        assert store.get(("swap", 0), touch=False) is not None
        assert store.capacity_drops_total == 1
        assert store.pages_resident == 4

    def test_standing_disk_tier_survives_new_store(self, tmp_path):
        d = str(tmp_path)
        key = np.arange(8, dtype=np.int32).tobytes()
        a = tserving.HostPageStore(page_size=8, path=d)
        a.put(key, {"k": np.full((1, 1, 8), 3, np.int8)},
              extra={"tokens": list(range(8))}, persist=True)
        assert len(os.listdir(d)) == 1
        b = tserving.HostPageStore(page_size=8, path=d)
        entry = b.get(key)                          # RAM miss -> disk hit
        assert entry is not None and entry["extra"]["tokens"] == \
            list(range(8))
        assert torch.equal(tserving.HostPageStore.decode(entry)["k"],
                           torch.full((1, 1, 8), 3, dtype=torch.int8))
        with pytest.raises(ValueError, match="bytes keys"):
            a.put(("swap", 1), {"k": np.zeros((1, 1, 8), np.int8)},
                  persist=True)

    def test_disk_promotion_respects_capacity(self, tmp_path):
        d = str(tmp_path)
        writer = tserving.HostPageStore(page_size=8, path=d)
        keys = [np.arange(8 * (i + 1), dtype=np.int32).tobytes()
                for i in range(2)]
        for k in keys:
            writer.put(k, {"k": np.zeros((1, 1, 8), np.int8)},
                       persist=True)
        reader = tserving.HostPageStore(page_size=8, capacity_pages=1,
                                        path=d)
        assert reader.get(keys[0]) is not None      # disk -> RAM
        assert reader.get(keys[1]) is not None      # disk -> RAM, evicts
        assert reader.pages_resident <= 1
        assert reader.capacity_drops_total >= 1
        assert reader.get(keys[0]) is not None      # still a disk hit

    def test_torn_disk_file_reads_as_miss(self, tmp_path):
        key = b"\x01\x02\x03\x04"
        with open(tmp_path / tht._key_name(key), "wb") as f:
            f.write(b"not an npz")
        store = tserving.HostPageStore(page_size=8, path=str(tmp_path))
        assert store.get(key) is None
        assert store.quarantined_total == 1
        assert not os.listdir(tmp_path)


class TestPolicy:
    def test_planner_reserves_swap_charge(self):
        P = tserving.Priority
        planner = tserving.TokenBudgetPlanner(16, 8)
        decode = [(P.LOW, i, i) for i in range(4)]
        pending = [(P.HIGH, 9, 9, 32)]
        plan = planner.plan(decode, pending, chunk_cap=16,
                            reserved_tokens=8)
        assert plan.reserved_tokens == 8
        assert plan.scheduled_tokens + plan.reserved_tokens <= 16
        assert plan.prefills == [(9, 8)]
        plan = planner.plan(decode, pending, chunk_cap=16,
                            reserved_tokens=16)
        assert plan.scheduled_tokens == 0
        assert plan.deferred_decodes == 4

    def test_preemption_policy_prefers_swappable(self):
        P = tserving.Priority

        def req(prio, ntok, rid):
            return types.SimpleNamespace(priority=int(prio),
                                         tokens=[0] * ntok, rid=rid)
        pol = tserving.PreemptionPolicy()
        running = [req(P.LOW, 9, 1), req(P.LOW, 2, 2)]
        assert pol.pick_victim(running, P.HIGH).rid == 2
        assert pol.pick_victim(
            running, P.HIGH, swappable=lambda r: r.rid == 1).rid == 1
        running.append(req(P.NORMAL, 0, 3))
        assert pol.pick_victim(
            running, P.HIGH, swappable=lambda r: r.rid == 3).rid in (1, 2)


class TestSwapResume:
    @pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
    def test_swap_resume_token_parity(self, kv):
        ref = _ref(_prompt(6, seed=2), 8, kv_cache_dtype=kv)
        a, eng, sched = _swap_preempt_run(kv_cache_dtype=kv)
        assert eng.cache.swap_outs_total == 1
        assert eng.cache.swap_ins_total == 1
        assert eng.cache.swap_replay_fallbacks == 0
        assert sched.resumes_total == 1
        assert a.done and a.finish_reason == "max_len"
        np.testing.assert_array_equal(a.output, ref)
        ts._assert_balanced(eng)

    @pytest.mark.parametrize("wb,kv", [(4, None), (8, "int8")],
                             ids=["w4", "w8-kv8"])
    def test_swap_resume_parity_lowbit_tiers(self, wb, kv):
        ref = _ref(_prompt(6, seed=2), 8, kv_cache_dtype=kv,
                   weight_bits=wb)
        a, eng, _ = _swap_preempt_run(kv_cache_dtype=kv, weight_bits=wb)
        assert eng.cache.swap_outs_total == 1
        assert eng.cache.swap_ins_total == 1
        np.testing.assert_array_equal(a.output, ref)

    def test_swap_fallback_to_replay_when_dropped(self):
        ref = _ref(_prompt(6, seed=2), 8)
        eng = _engine(host_tier_kw={"host_capacity_pages": 1,
                                    "persist_prefix": False})
        sched = tserving.ServingScheduler(eng)
        a = sched.submit(_prompt(6, seed=2), max_new_tokens=8,
                         priority=tserving.Priority.LOW)
        while len(a.tokens) < 3:
            sched.step()
        sched.submit(_prompt(4, seed=3), max_new_tokens=2,
                     priority=tserving.Priority.HIGH)
        sched.step()
        assert a.preemptions == 1
        eng.cache.host.put(("pad", 0), {"k": np.zeros((1, 1, 8), np.int8)})
        sched.run()
        assert eng.cache.swap_replay_fallbacks >= 1
        assert eng.cache.last_swap_fallback is None or \
            eng.cache.swap_ins_total == 0
        np.testing.assert_array_equal(a.output, ref)

    def test_scheduler_charges_swap_in_against_budget(self):
        eng = _engine()
        budget = 10
        sched = tserving.ServingScheduler(eng, token_budget=budget)
        a = sched.submit(_prompt(6, seed=2), max_new_tokens=8,
                         priority=tserving.Priority.LOW)
        while len(a.tokens) < 3:
            sched.step()
        sched.submit(_prompt(4, seed=3), max_new_tokens=2,
                     priority=tserving.Priority.HIGH)
        saw_reserve = False
        guard = 0
        while sched.step():
            plan = sched.last_plan
            assert plan.scheduled_tokens + plan.reserved_tokens <= budget
            saw_reserve = saw_reserve or plan.reserved_tokens > 0
            guard += 1
            assert guard < 200
        assert eng.cache.swap_ins_total == 1
        assert saw_reserve

    def test_mid_prefill_victim_still_replays(self):
        kw = dict(prefill_chunk=8, enable_prefix_cache=False)
        p = _prompt(20, seed=17)
        ref = _ref(p, 5, **kw)
        eng = _engine(**kw)
        sched = tserving.ServingScheduler(eng)
        a = sched.submit(p, max_new_tokens=5, priority=tserving.Priority.LOW)
        sched.step()                        # first chunk only
        assert a.slot is not None and len(a.tokens) == 0
        sched.submit(_prompt(4, seed=18), max_new_tokens=2,
                     priority=tserving.Priority.HIGH)
        sched.step()
        assert a.preemptions == 1
        assert eng.cache.swap_outs_total == 0
        sched.run()
        np.testing.assert_array_equal(a.output, ref)


class TestPrefixTier:
    def test_demote_then_promote_hit(self):
        sys_prompt = _prompt(16, seed=5)
        p1 = np.concatenate([sys_prompt, _prompt(3, seed=6)])
        p2 = np.concatenate([sys_prompt, _prompt(3, seed=7)])
        ref = _ref(p2, 4)
        eng = _engine(num_pages=6, host_tier_kw={"persist_prefix": False})
        eng.generate([p1], max_new_tokens=4)
        eng.generate([_prompt(30, seed=8)], max_new_tokens=2)
        assert eng.cache.demotions_total >= 1
        assert len(eng.cache.host) >= 1
        o2 = eng.generate([p2], max_new_tokens=4)[0]
        assert eng.cache.promote_hits_total >= 1
        np.testing.assert_array_equal(o2, ref)

    def test_restarted_engine_prefix_hits_from_standing_store(self,
                                                              tmp_path):
        import paddle_tpu_torch.observability as obs
        sys_prompt = _prompt(16, seed=9)
        p1 = np.concatenate([sys_prompt, _prompt(4, seed=10)])
        p2 = np.concatenate([sys_prompt, _prompt(4, seed=11)])
        ref = _ref(p2, 4)
        host_kw = {"prefix_store_dir": str(tmp_path)}
        _engine(host_tier_kw=host_kw).generate([p1], max_new_tokens=4)
        assert len(os.listdir(tmp_path)) == 2
        obs.REGISTRY.clear()
        obs.enable()
        try:
            eng2 = _engine(host_tier_kw=host_kw)
            o2 = eng2.generate([p2], max_new_tokens=4)[0]
            snap = obs.REGISTRY.to_json()
        finally:
            obs.disable()
            obs.REGISTRY.clear()
        assert eng2.cache.promote_hits_total == 2
        hit = sum(snap["serving_prefix_hit_tokens_total"]
                  ["values"].values())
        promoted = sum(snap["serving_prefix_promoted_pages_total"]
                       ["values"].values())
        assert hit >= 16 and promoted == 2
        np.testing.assert_array_equal(o2, ref)

    def test_promotion_under_pressure_never_aliases_trie_pages(self):
        _, cfg = _params()
        cache = tserving.TieredKVCache(cfg, 2, 32, page_size=8,
                                       num_pages=6, persist_prefix=False,
                                       device="cpu")
        p24 = _prompt(24, seed=20)
        cache.admit(0, 24)
        cache.lengths[0] = 24
        cache.register_prefix(0, p24)
        cache.release(0)
        cache._evict_prefix(1)
        assert cache.demotions_total == 1
        cache.admit(1, 24)
        assert cache.allocator.num_free == 0
        p25 = np.concatenate([p24, _prompt(1, seed=21)]).astype(np.int32)
        promoted = cache._promote_prefix(p25)

        def trie_pages():
            out, stack = [], [cache.prefix.root]
            while stack:
                node = stack.pop()
                if node.page is not None:
                    out.append(node.page)
                    assert cache.allocator.refcount(node.page) >= 1
                stack.extend(node.children.values())
            return out
        pages = trie_pages()
        assert len(pages) == len(set(pages))
        assert promoted == 0
        try:
            cache.admit_prompt(0, p25, 25)
        except tserving.PoolExhausted:
            pass
        pages = trie_pages()
        assert len(pages) == len(set(pages))

    def _corrupted_store_roundtrip(self, tmp_path, damage, seed0):
        import paddle_tpu_torch.observability as obs
        d = str(tmp_path)
        sys_prompt = _prompt(16, seed=seed0)
        p1 = np.concatenate([sys_prompt, _prompt(4, seed=seed0 + 1)])
        p2 = np.concatenate([sys_prompt, _prompt(4, seed=seed0 + 2)])
        ref = _ref(p2, 4)
        host_kw = {"prefix_store_dir": d}
        _engine(host_tier_kw=host_kw).generate([p1], max_new_tokens=4)
        files = sorted(os.listdir(d))
        assert len(files) == 2
        damage(os.path.join(d, files[0]))
        obs.REGISTRY.clear()
        obs.enable()
        try:
            eng2 = _engine(host_tier_kw=host_kw)
            o2 = eng2.generate([p2], max_new_tokens=4)[0]
            snap = obs.REGISTRY.to_json()
        finally:
            obs.disable()
            obs.REGISTRY.clear()
        np.testing.assert_array_equal(o2, ref)
        assert eng2.cache.host.quarantined_total >= 1
        assert eng2.cache.promote_hits_total < 2
        probe = tserving.HostPageStore(8, path=d)
        for f in list(os.listdir(d)):
            with np.load(os.path.join(d, f)) as data:
                raw_key = bytes(np.asarray(data["key"]))
            assert probe.get(raw_key) is not None, f
        assert probe.quarantined_total == 0
        q = sum(v for k, v in snap.get(
            "serving_integrity_events_total", {})
            .get("values", {}).items() if "quarantined" in k)
        assert q >= 1

    def test_torn_standing_store_file_replays(self, tmp_path):
        def truncate(fn):
            n = os.path.getsize(fn)
            with open(fn, "rb") as f:
                half = f.read(n // 2)
            with open(fn, "wb") as f:
                f.write(half)
        self._corrupted_store_roundtrip(tmp_path, truncate, seed0=40)

    def test_bitflipped_standing_store_file_replays(self, tmp_path):
        def bitflip(fn):
            with open(fn, "rb") as f:
                raw = bytearray(f.read())
            raw[len(raw) // 2] ^= 0xFF
            with open(fn, "wb") as f:
                f.write(bytes(raw))
        self._corrupted_store_roundtrip(tmp_path, bitflip, seed0=44)

    def test_stale_store_geometry_reads_as_miss(self, tmp_path):
        sys_prompt = _prompt(16, seed=12)
        p = np.concatenate([sys_prompt, _prompt(4, seed=13)])
        host_kw = {"prefix_store_dir": str(tmp_path)}
        _engine(host_tier_kw=host_kw).generate([p], max_new_tokens=2)
        ref = _ref(p, 4, kv_cache_dtype="int8")
        eng = _engine(kv_cache_dtype="int8", host_tier_kw=host_kw)
        out = eng.generate([p], max_new_tokens=4)[0]
        assert eng.cache.promote_hits_total == 0
        np.testing.assert_array_equal(out, ref)


def _sup_prelude(sup):
    a = sup.submit(_prompt(6, seed=2), max_new_tokens=8,
                   priority=tserving.Priority.LOW)
    while len(a.tokens) < 3:
        sup.step()
    return a


class TestResilience:
    def _sup(self):
        return tserving.EngineSupervisor(_engine, backoff_s=0.0,
                                         sleep=lambda s: None)

    def test_recovery_swaps_in_instead_of_replaying(self):
        ref = _ref(_prompt(6, seed=2), 8)
        inj = tserving.FaultInjector(seed=0)
        sup = self._sup()
        with inj:
            a = _sup_prelude(sup)
            sup.submit(_prompt(4, seed=3), max_new_tokens=2,
                       priority=tserving.Priority.HIGH)
            sup.step()
            assert sup.engine.cache.swap_outs_total == 1
            sup._sync_journal()
            entry = [e for e in sup.journal.live_entries()
                     if e.rid == a.rid]
            assert entry and entry[0].swapped
            inj.arm("decode_step", "raise", nth=1)
            sup.run()
        assert sup.recoveries == 1
        assert sup.engine.cache.swap_ins_total == 1
        assert sup.engine.cache.swap_replay_fallbacks == 0
        np.testing.assert_array_equal(a.output, ref)

    def test_fault_at_swap_in_absorbed_by_bounded_retry(self):
        ref = _ref(_prompt(6, seed=2), 8)
        inj = tserving.FaultInjector(seed=0)
        sup = self._sup()
        with inj:
            a = _sup_prelude(sup)
            sup.submit(_prompt(4, seed=3), max_new_tokens=2,
                       priority=tserving.Priority.HIGH)
            sup.step()
            inj.arm("swap_in", "raise", nth=1)
            sup.run()
        assert inj.fired["swap_in"] == 1
        assert sup.recoveries == 0
        assert sup.engine.cache.swap_in_retries_total == 1
        assert sup.engine.cache.swap_ins_total == 1
        np.testing.assert_array_equal(a.output, ref)

    def test_swap_in_retry_exhaustion_recovers_token_identically(self):
        ref = _ref(_prompt(6, seed=2), 8)
        inj = tserving.FaultInjector(seed=0)
        sup = self._sup()
        with inj:
            a = _sup_prelude(sup)
            sup.submit(_prompt(4, seed=3), max_new_tokens=2,
                       priority=tserving.Priority.HIGH)
            sup.step()
            for _ in range(3):
                inj.arm("swap_in", "raise", nth=1)
            sup.run()
        assert inj.fired["swap_in"] == 3
        assert sup.recoveries == 1
        assert sup.engine.cache.swap_in_retries_total == 2
        assert sup.engine.cache.swap_ins_total == 1
        np.testing.assert_array_equal(a.output, ref)

    def test_fault_at_swap_out_falls_back_cleanly(self):
        ref = _ref(_prompt(6, seed=2), 8)
        inj = tserving.FaultInjector(seed=0)
        sup = self._sup()
        with inj:
            a = _sup_prelude(sup)
            inj.arm("swap_out", "raise", nth=1)
            sup.submit(_prompt(4, seed=3), max_new_tokens=2,
                       priority=tserving.Priority.HIGH)
            sup.run()
        assert inj.fired["swap_out"] == 1
        assert sup.engine.cache.swap_ins_total == 0
        assert sup.engine.cache.swap_outs_total == 0
        np.testing.assert_array_equal(a.output, ref)


# ------------------------------------------------------ the port's own

def _pages(cache, slot, k):
    return {n: t.clone() for n, t in cache._fetch_pages(
        cache.pages_held(slot)[:k]).items()}


def _equal(a, b):
    assert set(a) == set(b)
    for n in a:
        assert a[n].dtype == b[n].dtype and a[n].shape == b[n].shape
        assert torch.equal(a[n].view(torch.uint8), b[n].view(torch.uint8))


@pytest.mark.parametrize("kv,dtype", [(None, torch.float32),
                                      (None, torch.bfloat16),
                                      ("int8", torch.float32)],
                         ids=["f32", "bf16", "int8"])
def test_swap_round_trip_and_defrag_are_byte_equal(kv, dtype):
    """Random page contents swap out and back in byte-equal (the pages
    land elsewhere in the pool), a non-blocking swap-out is invisible
    only until its fence, and defrag moves every live page byte-equal
    while taking fragmentation to 0."""
    _, cfg = _params()
    cfg = dataclasses.replace(cfg, dtype=dtype)
    cache = tserving.TieredKVCache(cfg, 3, 32, page_size=8, kv_dtype=kv,
                                   persist_prefix=False, device="cpu")
    g = torch.Generator().manual_seed(0)
    for name, arr in cache.pool.items():
        if arr.dtype == torch.int8:
            arr.copy_(torch.randint(-127, 128, arr.shape, generator=g))
        else:
            arr.copy_(torch.randn(arr.shape, generator=g))
    cache.admit(0, 20)
    cache.lengths[0] = 20
    cache.admit(1, 30)
    cache.lengths[1] = 17
    before = _pages(cache, 1, 3)
    cache.swap_out(1, rid=5, nonblocking=True)
    assert cache.swap_outs_total == 0 and cache.has_swapped(5)
    cache.admit(2, 8)                   # a new tenant takes freed pages
    cache.pool["k"][:, cache.pages_held(2)] = 0
    assert cache.fence_swaps() == 1 and cache.swap_outs_total == 1
    assert cache.swap_in(1, 5, 30, expect_tokens=17) == 17
    assert cache.lengths[1] == 17
    _equal(_pages(cache, 1, 3), before)
    assert cache.consume_swap_charge() == 24
    # defrag: free the middle tenant, compact, compare every live page
    cache.release(2)
    live = {s: _pages(cache, s, len(cache.pages_held(s))) for s in (0, 1)}
    assert cache.allocator.fragmentation() > 0
    cache.defrag()
    assert cache.allocator.fragmentation() == 0
    assert cache.allocator.stats()["defrags_total"] == 1
    for s in (0, 1):
        _equal(_pages(cache, s, len(cache.pages_held(s))), live[s])
        assert (cache.block_tables[s, :len(cache.pages_held(s))]
                == cache.pages_held(s)).all()
    used = sorted(p for s in (0, 1) for p in cache.pages_held(s))
    assert used == list(range(1, 1 + len(used)))


def test_planted_corrupt_swap_payload_falls_back_to_replay():
    ref = _ref(_prompt(6, seed=2), 8)
    inj = tserving.FaultInjector(seed=0)
    with inj:
        inj.arm_tamper("swap_in", nth=1)
        a, eng, _ = _swap_preempt_run()
    assert eng.cache.corruptions_detected_total == 1
    assert eng.cache.swap_replay_fallbacks == 1
    assert eng.cache.swap_ins_total == 0
    assert eng.cache.host.quarantined_total == 1
    np.testing.assert_array_equal(a.output, ref)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("direct", [False, True], ids=["staged", "direct"])
def test_handoff_between_port_engines(kv, direct):
    """A request prefilled on one engine decodes on another, through a
    host-staged payload or page to page: its pages land byte-equal and
    its tokens equal in-place decode; the source engine's pages go back
    (its trie keeps the prompt)."""
    p = _prompt(13, seed=31)
    ref = _ref(p, 6, kv_cache_dtype=kv, max_batch=2)
    src = _engine(kv_cache_dtype=kv, max_batch=2)
    dst = _engine(kv_cache_dtype=kv, max_batch=2)
    req = src.submit(p, max_new_tokens=6)
    src._admit()
    while src.pending_prefills():
        src.prefill_step()
    assert len(req.tokens) == 1
    slot = req.slot
    want = _pages(src.cache, slot, 2)
    payload = src.export_prefilled(req, with_kv=not direct)
    assert ("kv" in payload) is not direct
    assert dst.import_prefilled(req, payload,
                                src_engine=src if direct else None)
    src.finish_handoff(req, slot)
    _equal(_pages(dst.cache, req.slot, 2), want)
    assert dst.cache.direct_moves_total == int(direct)
    dst.run()
    np.testing.assert_array_equal(req.output, ref)
    for eng in (src, dst):
        ts._assert_balanced(eng)


def test_import_checks_payloads_before_allocating():
    src = _engine(max_batch=2)
    req = src.submit(_prompt(9, seed=33), max_new_tokens=3)
    src._admit()
    src.prefill_step()
    payload = src.export_prefilled(req)
    dst = _engine(max_batch=2)
    kv = payload["kv"]
    bad = dict(kv, arrays={n: a.copy() for n, a in kv["arrays"].items()})
    bad["arrays"]["k"][5] ^= 0xFF
    with pytest.raises(tres.CorruptionDetected):
        dst.import_prefilled(req, dict(payload, kv=bad))
    foreign = _engine(max_batch=2, kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="arrays"):
        foreign.import_prefilled(req, payload)
    with pytest.raises(ValueError, match="arrays"):
        foreign.import_prefilled(req, payload, src_engine=src)
    for eng in (dst, foreign):
        assert eng.cache.allocator.num_used == 0
        assert eng.cache.allocator.allocs_total == 0


def test_checksums_are_zlib_crc32():
    """The CRC both packages stamp: the port's threaded one equals
    ``zlib.crc32`` of the bytes for buffers that take one piece and
    several, so a payload either package wrote verifies in the other."""
    rs = np.random.RandomState(0)
    for n in (0, 7, (33 << 20) + 5):
        a = rs.randint(0, 256, n).astype(np.uint8)
        assert tres.payload_checksums({"a": a})["a"] == \
            jres.payload_checksums({"a": a})["a"] == \
            zlib.crc32(a.tobytes()) & 0xFFFFFFFF
