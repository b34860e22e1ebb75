"""The port's serving cluster against the JAX package's, on the CPU
(``paddle_tpu_torch/serving/cluster.py`` and ``router.py``, and the
engine and supervisor seams they drive).

- **Port against JAX**, on ``test_torch_scheduler``'s tiny f32 Llama
  (the JAX weights through ``params_from_jax``) and seeded prompts of
  three tenants, each with its own two-page system prompt:
  a 2-replica cluster with one prefill replica, KV f32 and int8, gives
  identical tokens and finish reasons, the same replica history per
  rid, the same handoff count and router statistics (affinity hits and
  misses, dispatches per replica, tenant accounts), and, with the hooks
  on, the same counters (router, handoff, prefix, scheduler) and the
  same request traces as (span, replica, slot, seq); a cluster
  ``wal_dir`` the JAX cluster wrote and abandoned recovers in the
  port's ``ServingCluster.recover_from_disk`` with the JAX engine's
  uninterrupted tokens. One cluster handoff adds 1 to the
  ``serving_handoff_*`` counters in both packages; a handoff between
  two bare engines adds nothing in either.
- **The reference's contracts, port against port**:
  ``tests/test_cluster.py`` but ``TestTpCluster`` (its chaos soak on a
  copy of the JAX soak's ``run_cluster_soak``, kept here),
  ``tests/test_host_tier.py::TestCluster``, the direct-handoff cluster
  of ``tests/test_lowbit_decode.py``, ``tests/test_wal.py::
  TestClusterColdRecovery`` and ``tests/test_tracing.py::
  TestStitching``.
- **Phase 3k's gates** (``chip_smoke.check_cluster_handles`` and
  ``check_pages_bytes``) pass a correct CPU cluster run and reject a
  doubled rid and a handoff page with one byte flipped.

The trace-driven harness, admission and the autoscaler are in
``test_torch_traffic.py``.
"""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu.observability as jobs
from paddle_tpu import serving as jserving
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.serving import (EngineDead, EngineSupervisor,
                                      FaultInjector, Priority,
                                      ServingCluster, ServingScheduler,
                                      TenantQuota, recover_state)

import test_torch_scheduler as ts
sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_constraints as tc  # noqa: E402
import test_torch_observability as tobs_t  # noqa: E402
from test_torch_observability import sinks  # noqa: E402,F401

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
MODS = {"jax": jserving, "port": tserving}
OBS = {"jax": jobs, "port": tobs}
SKW = dict(sleep=lambda s: None, backoff_s=0.0)


def _factory(side, kv=None, **kw):
    """A fresh engine of ``side`` a call, on ``test_torch_scheduler``'s
    geometry with 8-token chunks (JAX engines share their compiled
    programs: ``test_torch_constraints._engine``)."""
    return lambda: tc._engine(side, prefill_chunk=8, kv_cache_dtype=kv,
                              **kw)


def _tenant_jobs(seed=3, n=8):
    """(tenant, prompt, new) of three tenants: a two-page system prompt
    each, then a tail of 2 to 6 tokens."""
    rs = np.random.RandomState(seed)
    sysp = [rs.randint(3, 256, (16,)).astype(np.int32) for _ in range(3)]
    out = []
    for i in range(n):
        tail = rs.randint(3, 256, (int(rs.randint(2, 7)),)).astype(np.int32)
        out.append((f"t{i % 3}", np.concatenate([sysp[i % 3], tail]),
                    int(rs.randint(3, 6))))
    return out


def _drive(c, reqs):
    """Step ``c`` to the end; returns each rid's replica history (the
    distinct owners in order, read after every step)."""
    hist = {}
    while True:
        more = c.step()
        for rid, idx in c._owner.items():
            h = hist.setdefault(rid, [])
            if not h or h[-1] != idx:
                h.append(idx)
        if not more:
            break
    return hist


def _traces(reqs):
    return [[(s.name, s.replica, s.slot, s.seq) for s in r.trace.spans]
            for r in reqs]


# ------------------------------------------------------ against the JAX

def _routed(side, kv):
    c = MODS[side].ServingCluster(_factory(side, kv), replicas=2,
                                  prefill_replicas=1,
                                  supervisor_kw=dict(SKW))
    reqs = [c.submit(p, max_new_tokens=m, tenant=t)
            for t, p, m in _tenant_jobs()]
    hist = _drive(c, reqs)
    return dict(tokens=[list(map(int, r.tokens)) for r in reqs],
                reasons=[r.finish_reason for r in reqs], hist=hist,
                handoffs=c.handoffs_total, router=c.router.stats(),
                counters=tobs_t._counters(OBS[side]),
                traces=_traces(reqs)), c


@pytest.mark.parametrize("kv", [None, "int8"])
def test_disaggregated_cluster_matches_jax(sinks, kv):
    got = {}
    for side in MODS:
        OBS[side].REGISTRY.clear()
        got[side], c = _routed(side, kv)
        if side == "port":
            for sup in c.replicas:
                ts._assert_balanced(sup.engine)
    j, p = got["jax"], got["port"]
    for key in ("tokens", "reasons", "hist", "handoffs", "router",
                "counters", "traces"):
        assert p[key] == j[key], key
    assert p["handoffs"] >= 3
    assert p["router"]["affinity_hits"] >= 3
    assert all(r in ("eos", "max_len") for r in p["reasons"])
    c = p["counters"]
    # an export whose request finds no free decode slot stays unplaced
    assert c[("serving_handoff_exports_total", "")] >= p["handoffs"]
    assert c[("serving_handoff_imports_total", "")] == p["handoffs"]
    assert sum(v for k, v in c.items()
               if k[0] == "serving_router_dispatch_total") == 8


def _handoff_counts(side):
    snap = OBS[side].REGISTRY.to_json()
    return tuple(sum(snap.get(n, {}).get("values", {}).values())
                 for n in ("serving_handoff_exports_total",
                           "serving_handoff_imports_total"))


def test_handoff_hooks_count_once(sinks):
    """One cluster handoff adds exactly 1 to the export and the import
    counters in both packages; a handoff between two bare engines
    (``export_prefilled`` / ``import_prefilled`` / ``finish_handoff``)
    adds nothing in either: the cluster closes the hooks, not the
    engine."""
    p = _tenant_jobs()[1][1]
    for side in MODS:
        OBS[side].REGISTRY.clear()
        src, dst = _factory(side)(), _factory(side)()
        req = src.submit(p, max_new_tokens=4)
        while not req.tokens:
            src.step()
        payload = src.export_prefilled(req)
        assert dst.import_prefilled(req, payload)
        src.finish_handoff(req, payload["slot"])
        dst.run()
        assert req.done and _handoff_counts(side) == (0, 0), side
        c = MODS[side].ServingCluster(_factory(side), replicas=2,
                                      prefill_replicas=1,
                                      supervisor_kw=dict(SKW))
        r = c.submit(p, max_new_tokens=4)
        c.run()
        assert r.done and c.handoffs_total == 1, side
        assert _handoff_counts(side) == (1, 1), side


def _jax_refs(jobs):
    eng = _factory("jax")()
    out = []
    for p, m in jobs:
        r = eng.submit(p, max_new_tokens=m)
        eng.run()
        out.append(list(map(int, r.tokens)))
    return out


@pytest.mark.parametrize("prefill", [0, 1])
def test_jax_cluster_dir_recovers_in_port(tmp_path, prefill):
    """The JAX cluster (plain, or with a prefill replica that has
    handed sessions off) writes per-replica journals, steps four times
    and is abandoned; the port's ``recover_from_disk`` rebuilds it from
    the directory and finishes every session with the JAX engine's
    uninterrupted tokens."""
    jobs = list(zip(ts._prompts([10, 6, 14, 7], 7), [5, 6, 4, 5]))
    refs = _jax_refs(jobs)
    wd = str(tmp_path / "cluster")
    kw = dict(prefill_replicas=prefill, supervisor_kw=dict(
        SKW, wal_kw=dict(group_interval_s=0.0), checkpoint_every=4))
    jc = jserving.ServingCluster(_factory("jax"), replicas=2, wal_dir=wd,
                                 **kw)
    reqs = [jc.submit(p, max_new_tokens=m, tenant=f"t{i % 2}")
            for i, (p, m) in enumerate(jobs)]
    for _ in range(4):
        jc.step()
    assert any(r.tokens for r in reqs)
    if prefill:
        assert jc.handoffs_total >= 1
    del jc
    rec = ServingCluster.recover_from_disk(_factory("port"), wd, **kw)
    assert len(rec.replicas) == 2
    assert sorted(rec.recovered) == sorted(r.rid for r in reqs)
    rec.run()
    for req, ref in zip(reqs, refs):
        out = rec.recovered[req.rid]
        assert out.done and out.finish_reason in ("eos", "max_len")
        assert list(map(int, out.tokens)) == ref


# --------------------------------- the reference's own contracts

_KW = dict(max_batch=2, page_size=8, max_len=32, prefill_chunk=8,
           device="cpu")
_REF = {}


def _params():
    return ts._models()["port"][3], ts._models()["port"][4]


def _pfactory(kv=None, **over):
    params, cfg = _params()
    kw = dict(_KW, kv_cache_dtype=kv, **over)
    return lambda: ContinuousBatchingEngine(params, cfg, **kw)


def _prompts(seed=3, lens=(6, 12, 9, 5, 14, 7)):
    rs = np.random.RandomState(seed)
    return [rs.randint(3, 256, (n,)).astype(np.int32) for n in lens]


def _refs(kv):
    if kv not in _REF:
        eng = _pfactory(kv)()
        _REF[kv] = [np.asarray(eng.generate([p], max_new_tokens=5)[0])
                    for p in _prompts()]
    return _REF[kv]


def _cluster(kv=None, **ckw):
    ckw.setdefault("supervisor_kw", dict(SKW))
    return ServingCluster(_pfactory(kv), **ckw)


@pytest.fixture
def metrics():
    tobs.REGISTRY.clear()
    tobs.enable()
    yield
    tobs.disable()
    tobs.REGISTRY.clear()


def _counter_sum(snap, name):
    return sum(snap.get(name, {}).get("values", {}).values())


class TestRoutedIdentity:
    @pytest.mark.parametrize("kv", [None, "int8"])
    def test_routed_equals_single_engine(self, kv):
        refs = _refs(kv)
        cluster = _cluster(kv, replicas=2)
        reqs = [cluster.submit(p, max_new_tokens=5, tenant=f"t{i % 3}")
                for i, p in enumerate(_prompts())]
        cluster.run()
        for r, ref in zip(reqs, refs):
            assert r.done and r.finish_reason in ("eos", "max_len")
            assert np.array_equal(r.output, ref)
        assert len(cluster.router.dispatch_by_replica) == 2
        assert cluster.router.dispatches_total == len(reqs)
        assert not cluster._live and not cluster._owner

    def test_all_replicas_dead_raises(self):
        cluster = _cluster(replicas=1)
        cluster.replicas[0]._dead = True
        with pytest.raises(EngineDead):
            cluster.submit(_prompts()[0])


class TestHandoff:
    @pytest.mark.parametrize("kv", [None, "int8"])
    def test_handoff_bit_identity(self, kv):
        prompt = _prompts()[1]
        eng = _pfactory(kv)()
        ra = eng.create_request(prompt, max_new_tokens=5)
        eng.admit_request(ra)
        while eng._pending:
            eng.prefill_step()
        ref_payload = eng.cache.export_request(ra.slot)
        cluster = _cluster(kv, replicas=2, prefill_replicas=1)
        rb = cluster.submit(prompt, max_new_tokens=5)
        while cluster.handoffs_total == 0:
            assert cluster.step() or cluster.handoffs_total
        own = cluster.replicas[cluster._owner[rb.rid]]
        got = own.engine.cache.export_request(rb.slot)
        assert got["length"] == ref_payload["length"]
        assert got["num_pages"] == ref_payload["num_pages"]
        for name in ref_payload["arrays"]:
            assert np.array_equal(got["arrays"][name],
                                  ref_payload["arrays"][name]), name
        assert rb.rid in {e.rid for e in own.journal.live_entries()}
        cluster.run()
        assert np.array_equal(rb.output, _refs(kv)[1])

    def test_disaggregated_parity_and_fallback(self):
        refs = _refs(None)
        cluster = _cluster(replicas=2, prefill_replicas=1)
        reqs = [cluster.submit(p, max_new_tokens=5) for p in _prompts()]
        cluster.run()
        for r, ref in zip(reqs, refs):
            assert np.array_equal(r.output, ref)
        assert cluster.handoffs_total >= 1

    def test_import_validation(self):
        params, cfg = _params()
        eng = _pfactory()()
        req = eng.create_request(_prompts()[0], max_new_tokens=4)
        eng.admit_request(req)
        while eng._pending:
            eng.prefill_step()
        payload = eng.cache.export_request(req.slot)
        other = ContinuousBatchingEngine(params, cfg, max_batch=2,
                                         page_size=16, max_len=32,
                                         device="cpu")
        with pytest.raises(ValueError, match="page_size"):
            other.cache.import_request(0, payload, 16)
        other8 = _pfactory("int8")()
        with pytest.raises(ValueError, match="tiers"):
            other8.cache.import_request(0, payload, 16)
        with pytest.raises(ValueError, match="inactive"):
            eng.cache.export_request(1 - req.slot)

    def test_direct_handoff_token_identical(self):
        """``tests/test_lowbit_decode.py``'s direct-handoff cluster: page
        to page between pools, the host-staged cluster's tokens, and
        handoffs happen."""
        params, cfg = _params()

        def factory():
            return ContinuousBatchingEngine(params, cfg, max_batch=2,
                                            page_size=8, max_len=32,
                                            device="cpu")
        rs = np.random.RandomState(17)
        prompts = [rs.randint(3, 256, (n,)).astype(np.int32)
                   for n in (6, 6, 5, 5)]

        def run(direct):
            cl = ServingCluster(factory, replicas=2, prefill_replicas=1,
                                direct_handoff=direct)
            hs = [cl.submit(p, max_new_tokens=6, tenant=f"t{i}")
                  for i, p in enumerate(prompts)]
            while cl.step():
                pass
            assert cl.handoffs_total > 0
            return [np.asarray(h.output) for h in hs]

        for a, b in zip(run(False), run(True)):
            np.testing.assert_array_equal(a, b)


def _system_prompt_maker(seed, n=16):
    rs = np.random.RandomState(seed)
    sysp = rs.randint(3, 256, (n,)).astype(np.int32)
    return lambda k: np.concatenate(
        [sysp, rs.randint(3, 256, (k,)).astype(np.int32)])


class TestAffinity:
    def test_affinity_prefix_hits_counter_gated(self, metrics):
        mk = _system_prompt_maker(17)
        cluster = _cluster(replicas=2)
        cluster.submit(mk(3), max_new_tokens=4, tenant="a")
        cluster.run()
        cluster.submit(mk(4), max_new_tokens=4, tenant="a")
        cluster.run()
        assert len(cluster.router.dispatch_by_replica) == 1
        assert cluster.router.affinity_hits >= 1
        snap = tobs.REGISTRY.to_json()
        assert _counter_sum(snap, "serving_prefix_hit_tokens_total") >= 16
        aff = snap["serving_router_affinity_total"]["values"]
        assert aff.get("outcome=hit", 0) >= 1

    def test_short_prompt_has_no_affinity_key(self):
        cluster = _cluster(replicas=2)
        assert cluster.router.affinity_key(
            np.arange(5, dtype=np.int32)) is None
        key = cluster.router.affinity_key(np.arange(20, dtype=np.int32))
        assert key == np.arange(16, dtype=np.int32).tobytes()


class TestFairShareAndLimits:
    def test_fair_share_starvation_bound(self):
        cluster = _cluster(replicas=2)
        heavy = [cluster.submit(p, max_new_tokens=4, tenant="heavy")
                 for p in (_prompts() + _prompts(seed=5))[:8]]
        light = cluster.submit(_prompts()[0], max_new_tokens=4,
                               tenant="light")
        cluster.step()
        order = list(cluster._owner)
        assert order.index(light.rid) <= 1, order
        cluster.run()
        assert light.done and all(r.done for r in heavy)
        acc = cluster.router.stats()["tenant_accounts"]
        assert acc["heavy"] > acc["light"]

    def test_rate_limit_rejection(self, metrics):
        now = [0.0]
        cluster = ServingCluster(
            _pfactory(), replicas=2, clock=lambda: now[0],
            quotas={"t": TenantQuota(20, window_s=10.0)},
            supervisor_kw=dict(SKW))
        a = cluster.submit(_prompts()[0], max_new_tokens=5, tenant="t")
        b = cluster.submit(_prompts()[1], max_new_tokens=5, tenant="t")
        assert not a.done
        assert b.done and b.finish_reason == "rejected_ratelimit"
        assert b.rid not in cluster._owner
        now[0] = 11.0
        c = cluster.submit(_prompts()[1], max_new_tokens=5, tenant="t")
        assert not c.done
        cluster.run()
        assert a.done and c.done and not b.tokens
        snap = tobs.REGISTRY.to_json()
        assert _counter_sum(snap, "serving_router_ratelimited_total") == 1


class TestDegradedRouting:
    def test_router_retries_shed_work(self, metrics):
        rs = np.random.RandomState(23)
        sysp = rs.randint(3, 256, (8,)).astype(np.int32)
        p1 = np.concatenate([sysp, rs.randint(3, 256, (3,)).astype(
            np.int32)])
        cluster = _cluster(replicas=2)
        cluster.submit(p1, max_new_tokens=4, tenant="a")
        cluster.run()
        bound = cluster.router._affinity[cluster.router.affinity_key(p1)]
        sup = cluster.replicas[bound]
        for _ in range(3):
            sup._escalate()
        before = dict(cluster.router.dispatch_by_replica)
        r1 = cluster.submit(p1, max_new_tokens=4, tenant="a",
                            priority=Priority.LOW)
        cluster.run()
        assert r1.done and r1.finish_reason in ("eos", "max_len")
        after = cluster.router.dispatch_by_replica
        assert after[bound] == before.get(bound, 0) + 1
        assert after[1 - bound] == before.get(1 - bound, 0) + 1
        assert cluster.router.retries_total == 1
        snap = tobs.REGISTRY.to_json()
        assert _counter_sum(snap, "serving_router_retries_total") == 1

    def test_whole_cluster_shedding_surfaces_rejection(self):
        cluster = _cluster(replicas=2)
        for sup in cluster.replicas:
            for _ in range(3):
                sup._escalate()
        r = cluster.submit(_prompts()[0], max_new_tokens=4,
                           priority=Priority.LOW)
        cluster.step()
        assert r.done and r.finish_reason == "rejected_overload"
        assert not r.tokens


class TestLoadStats:
    def test_scheduler_load_stats_snapshot(self):
        now = [100.0]
        eng = _pfactory()()
        sched = ServingScheduler(eng, clock=lambda: now[0])
        sched.submit(_prompts()[0], max_new_tokens=4,
                     priority=Priority.HIGH, deadline_s=5.0)
        sched.submit(_prompts()[1], max_new_tokens=4,
                     priority=Priority.LOW, deadline_s=9.0)
        s = sched.load_stats()
        assert s["queue_depths"] == {0: 1, 2: 1}
        assert s["queued_total"] == 2
        assert s["running"] == 0 and s["free_slots"] == 2
        assert abs(s["oldest_deadline_slack_s"] - 5.0) < 1e-9
        assert s["pool_occupancy"] == 0.0
        assert s["degraded_level"] == 0
        assert s["degraded_mode"] == "healthy"
        sched.run()

    def test_degraded_mode_visible_without_registry(self):
        assert not tobs.metrics_enabled()
        sup = EngineSupervisor(_pfactory(), **SKW)
        sup._escalate()
        assert sup.scheduler.load_stats()["degraded_level"] == 1
        assert sup.scheduler.load_stats()["degraded_mode"] == "no_spec"
        assert sup.load_stats()["health"] == "degraded"
        assert sup.load_stats()["draining"] is False


class TestRetireReplica:
    def test_retire_mid_decode_parity_and_trie_survival(self, metrics):
        mk = _system_prompt_maker(29)
        p1, p2 = mk(3), mk(4)
        eng = _pfactory()()
        ref1 = np.asarray(eng.generate([p1], max_new_tokens=6)[0])
        ref2 = np.asarray(eng.generate([p2], max_new_tokens=6)[0])
        cluster = _cluster(replicas=2)
        r1 = cluster.submit(p1, max_new_tokens=6, tenant="a")
        for _ in range(3):
            cluster.step()
        assert r1.tokens and not r1.done
        idx = cluster._owner[r1.rid]
        summary = cluster.retire_replica(idx)
        assert summary["rehomed"] == 1
        assert cluster.retirements_total == 1
        cluster.run()
        assert np.array_equal(r1.output, ref1)
        key = cluster.router.affinity_key(p2)
        assert cluster.router._affinity[key] == idx
        hit0 = _counter_sum(tobs.REGISTRY.to_json(),
                            "serving_prefix_hit_tokens_total")
        r2 = cluster.submit(p2, max_new_tokens=6, tenant="a")
        cluster.run()
        assert np.array_equal(r2.output, ref2)
        hit1 = _counter_sum(tobs.REGISTRY.to_json(),
                            "serving_prefix_hit_tokens_total")
        assert hit1 >= hit0 + 16

    def test_retire_without_replace_needs_survivor(self):
        cluster = _cluster(replicas=1)
        with pytest.raises(ValueError, match="serviceable"):
            cluster.retire_replica(0, replace=False)
        c2 = _cluster(replicas=2)
        c2.retire_replica(0, replace=False)
        with pytest.raises(ValueError, match="serviceable"):
            c2.retire_replica(1, replace=False)


class SoakError(AssertionError):
    pass


def run_cluster_soak(seed=0, requests=12, replicas=3, max_steps=20000):
    """The JAX soak's ``run_cluster_soak`` on the port: a multi-tenant
    shared-prefix workload through a cluster of host-tiered, overlapped
    replicas while ``circuit`` armed ``sched_tick`` faults kill
    whichever replica steps next. No request lost or duplicated, every
    token stream equal to an uninterrupted engine's, affinity and
    prefix hits recover after the rebuild, allocators balance."""
    params, cfg = _params()
    rs = np.random.RandomState(seed)
    circuit = 3

    def factory():
        return ContinuousBatchingEngine(
            params, cfg, max_batch=2, page_size=8, max_len=48,
            prefill_chunk=8, host_tier=True, overlap=True, device="cpu")

    tenants = [f"tenant{i}" for i in range(3)]
    sys_prompts = {t: rs.randint(3, cfg.vocab_size, (16,)).astype(np.int32)
                   for t in tenants}

    def make_job():
        t = tenants[int(rs.randint(len(tenants)))]
        tail = rs.randint(3, cfg.vocab_size,
                          (int(rs.randint(2, 8)),)).astype(np.int32)
        return (t, np.concatenate([sys_prompts[t], tail]),
                int(rs.randint(3, 6)), Priority(int(rs.randint(0, 3))))

    jobs = [make_job() for _ in range(requests)]
    ref_engine = factory()
    refs = [np.asarray(ref_engine.generate([p], max_new_tokens=m)[0])
            for _, p, m, _ in jobs]
    tobs.REGISTRY.clear()
    tobs.enable()
    try:
        cluster = ServingCluster(
            factory, replicas=replicas,
            supervisor_kw=dict(backoff_s=0.0, sleep=lambda s: None,
                               circuit_threshold=circuit,
                               recover_after=4))
        inj = FaultInjector(seed=seed)
        reqs = []
        with inj:
            for t, p, m, prio in jobs:
                reqs.append(cluster.submit(p, max_new_tokens=m, tenant=t,
                                           priority=prio))
            steps = 0
            for _ in range(3):
                cluster.step()
                steps += 1
            for _ in range(circuit):
                inj.arm("sched_tick", "raise", nth=1)
            failovers_before = cluster.failovers_total
            hits_before = cluster.router.affinity_hits
            while cluster.step():
                steps += 1
                if steps >= max_steps:
                    raise SoakError("cluster soak did not drain")
        if cluster.failovers_total <= failovers_before:
            raise SoakError("the armed fault burst did not kill a replica")
        hit0 = _counter_sum(tobs.REGISTRY.to_json(),
                            "serving_prefix_hit_tokens_total")
        post_jobs = [make_job() for _ in range(6)]
        for t, p, m, prio in post_jobs:
            reqs.append(cluster.submit(p, max_new_tokens=m, tenant=t,
                                       priority=prio))
            jobs.append((t, p, m, prio))
        while cluster.step():
            steps += 1
            if steps >= max_steps:
                raise SoakError("post-rebuild traffic did not drain")
        for _, p, m, _ in post_jobs:
            refs.append(np.asarray(
                ref_engine.generate([p], max_new_tokens=m)[0]))
        snap = tobs.REGISTRY.to_json()
    finally:
        tobs.disable()
        tobs.REGISTRY.clear()
    lost = [r.rid for r in reqs if not r.done or r.finish_reason is None]
    if lost:
        raise SoakError(f"lost requests: {lost}")
    bad = [(r.rid, r.finish_reason) for r in reqs
           if r.finish_reason not in ("eos", "max_len", "rejected_overload")]
    if bad:
        raise SoakError(f"unstructured finish reasons: {bad}")
    for r, ref in zip(reqs, refs):
        if r.finish_reason == "rejected_overload":
            if r.tokens:
                raise SoakError(f"shed request {r.rid} has tokens")
        elif not np.array_equal(r.output, ref):
            raise SoakError(f"request {r.rid}: token stream differs from "
                            f"the uninterrupted one")
    hit1 = _counter_sum(snap, "serving_prefix_hit_tokens_total")
    if hit1 <= hit0:
        raise SoakError(f"prefix hits did not recover ({hit0} -> {hit1})")
    if cluster.router.affinity_hits <= hits_before:
        raise SoakError("router affinity hits did not advance")
    for sup in cluster.replicas:
        ts._assert_balanced(sup.engine)
    return {"failovers": cluster.failovers_total,
            "rehomed_sessions": int(_counter_sum(
                snap, "serving_router_rehomed_sessions_total")),
            "affinity_hit_rate": cluster.router.stats()["affinity_hit_rate"],
            "prefix_hit_tokens": int(hit1)}


class TestClusterChaosSoak:
    def test_cluster_soak_replica_kill(self):
        report = run_cluster_soak(seed=0, requests=12, replicas=3)
        assert report["failovers"] >= 1
        assert report["rehomed_sessions"] >= 1
        assert report["affinity_hit_rate"] > 0
        assert report["prefix_hit_tokens"] > 0


class TestHostTierCluster:
    def test_failover_rehomed_session_swaps_in_on_survivor(self):
        """``tests/test_host_tier.py::TestCluster``: one host store shared
        by the replicas, so a session swapped out on a replica that then
        dies swaps in on the replica it rehomes to."""
        params, cfg = _params()

        def engine(host=True):
            return ContinuousBatchingEngine(params, cfg, max_batch=2,
                                            page_size=8, max_len=32,
                                            host_tier=host, device="cpu")

        def prompt(n, seed):
            return np.random.RandomState(seed).randint(
                3, 256, (n,)).astype(np.int32)
        refs = [engine(False).generate([prompt(6, 2)], max_new_tokens=8)[0],
                engine(False).generate([prompt(5, 4)], max_new_tokens=4)[0]]
        cluster = ServingCluster(
            engine, replicas=2,
            supervisor_kw=dict(backoff_s=0.0, sleep=lambda s: None,
                               circuit_threshold=2, recover_after=4))
        store = cluster._host_store
        assert store is not None
        assert all(sup.engine.cache.host is store
                   for sup in cluster.replicas)
        inj = FaultInjector(seed=0)
        with inj:
            a = cluster.submit(prompt(6, 2), max_new_tokens=8, tenant="t0",
                               priority=Priority.LOW)
            b = cluster.submit(prompt(5, 4), max_new_tokens=4, tenant="t1",
                               priority=Priority.LOW)
            while len(a.tokens) < 3 or len(b.tokens) < 2:
                cluster.step()
            owner = cluster.replicas[cluster._owner[a.rid]]
            owner.engine.cache.swap_out(a.slot, a.rid)
            owner.engine._slots[a.slot] = None
            a.slot = None
            a.preemptions += 1
            a.swapped = True
            a.finish_reason = "preempted"
            owner.scheduler.requeue(a, front=True)
            for _ in range(2):
                inj.arm("sched_tick", "raise", nth=1)
            while cluster.step():
                pass
        assert cluster.failovers_total >= 1
        assert sum(s.engine.cache.swap_ins_total
                   for s in cluster.replicas) >= 1
        np.testing.assert_array_equal(a.output, refs[0])
        np.testing.assert_array_equal(b.output, refs[1])


class TestClusterColdRecovery:
    SUP = dict(backoff_s=0.0, sleep=lambda s: None,
               wal_kw=dict(group_interval_s=0.0))

    @staticmethod
    def _factory():
        params, cfg = _params()
        return lambda: ContinuousBatchingEngine(
            params, cfg, max_batch=2, page_size=8, max_len=48,
            prefill_chunk=8, device="cpu")

    def test_whole_process_death_and_recovery(self, tmp_path):
        factory = self._factory()
        jobs = list(zip(ts._prompts([10, 6, 14, 7], 7), [5, 6, 4, 5]))
        eng = factory()
        refs = []
        for p, m in jobs:
            r = eng.submit(p, max_new_tokens=m)
            eng.run()
            refs.append(np.asarray(r.output))
        wd = str(tmp_path / "cluster")
        kw = dict(supervisor_kw=dict(self.SUP, checkpoint_every=4))
        cluster = ServingCluster(factory, replicas=2, wal_dir=wd, **kw)
        reqs = [cluster.submit(p, max_new_tokens=m, tenant=f"t{i % 2}")
                for i, (p, m) in enumerate(jobs)]
        for _ in range(4):
            cluster.step()
        del cluster
        rec = ServingCluster.recover_from_disk(factory, wd, **kw)
        assert len(rec.replicas) == 2
        rec.run()
        for req, ref in zip(reqs, refs):
            out = rec.recovered.get(req.rid, req)
            assert out.done and out.finish_reason in ("eos", "max_len")
            np.testing.assert_array_equal(out.output, ref)

    def test_failover_tombstones_dead_dir(self, tmp_path):
        factory = self._factory()
        wd = str(tmp_path / "cluster")
        kw = dict(supervisor_kw=dict(self.SUP, circuit_threshold=2))
        cluster = ServingCluster(factory, replicas=2, wal_dir=wd, **kw)
        reqs = [cluster.submit(p, max_new_tokens=m) for p, m in
                zip(ts._prompts([10, 8], 8), [6, 6])]
        for _ in range(2):
            cluster.step()
        inj = FaultInjector(seed=0)
        for _ in range(2):
            inj.arm("sched_tick", "raise", nth=1)
        with inj:
            for _ in range(6):
                cluster.step()
        assert cluster.failovers_total >= 1
        cluster.run()
        for req in reqs:
            assert req.done and req.finish_reason in ("eos", "max_len")
        for sub in sorted(os.listdir(wd)):
            state = recover_state(os.path.join(wd, sub), repair=False)
            assert state["sessions"] == {}


class TestStitching:
    def test_handoff_stitches_one_trace_across_replicas(self):
        """``tests/test_tracing.py::TestStitching``: prefill on replica 0,
        decode on replica 1, one trace with the export / import pair on
        the seam, the import naming its source."""
        ttracing.enable(clock_ns=tobs_t._Clock())
        try:
            cluster = _cluster(replicas=2, prefill_replicas=1)
            r = cluster.submit(_prompts()[1], max_new_tokens=5)
            cluster.run()
        finally:
            ttracing.disable()
        assert r.done and cluster.handoffs_total >= 1
        tr = r.trace
        assert tr is not None and len(tr.replicas) == 2
        by_name = {s.name: s for s in tr.spans}
        exp, imp = by_name["handoff_export"], by_name["handoff_import"]
        assert exp.replica != imp.replica
        assert imp.meta["src"] == exp.replica
        decodes = [s for s in tr.spans if s.name == "decode_step"]
        assert decodes and all(s.replica == imp.replica for s in decodes)


# ------------------------------------------------- phase 3k's gates

def test_chip_smoke_cluster_gates_reject_planted_faults():
    """``chip_smoke.check_cluster_handles`` and ``check_pages_bytes`` on
    a CPU cluster's first handoff: both pass the real run, and reject a
    doubled rid and a handoff page with one byte flipped."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    cluster = _cluster(replicas=2, prefill_replicas=1)
    seen = chip_smoke.watch_first_handoff(cluster)
    jobs = [(p, 5) for p in _prompts()]
    handles = [cluster.submit(p, max_new_tokens=m) for p, m in jobs]
    cluster.run()
    chip_smoke.check_cluster_handles("cpu", [h.rid for h in handles],
                                     handles)
    got, want = seen["decode"], seen["payload"]
    chip_smoke.check_pages_bytes("cpu", got, want)
    with pytest.raises(SystemExit, match="lost or doubled"):
        chip_smoke.check_cluster_handles(
            "cpu", [h.rid for h in handles], handles + handles[:1])
    name = sorted(got)[0]
    flipped = dict(got)
    flipped[name] = got[name].copy()
    flipped[name].reshape(-1)[flipped[name].size // 2] ^= 0x01
    with pytest.raises(SystemExit, match="byte-equal"):
        chip_smoke.check_pages_bytes("cpu", flipped, want)
