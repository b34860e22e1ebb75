"""The port's trace-driven traffic harness, admission controller and
autoscaler against the JAX package's, on the CPU
(``paddle_tpu_torch/serving/traffic.py``, ``ClusterAutoscaler`` and
``AdmissionController``).

- **Port against JAX**: ``synth_trace`` gives the same trace, draw for
  draw, for one seed in both packages (plain, with an adapter
  population, and in text mode); ``run_trace`` of one trace through a
  cluster of one prefill replica and an autoscaled decode tier, an
  ``AdmissionController`` and a ``TenantQuota``, on
  ``test_torch_scheduler``'s tiny f32 Llama, gives the same
  ``SLOReport`` but for its two wall-clock fields, the same tokens and
  finish reasons per request, the same cluster and autoscaler
  statistics and, with the hooks on, the same counters (router, SLO,
  autoscale, handoff) and the same ``serving_replica_*`` and
  ``serving_autoscale_*`` gauges.
- **The reference's contracts, port against port**: all of
  ``tests/test_traffic.py`` (its traffic soak on a copy of the JAX
  soak's ``run_traffic_soak``, kept here) and
  ``tests/test_tracing.py::TestSLOBreakdown``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.serving import (AdmissionController,
                                      ClusterAutoscaler, FakeClock,
                                      FaultInjector, Priority,
                                      ServingCluster, run_trace, synth_trace)
from paddle_tpu_torch.serving.resilience import CLUSTER_SITES, SITES
from paddle_tpu_torch.serving.traffic import REJECTED_REASONS

import test_torch_scheduler as ts
sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_constraints as tc  # noqa: E402
import test_torch_observability as tobs_t  # noqa: E402
from test_torch_cluster import (MODS, OBS, SKW, _counter_sum,  # noqa: E402
                                _params, metrics)  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture
def metrics_both():
    """Metrics on in both packages, registries cleared; off and cleared
    afterwards (request tracing stays off: its clock is not compared)."""
    for obs in OBS.values():
        obs.REGISTRY.clear()
        obs.enable()
    yield
    for obs in OBS.values():
        obs.disable()
        obs.REGISTRY.clear()


# ------------------------------------------------------ against the JAX

TRACES = {
    "plain": dict(seed=5, duration_s=4.0, base_rps=10, tenants=3,
                  page_size=8),
    "adapters": dict(seed=2, duration_s=3.0, base_rps=8, tenants=4,
                     page_size=16, prefix_pages=3, vocab=32000,
                     adapters=5, deadline_frac=0.3),
    "text": dict(seed=9, duration_s=2.0, base_rps=6, tenants=2,
                 page_size=8, vocab=512, text=True),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_synth_trace_matches_jax(name):
    got = {side: MODS[side].synth_trace(**TRACES[name]) for side in MODS}
    assert len(got["port"]) == len(got["jax"]) > 5
    for a, b in zip(got["port"], got["jax"]):
        assert (a.arrival_s, a.tenant, a.max_new_tokens, a.priority,
                a.deadline_s, a.adapter_id) == (
            b.arrival_s, b.tenant, b.max_new_tokens, b.priority,
            b.deadline_s, b.adapter_id)
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.prompt.dtype == b.prompt.dtype


def _traffic(side):
    mod = MODS[side]
    trace = mod.synth_trace(seed=11, duration_s=3.0, base_rps=8, tenants=3,
                            page_size=8, vocab=256, burst_mult=4.0,
                            deadline_frac=0.5, deadline_s=(0.3, 1.5))
    clock = mod.FakeClock()
    auto = mod.ClusterAutoscaler(min_replicas=1, max_replicas=3,
                                 up_backlog_per_replica=3.0,
                                 down_backlog_per_replica=0.5, up_after=1,
                                 down_after=4, cooldown_ticks=3)
    cluster = mod.ServingCluster(
        lambda: tc._engine(side, prefill_chunk=8), replicas=2,
        prefill_replicas=1, clock=clock, autoscaler=auto,
        admission=mod.AdmissionController(tokens_per_s=100.0),
        quotas={"tenant0": mod.TenantQuota(60, window_s=1.0)},
        supervisor_kw=dict(SKW))
    reqs = []
    report = mod.run_trace(cluster, trace, clock, step_dt=0.05,
                           on_submit=lambda tr, req: reqs.append(req))
    rep = report.as_dict()
    rep.pop("wall_s")
    rep.pop("goodput_tokens_per_s")
    stats = cluster.stats()
    snap = OBS[side].REGISTRY.to_json()
    gauges = {(n, k): v for n, m in snap.items() if m["kind"] == "gauge"
              and n.startswith(("serving_replica_", "serving_autoscale_"))
              for k, v in m["values"].items()}
    return dict(report=rep, tokens=[list(map(int, r.tokens)) for r in reqs],
                reasons=[r.finish_reason for r in reqs],
                stats={k: stats[k] for k in (
                    "replicas", "replicas_serviceable", "cluster_steps",
                    "handoffs_total", "retirements_total",
                    "deadline_cancels_total", "router", "autoscaler")},
                counters=tobs_t._counters(OBS[side]), gauges=gauges)


def test_run_trace_matches_jax(metrics_both):
    got = {side: _traffic(side) for side in MODS}
    j, p = got["jax"], got["port"]
    for key in ("report", "tokens", "reasons", "stats", "counters",
                "gauges"):
        assert p[key] == j[key], key
    rep = p["report"]
    assert rep["lost"] == 0 and rep["completed"] > 0
    assert rep["autoscale_up"] >= 1 and rep["autoscale_down"] >= 1
    assert rep["rejected"].get("rejected_ratelimit", 0) >= 1
    assert rep["rejected"].get("rejected_infeasible", 0) >= 1
    assert p["stats"]["handoffs_total"] >= 1
    names = {k[0] for k in p["counters"]}
    for n in ("serving_router_dispatch_total",
              "serving_autoscale_events_total",
              "serving_slo_tokens_total", "serving_slo_deadline_total",
              "serving_router_ratelimited_total",
              "serving_slo_rejected_infeasible_total",
              "serving_handoff_exports_total"):
        assert n in names, n


# --------------------------------- the reference's own contracts

_CFG_KW = dict(max_batch=2, page_size=8, max_len=48, prefill_chunk=8,
               device="cpu")


def _factory(host=False):
    params, cfg = _params()
    return lambda: ContinuousBatchingEngine(params, cfg, host_tier=host,
                                            **_CFG_KW)


class TestSynthTrace:
    def test_deterministic_and_bursty(self):
        a = synth_trace(seed=5, duration_s=4.0, base_rps=10, tenants=3,
                        page_size=8)
        b = synth_trace(seed=5, duration_s=4.0, base_rps=10, tenants=3,
                        page_size=8)
        assert len(a) == len(b) and len(a) > 10
        for x, y in zip(a, b):
            assert x.arrival_s == y.arrival_s and x.tenant == y.tenant
            np.testing.assert_array_equal(x.prompt, y.prompt)
            assert (x.max_new_tokens, x.priority, x.deadline_s) == \
                (y.max_new_tokens, y.priority, y.deadline_s)
        c = synth_trace(seed=6, duration_s=4.0, base_rps=10, tenants=3,
                        page_size=8)
        assert [t.arrival_s for t in c] != [t.arrival_s for t in a]
        b0, b1 = 0.35 * 4.0, (0.35 + 0.25) * 4.0
        burst = sum(1 for t in a if b0 <= t.arrival_s < b1)
        assert burst / (b1 - b0) > len(a) / 4.0
        by_tenant = {}
        for t in a:
            by_tenant.setdefault(t.tenant, []).append(t)
        two = next(v for v in by_tenant.values() if len(v) >= 2)
        np.testing.assert_array_equal(two[0].prompt[:16], two[1].prompt[:16])

    def test_rejects_bad_params(self):
        with pytest.raises(ValueError):
            synth_trace(duration_s=0)
        with pytest.raises(ValueError):
            synth_trace(base_rps=0)


class TestAutoscalerPolicy:
    def test_hysteresis_and_cooldown(self):
        a = ClusterAutoscaler(min_replicas=1, max_replicas=3,
                              up_backlog_per_replica=4.0,
                              down_backlog_per_replica=1.0,
                              up_after=2, down_after=2, cooldown_ticks=3)
        assert a.decide(10.0, 1, 0) is None
        assert a.decide(10.0, 1, 0) == "up"
        for _ in range(3):
            assert a.decide(10.0, 2, 0) is None
        assert a.decide(10.0, 2, 0) is None
        assert a.decide(10.0, 2, 0) == "up"
        a2 = ClusterAutoscaler(min_replicas=1, max_replicas=3,
                               up_backlog_per_replica=4.0,
                               down_backlog_per_replica=1.0,
                               up_after=1, down_after=1, cooldown_ticks=0)
        for _ in range(10):
            assert a2.decide(2.0, 2, 0) is None
        assert a2.decide(10.0, 3, 0) is None
        assert a2.decide(0.0, 1, 0) is None
        assert a2.decide(0.0, 2, 2) == "up"

    def test_threshold_validation(self):
        with pytest.raises(ValueError):
            ClusterAutoscaler(min_replicas=2, max_replicas=1)
        with pytest.raises(ValueError):
            ClusterAutoscaler(up_backlog_per_replica=1.0,
                              down_backlog_per_replica=1.0)


class TestAutoscalerSoak:
    def test_scales_up_and_down_token_identically(self):
        params, cfg = _params()
        trace = synth_trace(seed=11, duration_s=3.0, base_rps=8, tenants=3,
                            page_size=8, vocab=cfg.vocab_size,
                            burst_mult=4.0, deadline_frac=0.0)

        def run(autoscale):
            clock = FakeClock()
            auto = (ClusterAutoscaler(
                min_replicas=1, max_replicas=3, up_backlog_per_replica=3.0,
                down_backlog_per_replica=0.5, up_after=1, down_after=4,
                cooldown_ticks=3) if autoscale else None)
            cluster = ServingCluster(
                _factory(), replicas=1 if autoscale else 2, clock=clock,
                autoscaler=auto, supervisor_kw=SKW)
            got = []
            report = run_trace(cluster, trace, clock, step_dt=0.05,
                               on_submit=lambda tr, req: got.append(req))
            return cluster, report, got

        cluster, report, reqs = run(autoscale=True)
        assert report.lost == 0
        assert report.autoscale_up >= 1, "never scaled up on backlog"
        assert report.autoscale_down >= 1, "never scaled back down"
        assert cluster.stats()["replicas_serviceable"] < \
            cluster.autoscaler.max_replicas
        _, ref_report, ref_reqs = run(autoscale=False)
        assert ref_report.lost == 0
        for r, ref in zip(reqs, ref_reqs):
            assert r.done and ref.done
            np.testing.assert_array_equal(r.output, ref.output)
        for sup in cluster.replicas:
            if sup.health == "dead" or sup._draining:
                continue
            ts._assert_balanced(sup.engine)

    def test_autoscale_tick_fault_skips_one_decision(self):
        params, cfg = _params()
        clock = FakeClock()
        cluster = ServingCluster(
            _factory(), replicas=1, clock=clock,
            autoscaler=ClusterAutoscaler(min_replicas=1, max_replicas=2,
                                         up_backlog_per_replica=1.0,
                                         down_backlog_per_replica=0.5,
                                         up_after=1, cooldown_ticks=0),
            supervisor_kw=SKW)
        inj = FaultInjector(seed=0)
        inj.arm("autoscale_tick", "raise", nth=1)
        with inj:
            rs = np.random.RandomState(0)
            reqs = [cluster.submit(
                rs.randint(3, cfg.vocab_size, (6,)).astype(np.int32),
                max_new_tokens=4) for _ in range(6)]
            cluster.run()
        assert inj.fired["autoscale_tick"] == 1
        assert cluster.autoscale_faults_total == 1
        assert all(r.done and r.finish_reason in ("eos", "max_len")
                   for r in reqs)


class TestAdmissionController:
    def test_infeasible_deadline_rejected_at_door(self, metrics):
        params, cfg = _params()
        clock = FakeClock()
        cluster = ServingCluster(
            _factory(), replicas=1, clock=clock,
            admission=AdmissionController(tokens_per_s=1000.0),
            supervisor_kw=SKW)
        rs = np.random.RandomState(1)
        p = rs.randint(3, cfg.vocab_size, (10,)).astype(np.int32)
        bad = cluster.submit(p, max_new_tokens=4, deadline_s=0.001)
        assert bad.done and bad.finish_reason == "rejected_infeasible"
        assert not bad.tokens
        ok = cluster.submit(p, max_new_tokens=4, deadline_s=30.0)
        assert not ok.done
        cluster.run()
        assert ok.finish_reason in ("eos", "max_len")
        assert cluster.router.slo_rejected_total == 1
        snap = tobs.REGISTRY.to_json()
        assert _counter_sum(snap,
                            "serving_slo_rejected_infeasible_total") == 1
        assert _counter_sum(snap, "serving_cancellations_total") >= 1

    def test_feasibility_uses_backlog(self):
        ctl = AdmissionController(tokens_per_s=100.0)
        idle = [{"queued_tokens": 0, "inflight_tokens": 0}]
        busy = [{"queued_tokens": 1000, "inflight_tokens": 0}]
        assert ctl.feasible(0.5, 10, idle)
        assert not ctl.feasible(0.5, 10, busy)
        assert ctl.feasible(None, 10, busy)
        assert AdmissionController(None).feasible(0.5, 10, busy)
        assert not AdmissionController(None).feasible(0.0, 10, idle)


class TestRetryBudget:
    def _shed_cluster(self, replicas=3):
        cluster = ServingCluster(_factory(), replicas=replicas,
                                 supervisor_kw=SKW)
        for sup in cluster.replicas:
            for _ in range(3):
                sup._escalate()
        return cluster

    def test_budget_bounds_redispatches(self, metrics):
        cluster = self._shed_cluster(replicas=3)
        cluster.router.tenant_retry_cap = 100.0
        r = cluster.submit(np.arange(3, 9, dtype=np.int32),
                           max_new_tokens=4, priority=Priority.LOW)
        cluster.step()
        assert r.done and r.finish_reason == "rejected_overload"
        assert cluster.router.retries_total == 2
        assert cluster.router.retry_exhausted_total == 1
        snap = tobs.REGISTRY.to_json()
        assert _counter_sum(snap, "serving_router_retries_total") == 2
        assert _counter_sum(snap,
                            "serving_router_retry_exhausted_total") == 1

    def test_tenant_retry_rate_cap(self):
        params, cfg = _params()
        cluster = self._shed_cluster(replicas=2)
        cluster.router.tenant_retry_cap = 0.25
        rs = np.random.RandomState(3)
        for _ in range(6):
            cluster.submit(rs.randint(3, cfg.vocab_size, (4,)).astype(
                np.int32), max_new_tokens=2, tenant="noisy",
                priority=Priority.LOW)
            cluster.step()
        d = cluster.router.dispatch_by_tenant["noisy"]
        retries = cluster.router.retries_by_tenant.get("noisy", 0)
        assert retries <= max(1, 0.25 * d)
        assert cluster.router.retry_exhausted_total >= 1


class TestHandoffIntegrity:
    def _cluster(self, **kw):
        return ServingCluster(_factory(), replicas=2, prefill_replicas=1,
                              retry_sleep=lambda s: None, supervisor_kw=SKW,
                              **kw)

    def _run_one(self, cluster, seed=7, n=10, m=6):
        params, cfg = _params()
        rs = np.random.RandomState(seed)
        p = rs.randint(3, cfg.vocab_size, (n,)).astype(np.int32)
        r = cluster.submit(p, max_new_tokens=m)
        cluster.run()
        ref = np.asarray(_factory()().generate([p], max_new_tokens=m)[0])
        return r, ref

    def test_corrupt_handoff_detected_and_replica_keeps_serving(self,
                                                                metrics):
        cluster = self._cluster()
        inj = FaultInjector(seed=0)
        inj.arm_tamper("handoff_export", nth=1)
        with inj:
            r, ref = self._run_one(cluster)
        assert cluster.handoff_corruptions_total == 1
        assert r.done and r.finish_reason in ("eos", "max_len")
        np.testing.assert_array_equal(r.output, ref)
        snap = tobs.REGISTRY.to_json()
        assert _counter_sum(snap, "serving_integrity_events_total") >= 2
        for sup in cluster.replicas:
            ts._assert_balanced(sup.engine)

    def test_transient_import_fault_retries_idempotently(self):
        cluster = self._cluster()
        inj = FaultInjector(seed=0)
        inj.arm("handoff_import", "raise", nth=1)
        with inj:
            r, ref = self._run_one(cluster)
        assert inj.fired["handoff_import"] == 1
        assert cluster.handoff_retries_total == 1
        assert cluster.handoffs_total >= 1
        np.testing.assert_array_equal(r.output, ref)
        for sup in cluster.replicas:
            ts._assert_balanced(sup.engine)

    def test_export_payload_checksummed_and_verified(self):
        from paddle_tpu_torch.serving.resilience import CorruptionDetected
        eng = _factory()()
        eng.submit(np.arange(3, 12, dtype=np.int32), max_new_tokens=4)
        eng.run()
        r2 = eng.submit(np.arange(3, 12, dtype=np.int32), max_new_tokens=4)
        while not r2.tokens:
            eng.step()
        payload = eng.cache.export_request(r2.slot)
        assert set(payload["checksums"]) == set(payload["arrays"])
        dst = _factory()()
        name = sorted(payload["arrays"])[0]
        bad = dict(payload)
        bad["arrays"] = {n: np.array(a, copy=True)
                         for n, a in payload["arrays"].items()}
        bad["arrays"][name][0] ^= 0xFF
        used_before = dst.cache.allocator.num_used
        with pytest.raises(CorruptionDetected):
            dst.cache.import_request(0, bad, 16)
        assert dst.cache.allocator.num_used == used_before
        dst.cache.import_request(0, payload, 16)


class TestSwapIntegrity:
    def test_tampered_swap_payload_quarantined_and_replayed(self, metrics):
        params, cfg = _params()

        def one_slot(host):
            return lambda: ContinuousBatchingEngine(
                params, cfg, max_batch=1, page_size=8, max_len=32,
                host_tier=host, device="cpu")
        ref = one_slot(False)().generate(
            [np.arange(3, 9, dtype=np.int32)], max_new_tokens=8)[0]
        sup = tserving.EngineSupervisor(one_slot(True), **SKW)
        inj = FaultInjector(seed=0)
        with inj:
            a = sup.submit(np.arange(3, 9, dtype=np.int32),
                           max_new_tokens=8, priority=Priority.LOW)
            while len(a.tokens) < 3:
                sup.step()
            sup.submit(np.arange(3, 7, dtype=np.int32), max_new_tokens=2,
                       priority=Priority.HIGH)
            sup.step()
            inj.arm_tamper("swap_in", nth=1)
            sup.run()
        cache = sup.engine.cache
        assert inj.fired["swap_in"] == 1
        assert cache.corruptions_detected_total == 1
        assert cache.host.quarantined_total == 1
        assert cache.swap_replay_fallbacks == 1
        assert cache.swap_ins_total == 0
        assert sup.recoveries == 0
        np.testing.assert_array_equal(a.output, ref)
        snap = tobs.REGISTRY.to_json()
        assert _counter_sum(snap, "serving_integrity_events_total") >= 3


class TestClusterSites:
    def test_sites_registered(self):
        for s in ("handoff_export", "handoff_import", "autoscale_tick"):
            assert s in CLUSTER_SITES and s in SITES


class SoakError(AssertionError):
    pass


def run_traffic_soak(seed=0, duration_s=3.0, base_rps=8.0,
                     max_steps=40000):
    """The JAX soak's ``run_traffic_soak`` on the port: ``synth_trace``
    against an autoscaling, disaggregated cluster of host-tiered,
    overlapped replicas with adapter pools, a tamper shot at
    ``handoff_export`` and ``swap_in``, a raise at ``handoff_import``
    and ``autoscale_tick``. Nothing lost, every served stream equal to
    an uninterrupted engine's, both scale transitions, every corruption
    detected and quarantined, allocators balanced."""
    params, cfg = _params()
    registry = tserving.AdapterRegistry(cfg)
    for aid in (1, 2, 3):
        registry.register(aid, tserving.init_lora(cfg, 4, seed=200 + aid))

    def factory():
        return ContinuousBatchingEngine(
            params, cfg, max_batch=2, page_size=8, max_len=48,
            prefill_chunk=8, host_tier=True, overlap=True,
            adapters=dict(slots=2, rank=4, registry=registry), device="cpu")

    trace = synth_trace(
        seed=seed, duration_s=duration_s, base_rps=base_rps, tenants=3,
        page_size=8, prefix_pages=2, vocab=cfg.vocab_size, burst_mult=5.0,
        new_tokens=(6, 12), priority_weights=(0.3, 0.4, 0.3),
        deadline_frac=0.3, deadline_s=(1.5, 4.0), adapters=3)
    tobs.REGISTRY.clear()
    tobs.enable()
    try:
        clock = FakeClock()
        auto = ClusterAutoscaler(
            min_replicas=1, max_replicas=3, up_backlog_per_replica=3.0,
            down_backlog_per_replica=0.5, up_after=1, down_after=4,
            cooldown_ticks=3)
        cluster = ServingCluster(
            factory, replicas=2, prefill_replicas=1, clock=clock,
            autoscaler=auto, admission=AdmissionController(tokens_per_s=None),
            retry_sleep=lambda s: None,
            supervisor_kw=dict(backoff_s=0.0, sleep=lambda s: None,
                               circuit_threshold=8, recover_after=8))
        inj = FaultInjector(seed=seed)
        inj.arm_tamper("handoff_export", nth=1)
        inj.arm_tamper("swap_in", nth=1)
        inj.arm("handoff_import", "raise", nth=2)
        inj.arm("autoscale_tick", "raise", nth=4)
        submitted = []
        with inj:
            report = run_trace(
                cluster, trace, clock, step_dt=0.05, max_steps=max_steps,
                on_submit=lambda tr, req: submitted.append((tr, req)))
    finally:
        tobs.disable()
        tobs.REGISTRY.clear()
    ref_engine = factory()
    if report.lost:
        raise SoakError(f"lost requests: {report.lost}")
    declined = set(REJECTED_REASONS) | {"deadline_exceeded"}
    for tr, req in submitted:
        if not req.done or req.finish_reason is None:
            raise SoakError(f"request {req.rid} not done after the drain")
        if req.finish_reason in declined:
            if req.tokens:
                raise SoakError(f"declined request {req.rid} has tokens")
            continue
        ref = ref_engine.submit(tr.prompt, max_new_tokens=tr.max_new_tokens,
                                adapter_id=tr.adapter_id)
        ref_engine.run()
        if not np.array_equal(req.output, ref.output):
            raise SoakError(f"request {req.rid}: token stream differs from "
                            f"the uninterrupted one")
    if not (auto.up_events >= 1 and auto.down_events >= 1):
        raise SoakError(f"autoscaler did not breathe: up={auto.up_events} "
                        f"down={auto.down_events}")
    for site in ("handoff_export", "handoff_import", "autoscale_tick"):
        if not inj.fired.get(site):
            raise SoakError(f"cluster site never fired: {site}")
    if cluster.handoff_corruptions_total < 1 \
            or cluster.handoff_retries_total < 1 \
            or cluster.autoscale_faults_total < 1:
        raise SoakError("an armed cluster fault was not absorbed")
    store = cluster._host_store
    swap_tampers = sum(1 for s, m, _ in inj.log
                       if s == "swap_in" and m == "tamper")
    if swap_tampers and (store is None
                         or store.quarantined_total < swap_tampers):
        raise SoakError("a tampered swap payload was not quarantined")
    for sup in cluster.replicas:
        if sup.health != "dead" and not sup._draining:
            ts._assert_balanced(sup.engine)
    return {"report": report.as_dict(), "autoscale": auto.stats(),
            "handoff_corruptions": cluster.handoff_corruptions_total,
            "handoff_retries": cluster.handoff_retries_total}


class TestTrafficChaosSoak:
    def test_traffic_soak(self):
        report = run_traffic_soak(seed=0)
        assert report["autoscale"]["up_events"] >= 1
        assert report["autoscale"]["down_events"] >= 1
        assert report["handoff_corruptions"] >= 1
        assert report["handoff_retries"] >= 1
        assert report["report"]["lost"] == 0


class TestSLOBreakdown:
    """``tests/test_tracing.py::TestSLOBreakdown``."""

    def _cluster(self, replicas, clock):
        params, cfg = _params()
        return ServingCluster(
            lambda: ContinuousBatchingEngine(params, cfg, max_batch=2,
                                             page_size=8, max_len=32,
                                             prefill_chunk=8, device="cpu"),
            replicas=replicas, clock=clock, supervisor_kw=dict(SKW))

    def test_report_carries_ttft_breakdown(self):
        ttracing.enable()
        try:
            trace = synth_trace(seed=7, duration_s=1.0, base_rps=6,
                                tenants=2, page_size=8, vocab=256,
                                deadline_frac=0.0)
            clock = FakeClock()
            report = run_trace(self._cluster(2, clock), trace, clock,
                               step_dt=0.05)
        finally:
            ttracing.disable()
        assert report.completed > 0
        bd = report.ttft_breakdown
        assert bd is not None
        for ph in ("queue_ms", "prefill_ms", "handoff_ms", "swap_ms",
                   "sched_overhead_ms", "ttft_ms"):
            assert set(bd[ph]) == {"p50_ms", "p99_ms"}
            assert bd[ph]["p99_ms"] >= bd[ph]["p50_ms"] >= 0
        d = report.as_dict()["ttft_breakdown"]
        assert d["ttft_ms"]["p50_ms"] == round(bd["ttft_ms"]["p50_ms"], 3)

    def test_report_breakdown_none_when_disabled(self):
        trace = synth_trace(seed=7, duration_s=0.5, base_rps=4, tenants=1,
                            page_size=8, vocab=256, deadline_frac=0.0)
        clock = FakeClock()
        report = run_trace(self._cluster(1, clock), trace, clock,
                           step_dt=0.05)
        assert report.ttft_breakdown is None
        assert report.as_dict()["ttft_breakdown"] is None
