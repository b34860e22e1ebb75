"""The port's supervised fault recovery against the JAX package's, on the
CPU (``paddle_tpu_torch/serving/resilience.py`` and the fault points in
the engine, the scheduler and the allocator).

- the site tuples, the degraded ladder, the error classes, the
  ``FaultInjector`` (armed, rate-fired, ``max_faults``, tamper shots)
  and the ``RequestJournal`` equal the reference's;
- recovery per site, port against port: a ``raise`` fault at every
  engine site the port has, at KV f32 and int8, recovers
  token-identically to the port's own uninterrupted run (whose parity
  with JAX ``test_torch_scheduler`` holds). Each site runs on an engine
  that reaches it: n-gram ``spec_k`` for ``verify_step``, a draft model
  for ``draft_propose``, a draft tree for ``tree_verify``, the
  overlapped pipeline for ``dispatch``, ``commit`` and ``transfer``,
  the host tier for ``swap_out`` and ``swap_in`` (whose bounded retry
  absorbs two shots, so the third one recovers), a one-slot adapter
  pool shared by every engine of the run, its requests on adapters 1,
  2, 1 and 3, for ``adapter_load`` and ``adapter_promote``, a
  supervisor with a write-ahead log for ``wal_append``, ``wal_fsync``
  and ``checkpoint_write`` (``tests/test_torch_wal.py`` kills the
  process at every site instead).
  Also ``corrupt`` at ``transfer``, a watchdog stall and several faults
  in one run;
- one supervised fault run, the degraded ladder and the circuit
  breaker are held to the JAX ``EngineSupervisor``: tokens, finish
  reasons, ``stats()``, the rung after every step;
- drain and restore round-trip (KV f32 and int8) with prefix hits and
  token-identical finishes; ``PrefixCache.to_records`` equals the
  reference's for the same inserts;
- the site lint: every site of ``ENGINE_SITES`` has its
  ``fault_point("<site>")`` calls in ``paddle_tpu_torch/`` where the
  JAX package has its own, and no site waits for a module any more.

The tiny f32 Llama and engine geometry are ``test_torch_scheduler``'s.
"""
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.serving import resilience as jres
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.serving import resilience as tres

import test_torch_scheduler as ts
sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_constraints as tc  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
MODS = {"jax": jserving, "port": tserving}
PORT_SITES = [s for s in tres.ENGINE_SITES if s not in tres.WAITING_SITES]
_MOTIF = np.asarray([7, 11, 13], np.int32)
_BASE = {}


def _prompts():
    a, b, c = ts._prompts((5, 11, 3), seed=3)
    return [a, np.tile(_MOTIF, 5)[:13], b, c]


def _repeat_last(mod, k):
    """Always-draft speculator (the reference's chaos soak's): the last
    token repeated, so a verify runs every step."""
    class _RepeatLast(mod.Speculator):
        def propose(self, slot, rid, history, cap=None):
            n = self.max_k if cap is None else min(self.max_k, int(cap))
            if n <= 0 or len(history) == 0:
                return np.zeros((0,), np.int32)
            return np.full((n,), history[-1], np.int32)
    return _RepeatLast(k)


def _adapter_pool(side):
    """A one-slot adapter pool over a host store, with three rank-4
    adapters registered, so that ``_serve``'s adapter requests load,
    demote and promote."""
    mod = MODS[side]
    cfg = ts._models()[side][4]
    reg = mod.AdapterRegistry(cfg)
    for aid in (1, 2, 3):
        reg.register(aid, mod.init_lora(cfg, 4, seed=40 + aid))
    return mod.AdapterPool(cfg, slots=1, rank=4, registry=reg,
                           store=mod.HostPageStore(page_size=8),
                           **({"device": "cpu"} if side == "port" else {}))


def _factory(side, repeat_last=False, adapters=False, **kw):
    if adapters:
        # one pool for every engine the supervisor builds
        pool = _adapter_pool(side)
        return lambda: tc._engine(side, adapters=pool, **kw)
    if repeat_last:
        return lambda: tc._engine(side, speculator=_repeat_last(
            MODS[side], kw["spec_k"]), **kw)
    return lambda: tc._engine(side, **kw)


def _serve(side, kw, inj=None, new=6, **sup_kw):
    """A NORMAL, a repetitive LOW and a NORMAL request, then a HIGH one
    after three steps (it preempts the LOW one), under a supervisor; on
    adapters ``ADAPTER_IDS`` when ``kw`` asks for a pool."""
    sup_kw.setdefault("sleep", lambda s: None)
    sup_kw.setdefault("token_budget", 20)
    sup = MODS[side].EngineSupervisor(_factory(side, **kw), **sup_kw)
    P = MODS[side].Priority
    prios = (P.NORMAL, P.LOW, P.NORMAL, P.HIGH)
    aids = ADAPTER_IDS if kw.get("adapters") else (0,) * 4
    inj = inj or MODS[side].FaultInjector()
    rungs = []
    with inj:
        reqs = [sup.submit(p, max_new_tokens=new, priority=pr,
                           adapter_id=aid)
                for p, pr, aid in zip(_prompts()[:3], prios, aids)]
        for _ in range(3):
            sup.step()
            rungs.append(sup.degraded_level)
        reqs.append(sup.submit(_prompts()[3], max_new_tokens=new,
                               priority=prios[3], adapter_id=aids[3]))
        while sup.step():
            rungs.append(sup.degraded_level)
            assert len(rungs) < 300
    return sup, reqs, inj, rungs


def _tokens(reqs):
    return [list(map(int, r.tokens)) for r in reqs]


#: the adapter of each of ``_serve``'s requests on a one-slot pool
ADAPTER_IDS = (1, 2, 1, 3)
SITE_KW = {"verify_step": dict(spec_k=2, repeat_last=True),
           "draft_propose": dict(spec_k=2, draft_layers=1),
           "tree_verify": dict(draft_layers=1, spec_tree=(2, 2)),
           "dispatch": dict(overlap=True), "commit": dict(overlap=True),
           "transfer": dict(overlap=True),
           "swap_out": dict(host_tier=True), "swap_in": dict(host_tier=True),
           "adapter_load": dict(adapters=True),
           "adapter_promote": dict(adapters=True),
           "wal_append": dict(wal=True), "wal_fsync": dict(wal=True),
           "checkpoint_write": dict(wal=True)}
#: (nth call, shots) per site where the default (3rd call, one shot)
#: does not reach a recovery: the one swap-out, swap-in and adapter
#: promotion of the run, swap_in's bounded retry absorbs two shots, and
#: the first three appends are the submits (a fault there rejects the
#: submission, before any step), so the fifth is the second step's
SITE_SHOTS = {"swap_out": (1, 1), "swap_in": (1, 3),
              "adapter_promote": (1, 1), "wal_append": (5, 1)}


def _base(kw):
    key = tuple(sorted(kw.items()))
    if key not in _BASE:
        _BASE[key] = _tokens(_serve("port", kw)[1])
    return _BASE[key]


@pytest.fixture
def metrics():
    tobs.REGISTRY.clear()
    tobs.enable()
    yield tobs.REGISTRY
    tobs.disable()
    tobs.REGISTRY.clear()


def _counter(reg, name, labels=""):
    m = reg.to_json().get(name)
    return 0 if m is None else m["values"].get(labels, 0)


# ------------------------------------------------------ against the JAX

def test_sites_ladder_and_errors_match_jax():
    for name in ("ENGINE_SITES", "CLUSTER_SITES", "SITES",
                 "DEGRADED_MODES"):
        assert getattr(tres, name) == getattr(jres, name), name
    assert set(tres.WAITING_SITES) <= set(tres.ENGINE_SITES)
    for make in (lambda m: m.InjectedFault("alloc", "stall", "x"),
                 lambda m: m.CorruptionDetected("transfer"),
                 lambda m: m.StepStalled(0.25)):
        j, t = make(jres), make(tres)
        assert (str(t), t.site, t.mode) == (str(j), j.site, j.mode)
    a = {n: np.arange(6, dtype=np.int32).reshape(2, 3) for n in "kv"}
    ck = tres.payload_checksums(a)
    assert ck == jres.payload_checksums(a)
    tres.verify_checksums(a, ck, "swap_in")
    bad = dict(a, v=a["v"] + 1)
    for mod in (tres, jres):
        with pytest.raises(mod.CorruptionDetected, match="mismatch"):
            mod.verify_checksums(bad, ck, "swap_in")
        with pytest.raises(mod.CorruptionDetected, match="lost"):
            mod.verify_checksums({"k": a["k"]}, ck, "swap_in")


def _fire_log(mod, seed):
    inj = mod.FaultInjector(seed=seed, rate=0.3, max_faults=5,
                            modes=("raise", "corrupt"),
                            sites=["alloc", "decode_step", "commit"])
    inj.arm("transfer", "raise", nth=2)
    inj.arm("free", "corrupt", nth=1)
    inj.arm_tamper("swap_in", nth=2)
    out = []
    with inj:
        for i in range(60):
            site = ["alloc", "decode_step", "commit", "transfer",
                    "free", "verify_step"][i % 6]
            try:
                mod.fault_point(site)
                out.append(None)
            except mod.InjectedFault as e:
                out.append((type(e).__name__, str(e)))
            out.append(mod.tamper_point("swap_in"))
    assert mod._ACTIVE is None
    return out, inj.log, inj.stats(), inj.fired_total


@pytest.mark.parametrize("seed", [0, 7])
def test_injector_matches_jax(seed):
    got, want = _fire_log(tres, seed), _fire_log(jres, seed)
    assert got == want
    # rate-fired faults stop at max_faults (armed shots count too); the
    # armed transfer / free shots and the tamper shot all fired
    assert 3 <= got[3] <= 5 + 3
    assert {(s, m) for s, m, _ in got[1]} >= {
        ("transfer", "raise"), ("free", "corrupt"), ("swap_in", "tamper")}
    assert got[0].count(True) == 1
    with pytest.raises(ValueError, match="unknown site"):
        tres.FaultInjector(sites=["nope"])
    with pytest.raises(ValueError, match="unknown mode"):
        tres.FaultInjector(modes=("melt",))


def _handle(rid, n):
    return types.SimpleNamespace(
        rid=rid, prompt=np.arange(n, dtype=np.int32)[None], tokens=[],
        max_new_tokens=4, eos_token_id=None, priority=1,
        deadline_at=(50.0 if rid == 1 else None), submitted_at=0.0,
        preemptions=0, slot=None, done=False, finish_reason=None,
        constraint=None)


def _journal_script(mod):
    j = mod.RequestJournal()
    hs = [_handle(i, 3 + i) for i in range(3)]
    log = []
    for h in hs:
        j.record_submit(h, now=1.0)
    hs[0].slot, hs[0].tokens = 0, [5]
    hs[1].tokens, hs[1].preemptions = [6, 7], 1
    for step in range(3):
        j.sync()
        log.append(([e.as_record(now=10.0) for e in j.live_entries()],
                    j.size, j.token_count, j.finished_total))
        hs[0].tokens.append(step)
        if step == 1:
            hs[2].done, hs[2].finish_reason = True, "eos"
    j.forget(1)
    log.append((j.size, j.finished_total))
    return log


def test_journal_matches_jax():
    assert _journal_script(tres) == _journal_script(jres)


def _parity_run(side):
    inj = MODS[side].FaultInjector()
    inj.arm("decode_step", "raise", nth=4)
    inj.arm("prefill_chunk", "corrupt", nth=3)
    sup, reqs, inj, rungs = _serve(side, {}, inj, recover_after=3)
    return sup, reqs, inj, rungs


STAT_KEYS = ("health", "degraded_level", "degraded_mode", "recoveries",
             "injected_faults", "real_faults", "shed_total",
             "supervised_steps", "journal_entries", "journal_tokens",
             "preemptions_total", "resumes_total", "sched_steps",
             "deadline_cancels_total", "idle_fences_total")


def test_supervised_fault_run_matches_jax():
    runs = {s: _parity_run(s) for s in MODS}
    (jsup, jreqs, jinj, jr), (sup, reqs, inj, r) = (runs["jax"],
                                                    runs["port"])
    assert _tokens(reqs) == _tokens(jreqs) == _base({})
    assert [x.finish_reason for x in reqs] == [
        x.finish_reason for x in jreqs]
    assert inj.log == jinj.log and len(inj.log) == 2
    st, jst = sup.stats(), jsup.stats()
    assert {k: st[k] for k in STAT_KEYS} == {k: jst[k] for k in STAT_KEYS}
    assert r == jr and 1 in r and r[-1] == 0      # up a rung, back down
    assert sup.load_stats() == {k: v for k, v in jsup.load_stats().items()
                                if k in sup.load_stats()}
    assert [x.rid for x in reqs] == sorted({x.rid for x in reqs})


def _ladder(side):
    P = MODS[side].Priority
    inj = MODS[side].FaultInjector()
    for nth in (3, 4, 5):                  # three failures in a row
        inj.arm("decode_step", "raise", nth=nth)
    sup = MODS[side].EngineSupervisor(
        _factory(side), token_budget=20, sleep=lambda s: None,
        recover_after=4)
    rungs = []
    with inj:
        reqs = [sup.submit(p, max_new_tokens=5)
                for p in _prompts()[:2]]
        while sup.degraded_level < 3:
            sup.step()
            rungs.append((sup.degraded_level, sup.health,
                          sup.engine.prefill_chunk))
            assert len(rungs) < 10
        shed = sup.submit(_prompts()[2], max_new_tokens=3,
                          priority=P.LOW)
        keep = sup.submit(_prompts()[3], max_new_tokens=3,
                          priority=P.HIGH)
        while sup.step():
            rungs.append((sup.degraded_level, sup.health,
                          sup.engine.prefill_chunk))
    return (_tokens(reqs + [shed, keep]),
            [x.finish_reason for x in reqs + [shed, keep]], rungs,
            {k: sup.stats()[k] for k in STAT_KEYS})


def _circuit(side):
    inj = MODS[side].FaultInjector()
    for nth in (2, 3, 4):
        inj.arm("sched_tick", "raise", nth=nth)
    sup = MODS[side].EngineSupervisor(
        _factory(side), circuit_threshold=3, sleep=lambda s: None)
    with inj:
        reqs = [sup.submit(p, max_new_tokens=5) for p in _prompts()[:2]]
        with pytest.raises(MODS[side].EngineDead, match="circuit"):
            sup.run()
        with pytest.raises(MODS[side].EngineDead):
            sup.submit(_prompts()[2])
    return ([(x.done, x.finish_reason) for x in reqs], sup.health,
            sup.load_stats()["degraded_mode"], sup.recoveries)


def test_degraded_ladder_and_circuit_breaker_match_jax():
    got, want = _ladder("port"), _ladder("jax")
    assert got == want
    tokens, reasons, rungs, st = got
    assert reasons[2] == "rejected_overload" and tokens[2] == []
    assert rungs[-1][0] < 3 and (3, "degraded", 8) in rungs
    assert st["shed_total"] == 1 and st["recoveries"] == 3
    got, want = _circuit("port"), _circuit("jax")
    assert got == want
    assert got[0] == [(True, "engine_dead")] * 2
    assert got[1:] == ("dead", "dead", 2)


# ----------------------------------------------------- port against port

@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("site", PORT_SITES)
def test_recovery_at_each_site_is_token_identical(metrics, site, kv,
                                                  tmp_path):
    kw = dict(SITE_KW.get(site, {}), kv_cache_dtype=kv)
    # the log's sites: the same engine under a supervisor with a log
    # (one append and one fsync a step, a checkpoint every two steps),
    # held to the uninterrupted run without one
    sup_kw = (dict(wal_dir=str(tmp_path), checkpoint_every=2,
                   wal_kw={"group_interval_s": 0.0})
              if kw.pop("wal", False) else {})
    want = _base(kw)
    inj = tserving.FaultInjector()
    nth, shots = SITE_SHOTS.get(site, (3, 1))
    for _ in range(shots):
        inj.arm(site, "raise", nth=nth)
    sup, reqs, inj, _ = _serve("port", kw, inj, **sup_kw)
    assert inj.fired[site] == shots, inj.stats()
    assert sup.recoveries == 1 and sup.injected_faults == 1
    assert _counter(metrics, "serving_fault_injected_total",
                    f"site={site},kind=raise") == shots
    assert _counter(metrics, "serving_fault_recoveries_total") == 1
    assert _tokens(reqs) == want
    assert all(r.done for r in reqs)
    ts._assert_balanced(sup.engine)


def test_corrupt_at_transfer_and_several_faults(metrics):
    want = _base({})
    inj = tserving.FaultInjector()
    inj.arm("transfer", "corrupt", nth=4)
    sup, reqs, _, _ = _serve("port", {}, inj)
    assert _tokens(reqs) == want and sup.recoveries == 1
    assert _counter(metrics, "serving_fault_injected_total",
                    "site=transfer,kind=corrupt") == 1
    inj = tserving.FaultInjector(seed=11, rate=0.08, max_faults=4,
                                 modes=("raise", "corrupt"),
                                 sites=["alloc", "free", "decode_step",
                                        "prefill_chunk", "commit",
                                        "transfer", "sched_tick"])
    sup, reqs, inj, _ = _serve("port", {}, inj, circuit_threshold=10)
    assert inj.fired_total == 4 == sup.recoveries
    assert _tokens(reqs) == want
    ts._assert_balanced(sup.engine)


def test_watchdog_stall_recovers_and_holds_the_old_engine(metrics):
    """A stall past the watchdog: StepStalled, the poisoned engine is
    fenced and held while its step thread lives, then released."""
    inj = tserving.FaultInjector(stall_s=0.6)
    inj.arm("decode_step", "stall", nth=3)
    sup = tserving.EngineSupervisor(_factory("port"), token_budget=20,
                                    watchdog_s=0.2, sleep=lambda s: None)
    with inj:
        reqs = [sup.submit(p, max_new_tokens=6) for p in _prompts()]
        while sup.recoveries == 0:
            sup.step()
        (t, old), = sup._abandoned
        assert t.is_alive() and old is not sup.engine
        assert old._slots == [None] * old.max_batch
        assert (old._rids == -1).all() and old._inflight is None
        sup.run()
        t.join()
    sup._release_abandoned()
    assert sup._abandoned == []
    assert sup.injected_faults == 1 and sup.real_faults == 0
    assert _counter(metrics, "serving_fault_injected_total",
                    "site=decode_step,kind=stall") == 1
    base = tserving.EngineSupervisor(_factory("port"), token_budget=20)
    breqs = [base.submit(p, max_new_tokens=6) for p in _prompts()]
    base.run()
    assert _tokens(reqs) == _tokens(breqs)


def test_rids_stay_monotonic_across_rebuilds():
    inj = tserving.FaultInjector()
    inj.arm("decode_step", "raise", nth=2)
    sup = tserving.EngineSupervisor(_factory("port"), sleep=lambda s: None)
    with inj:
        first = [sup.submit(p, max_new_tokens=3) for p in _prompts()[:2]]
        while sup.recoveries == 0:
            sup.step()
        later = [sup.submit(p, max_new_tokens=3) for p in _prompts()[2:]]
        sup.run()
    rids = [r.rid for r in first + later]
    assert rids == sorted(set(rids)) and sup.engine._next_rid > rids[-1]


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_drain_restore_round_trip(metrics, tmp_path, kv):
    """Drain mid-decode with a shared system prompt in the trie; the
    restored supervisor finishes every session token-identically and a
    new request on the same system prompt is a prefix hit."""
    rs = np.random.RandomState(41)
    system = rs.randint(3, 256, (16,)).astype(np.int32)
    asks = [np.concatenate([system, rs.randint(3, 256, (n,)).astype(
        np.int32)]) for n in (3, 5, 4)]
    make = _factory("port", kv_cache_dtype=kv)
    ref = tserving.EngineSupervisor(make)
    want = [ref.submit(p, max_new_tokens=6) for p in asks]
    ref.run()
    sup = tserving.EngineSupervisor(make)
    live = [sup.submit(p, max_new_tokens=6) for p in asks[:2]]
    for _ in range(4):
        sup.step()
    assert all(r.tokens and not r.done for r in live)
    summary = sup.drain(str(tmp_path / "d.npz"))
    assert summary["sessions"] == 2 and summary["trie_pages"] >= 2
    with pytest.raises(RuntimeError, match="drained"):
        sup.submit(asks[2])
    tobs.REGISTRY.clear()
    sup2 = tserving.EngineSupervisor.restore(make, summary["path"])
    got = [sup2.restored[r.rid] for r in live]
    assert [r.tokens for r in got] == [r.tokens for r in live]
    late = sup2.submit(asks[2], max_new_tokens=6)
    sup2.run()
    assert _tokens(got + [late]) == _tokens(want)
    assert _counter(metrics, "serving_prefix_hit_tokens_total") >= 16
    assert _counter(metrics, "serving_drain_restored_sessions_total") == 2
    ts._assert_balanced(sup2.engine)
    bad = _factory("port", kv_cache_dtype=None if kv else "int8")
    with pytest.raises(ValueError, match="kv_dtype"):
        tserving.EngineSupervisor.restore(bad, summary["path"])


def test_prefix_records_match_jax():
    rs = np.random.RandomState(5)
    system = rs.randint(3, 256, (16,)).astype(np.int32)
    prompts = [np.concatenate([system, rs.randint(3, 256, (n,)).astype(
        np.int32)]) for n in (3, 9, 0)] + [rs.randint(3, 256, (12,))]
    recs = {}
    for side, mod in MODS.items():
        alloc, trie = mod.BlockAllocator(64), mod.PrefixCache(8)
        for p in prompts:
            pages = alloc.alloc(-(-len(p) // 8))
            trie.register(np.asarray(p, np.int32), pages, alloc)
        rec = trie.to_records()
        fresh = mod.BlockAllocator(64)
        back = mod.PrefixCache(8)
        ids = sorted(set(trie.pages()))
        page_map = {p: 40 + i for i, p in enumerate(ids)}
        fresh.alloc(50)
        back.restore_records(rec, page_map, fresh)
        remap = np.arange(64)
        remap[40:40 + len(ids)] = np.arange(len(ids)) + 1
        back.remap_pages(remap)
        recs[side] = (rec, back.to_records(), sorted(back.pages()),
                      fresh.stats()["shares_total"])
    assert recs["port"] == recs["jax"]
    assert len(recs["port"][0]["nodes"]) == 4
    assert len(recs["port"][0]["tails"]) == 3
    with pytest.raises(ValueError, match="not empty"):
        t, al = tserving.PrefixCache(8), tserving.BlockAllocator(8)
        t.register(np.arange(9, dtype=np.int32), al.alloc(2), al)
        t.restore_records(recs["port"][0], {}, tserving.BlockAllocator(8))


# ------------------------------------------------------------- the code

def _fault_calls(paths):
    calls = {}
    for path in paths:
        for m in re.finditer(r'fault_point\(\s*"(\w+)"\s*\)',
                             path.read_text()):
            calls.setdefault(m.group(1), []).append(path.name)
    return calls


def test_site_lint():
    """Every engine site has its fault points in the port exactly where
    the JAX engine, scheduler, allocator and write-ahead log have
    theirs: one each, but ``dispatch``, ``commit`` and ``transfer``
    once per forward kind (decode, linear verify, tree verify), as in
    the reference. No site waits for a module any more. The three live
    cluster sites have one each in ``serving/cluster.py``, as in the
    JAX package's cluster; the RPC and fabric sites have none yet."""
    calls = _fault_calls((ROOT / "paddle_tpu_torch").rglob("*.py"))
    ref = _fault_calls(ROOT / "paddle_tpu" / rel for rel in (
        "inference/predictor.py", "serving/paged_cache.py",
        "serving/scheduler.py", "serving/host_tier.py",
        "serving/adapters.py", "serving/wal.py", "serving/cluster.py"))
    for site in tres.ENGINE_SITES:
        assert sorted(calls[site]) == sorted(ref[site]), site
        assert len(calls[site]) == (
            3 if site in ("dispatch", "commit", "transfer") else 1), site
    for site in ("wal_append", "wal_fsync", "checkpoint_write"):
        assert calls[site] == ["wal.py"], site
    for site in ("handoff_export", "handoff_import", "autoscale_tick"):
        assert calls[site] == ref[site] == ["cluster.py"], site
    for site in set(tres.CLUSTER_SITES) - {
            "handoff_export", "handoff_import", "autoscale_tick"}:
        assert site not in calls, site
    assert set(calls) <= set(tres.SITES)
    assert tres.WAITING_SITES == ()


def test_chip_smoke_recovery_check_rejects_a_dropped_token():
    """``chip_smoke.check_recovery``, phase 3g's gate, on a real CPU
    recovery: it passes the journal the supervisor restored, and fails
    when one committed token is dropped from it."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    seen = {}
    sup = tserving.EngineSupervisor(_factory("port"), sleep=lambda s: None)
    orig = sup._recover

    def recover(sync=True):
        orig(sync=sync)
        seen["journal"] = {e.rid: list(e.tokens)
                           for e in sup.journal.live_entries()}
    sup._recover = recover
    inj = tserving.FaultInjector()
    inj.arm("decode_step", "raise", nth=4)
    with inj:
        reqs = [sup.submit(p, max_new_tokens=6) for p in _prompts()]
        while sup.recoveries == 0:
            before = {r.rid: list(r.tokens) for r in reqs}
            sup.step()
        sup.run()
    final = {r.rid: list(r.tokens) for r in reqs}
    journal = seen["journal"]
    chip_smoke.check_recovery("cpu", before, journal, final)
    rid = next(r for r, t in before.items() if t)
    dropped = dict(journal)
    dropped[rid] = journal[rid][1:]
    with pytest.raises(SystemExit, match="journal restored"):
        chip_smoke.check_recovery("cpu", before, dropped, final)
