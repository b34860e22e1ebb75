"""The port's multi-tenant adapter pool against the JAX package's, on the
CPU (``paddle_tpu_torch/serving/adapters.py``, the LoRA term of
``models/generate.py`` and its consumers: the engine, the SLO scheduler
and the supervisor).

Both sides get ``test_torch_scheduler``'s tiny f32 Llama
(``LlamaConfig.tiny(num_layers=2, max_seq_len=64)``, the JAX weights
through ``params_from_jax``) and a registry of three rank-4 adapters,
``init_lora(cfg, 4, seed=40 + aid)`` for aid 1-3, the same numpy arrays
on both sides.

- JAX parity: ``_lora_delta`` on ``_adapter_prep``'s gathered factors
  within 1e-6 relative (decode and chunk shapes); ``init_lora`` equal and
  ``merge_lora`` within 1e-6; greedy tokens and pool ``stats()`` equal
  for a mixed batch of base and adapter rows (KV f32, and int8 with the
  fused path), a multi-chunk prefill, n-gram and draft-tree
  speculation with an adapter row, and LRU reclaim with demote and
  promote under ``ServingScheduler`` (synchronous and overlapped: plans,
  tokens, pool counters and the adapter hooks' counters); a store one
  package's pool demoted into promotes in the other's; a ``raise`` at
  ``adapter_load`` and at ``adapter_promote`` under
  ``EngineSupervisor`` recovers to the JAX engine's tokens;
- the reference's own contracts (``tests/test_adapters.py``), port
  against port: ``TestAdapterRegistry``, ``TestAdapterPool``,
  ``TestAdapterParity`` (adapter id 0 bit-identical to the plain engine
  for f32, int8 KV and int4 weights; a mixed batch and a chunked prefill
  equal to engines on dense-merged weights; spec verify) and
  ``TestAdapterLifecycle``. Left out: ``test_tp2_adapter_parity``, as a
  tensor-parallel pool is ROADMAP.md step 7 (``mesh=`` raises), and the
  reference's check of ``serving_adapter_gather``, a trace-time hook
  the port has no caller for;
- the port's own: a reclaimed slot reinstalled at a smaller rank keeps
  no stale rank columns, the handoff pins the adapter on the importing
  engine, a drain and restore keeps a session's adapter, and pins
  balance.

JAX engines of one program signature share their compiled programs
(``test_torch_scheduler._share_programs``); an overlapped JAX engine
steps with a copying
``jnp.asarray`` (``test_torch_scheduler``'s ``_Run``).
"""
import numpy as np
import jax
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.models import generate as jgen
import paddle_tpu.observability as jobs
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import generate as tgen

import test_torch_scheduler as ts

torch.set_num_threads(1)
MODS = {"jax": jserving, "port": tserving}
RANK = 4
_REGS = {}


def _model(side):
    Engine, Sched, P, params, cfg, extra = ts._models()[side]
    return Engine, params, cfg, extra


def _registry(side):
    if side not in _REGS:
        mod, cfg = MODS[side], _model(side)[2]
        reg = mod.AdapterRegistry(cfg)
        for aid in (1, 2, 3):
            reg.register(aid, mod.init_lora(cfg, RANK, seed=40 + aid))
        _REGS[side] = reg
    return _REGS[side]


def _engine(side, slots=3, store=None, pool=None, **kw):
    """One side's engine with an adapter pool (``slots``, rank 4, the
    shared registry, ``store``) or ``pool``; JAX engines of one program
    signature share their compiled programs."""
    Engine, params, cfg, extra = _model(side)
    kw = dict(ts.ENGINE_KW, **kw)
    if pool is None:
        pool = dict(slots=slots, rank=RANK, registry=_registry(side),
                    store=store)
    eng = Engine(params, cfg, adapters=pool, **kw, **extra)
    if side == "jax":
        ts._share_programs(eng)
    return eng


def _prompts(lens, seed):
    return ts._prompts(lens, seed)


def _tokens(reqs):
    return [list(map(int, r.tokens)) for r in reqs]


def _pool_stats(eng):
    return {k: v for k, v in eng.stats().items() if k.startswith("adapter")}


def _balanced(eng):
    pool = eng.adapters
    assert all(n == 0 for n in pool._pins.values()), pool._pins
    ts._assert_balanced(eng)


# ------------------------------------------------------- against the JAX

@pytest.mark.parametrize("T", [1, 5], ids=["decode", "chunk"])
def test_lora_delta_matches_jax(T):
    """The LoRA term of a (B, T) batch over a pool of 4 slots (slot 0
    zeros), on the factors ``_adapter_prep`` gathers per row, against
    the JAX ``_lora_delta`` on the pool and the slots. Base rows get an
    exact zero."""
    rs = np.random.RandomState(T)
    L, S, B, i, r, o = 2, 4, 3, 64, RANK, 48
    pool = {"aq": rs.randn(L, S, i, r), "bq": rs.randn(L, S, r, o),
            "ao": rs.randn(L, S, o, r), "bo": rs.randn(L, S, r, i),
            "scale": np.asarray([0.0, 1.0, 0.5, 2.0])}
    pool = {n: a.astype(np.float32) for n, a in pool.items()}
    for n in ("aq", "bq", "ao", "bo"):
        pool[n][:, 0] = 0.0
    x = rs.randn(B, T, i).astype(np.float32)
    y = rs.randn(B, T, o).astype(np.float32)
    slots = np.asarray([2, 0, 3], np.int32)
    cfg = _model("port")[2]
    ad = tgen._adapter_prep({n: torch.from_numpy(a) for n, a in pool.items()},
                            torch.from_numpy(slots), cfg)
    for l in range(L):
        aq, bq, ao, bo, sc = ad(l)
        got_q = tgen._lora_delta(torch.from_numpy(x), aq, bq, sc)
        got_o = tgen._lora_delta(torch.from_numpy(y), ao, bo, sc)
        scale = jax.numpy.asarray(pool["scale"][slots])
        for got, inp, a, b in ((got_q, x, "aq", "bq"), (got_o, y, "ao", "bo")):
            want = np.asarray(jgen._lora_delta(
                inp, pool[a][l], pool[b][l], jax.numpy.asarray(slots), scale))
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
            assert not got[1].any()            # slot 0: an exact zero


def test_init_and_merge_lora_match_jax():
    jcfg, tcfg = _model("jax")[2], _model("port")[2]
    ja = jserving.init_lora(jcfg, RANK, seed=41, alpha=2.0)
    ta = tserving.init_lora(tcfg, RANK, seed=41, alpha=2.0)
    assert set(ja) == set(ta) and ja["alpha"] == ta["alpha"] == 2.0
    for n in tserving.FACTOR_NAMES:
        np.testing.assert_array_equal(ta[n], ja[n])
    jm = jserving.merge_lora(_model("jax")[1], jcfg, ja)
    tm = tserving.merge_lora(_model("port")[1], tcfg, ta)
    for w in ("wq", "wo"):
        np.testing.assert_allclose(tm["layers"][w].numpy(),
                                   np.asarray(jm["layers"][w]), rtol=1e-6,
                                   atol=1e-7)
    assert tm["layers"]["wk"] is _model("port")[1]["layers"]["wk"]


@pytest.mark.parametrize("kv,fused", [(None, False), ("int8", True)],
                         ids=["f32", "int8-fused"])
def test_mixed_batch_matches_jax(kv, fused):
    """Base and two adapter rows in one batch: tokens and pool stats
    equal to JAX's."""
    got = {}
    for side in MODS:
        eng = _engine(side, max_batch=3, kv_cache_dtype=kv, fused=fused)
        reqs = [eng.submit(p, max_new_tokens=6, adapter_id=aid)
                for p, aid in zip(_prompts((4, 6, 7), seed=2), (0, 1, 2))]
        eng.run()
        got[side] = (_tokens(reqs), _pool_stats(eng))
    assert got["port"] == got["jax"]
    assert got["port"][1]["adapter_loads_total"] == 2
    _balanced(eng)


def test_chunked_prefill_matches_jax():
    got = {}
    for side in MODS:
        eng = _engine(side, prefill_chunk=8)
        r = eng.submit(_prompts((20,), seed=3)[0], max_new_tokens=4,
                       adapter_id=1)
        eng.run()
        got[side] = list(r.tokens)
    assert got["port"] == got["jax"]
    assert eng.forwards["prefill"] == 3


def _spec_stats(eng):
    st = eng.stats()
    return {k: st[k] for k in ("spec_drafted_total", "spec_accepted_total",
                               "spec_verify_steps")}


@pytest.mark.parametrize("kw", [dict(spec_k=3),
                                dict(draft_layers=1, spec_tree=(2, 2))],
                         ids=["ngram", "tree"])
def test_speculation_with_adapter_matches_jax(kw):
    """An adapter row and a base row under n-gram speculation (tiled
    prompts, so drafts accept) or a draft tree: the target's verify
    carries the adapter term, the draft model's forwards none."""
    motif = np.asarray([7, 11, 13, 17], np.int32)
    prompts = [np.tile(motif, 4), np.tile(motif[::-1], 3)]
    got = {}
    for side in MODS:
        eng = _engine(side, **kw)
        reqs = [eng.submit(p, max_new_tokens=8, adapter_id=aid)
                for p, aid in zip(prompts, (1, 0))]
        eng.run()
        got[side] = (_tokens(reqs), _spec_stats(eng), _pool_stats(eng))
    assert got["port"] == got["jax"]
    assert got["port"][1]["spec_verify_steps"] > 0
    _balanced(eng)


def _adapter_counters(obs):
    """The adapter hooks' counters (by name and labels) and histogram
    sample counts; the trace-time gather counters are the JAX
    package's alone."""
    out = {}
    for name, m in obs.REGISTRY.to_json().items():
        if not name.startswith("serving_adapter") or "gather" in name:
            continue
        for labels, v in m["values"].items():
            out[(name, labels)] = (v["count"] if m["kind"] == "histogram"
                                   else v)
    return out


@pytest.fixture
def metrics():
    for obs in (jobs, tobs):
        obs.REGISTRY.clear()
        obs.enable()
    yield
    for obs in (jobs, tobs):
        obs.disable()
        obs.REGISTRY.clear()


def _lru_run(side, overlap):
    """Two slots, three adapters, two engine slots, budget 20: a NORMAL
    request on adapter 1 and a LOW one on adapter 2; after three steps a
    HIGH one on adapter 3 preempts the LOW one (which pins a slot), whose
    slot is reclaimed (adapter 2 demoted); the LOW one resumes by
    promoting 2 (demoting 1), and a late request on adapter 1 promotes
    it back."""
    mod = MODS[side]
    store = mod.HostPageStore(page_size=8)
    run = ts._Run.__new__(ts._Run)
    run.eng = _engine(side, slots=2, store=store, overlap=overlap)
    run.P = mod.Priority
    run.sched = mod.ServingScheduler(run.eng, token_budget=20,
                                     overlap=overlap)
    run.copying = side == "jax" and overlap
    run.plans, run.widths, run.reqs = [], [], []
    a, b, c, d = _prompts((5, 11, 3, 6), seed=5)
    run.submit(a, 6, "NORMAL", adapter_id=1)
    run.submit(b, 6, "LOW", adapter_id=2)
    run.step(3)
    run.submit(c, 6, "HIGH", adapter_id=3)
    run.step(2)
    run.submit(d, 4, "NORMAL", adapter_id=1)
    run.drain()
    return run


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_scheduled_lru_demote_promote_matches_jax(metrics, overlap):
    got = {}
    for side, obs in (("jax", jobs), ("port", tobs)):
        obs.REGISTRY.clear()
        run = _lru_run(side, overlap)
        got[side] = (run.record(), _pool_stats(run.eng),
                     _adapter_counters(obs), run.sched.load_stats())
    assert got["port"][:3] == got["jax"][:3]
    rec, st, counters, load = got["port"]
    assert all(rec["done"]) and rec["preemptions"] == 1
    assert st["adapter_demotions_total"] >= 2
    assert st["adapter_promotions_total"] >= 1
    assert sum(v for (n, lab), v in counters.items()
               if n == "serving_adapter_loads_total" and "promote" in lab
               ) == st["adapter_promotions_total"]
    assert load["adapter_slots_used"] == 2
    assert load["adapter_slots_free"] == 0
    _balanced(run.eng)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_promotes_across_packages(tmp_path, writer):
    """A pool of one package demotes adapter 1 into a standing store
    (``persist=True``); a fresh pool of the other, with an empty
    registry, promotes it from the same directory, CRC-checked, to the
    same factors."""
    reader = "port" if writer == "jax" else "jax"
    wmod, rmod = MODS[writer], MODS[reader]
    wcfg, rcfg = _model(writer)[2], _model(reader)[2]
    wpool = wmod.AdapterPool(
        wcfg, slots=1, rank=RANK, registry=_registry(writer),
        store=wmod.HostPageStore(page_size=8, path=str(tmp_path)),
        **({"device": "cpu"} if writer == "port" else {}))
    wpool.acquire(1)
    wpool.release(1)
    wpool.acquire(2)                     # evicts 1: demoted to disk
    assert wpool.demotions_total == 1
    rpool = rmod.AdapterPool(
        rcfg, slots=1, rank=RANK, registry=rmod.AdapterRegistry(rcfg),
        store=rmod.HostPageStore(page_size=8, path=str(tmp_path)),
        **({"device": "cpu"} if reader == "port" else {}))
    slot = rpool.acquire(1)
    assert rpool.promotions_total == 1 and rpool.fallbacks_total == 0
    src = _registry("port").get(1)
    for n in tserving.FACTOR_NAMES:
        np.testing.assert_array_equal(
            np.asarray(rpool.arrays[n])[:, slot], src[n])


@pytest.mark.parametrize("site", ["adapter_load", "adapter_promote"])
def test_fault_at_adapter_site_matches_jax(site):
    """A ``raise`` at the site under ``EngineSupervisor`` commits
    nothing; the recovered run gives the JAX engine's tokens, and an
    uninterrupted one's."""
    got = {}
    for side, mod in MODS.items():
        store = mod.HostPageStore(page_size=8)
        pool = (mod.AdapterPool(_model(side)[2], slots=1, rank=RANK,
                                registry=_registry(side), store=store,
                                **({"device": "cpu"} if side == "port"
                                   else {})))
        sup = mod.EngineSupervisor(lambda: _engine(side, pool=pool),
                                   backoff_s=0.0, sleep=lambda s: None)
        p = _prompts((5,), seed=18)[0]
        if site == "adapter_promote":
            # demote 1 first, so that the faulted admission promotes it
            for q, aid in zip(_prompts((4, 4), seed=19), (1, 2)):
                sup.submit(q, max_new_tokens=2, adapter_id=aid)
                sup.run()
            assert pool.demotions_total >= 1
        inj = mod.FaultInjector(seed=0)
        inj.arm(site, "raise", nth=1)
        with inj:
            r = sup.submit(p, max_new_tokens=4, adapter_id=1)
            sup.run()
        assert inj.fired[site] == 1 and sup.recoveries == 1
        got[side] = list(r.tokens)
        if side == "port":
            assert sup.health != "dead" and pool.pins(1) == 0
            ref = _engine("port")
            want = ref.submit(p, max_new_tokens=4, adapter_id=1)
            ref.run()
            assert got["port"] == list(want.tokens)
    assert got["port"] == got["jax"]


# ------------------------------------- the reference's own contracts

_GEOM = dict(max_batch=2, page_size=8, max_len=32, device="cpu")


def _cfg():
    return _model("port")[2]


def _params():
    return _model("port")[1]


def _reg():
    return _registry("port")


def _pool(slots=3, rank=RANK, **kw):
    return tserving.AdapterPool(_cfg(), slots=slots, rank=rank,
                                registry=kw.pop("registry", _reg()),
                                device="cpu", **kw)


def _port(params=None, **kw):
    eng_kw = dict(_GEOM)
    eng_kw.update(kw)
    return ContinuousBatchingEngine(
        _params() if params is None else params, _cfg(), **eng_kw)


def _slot_rows(pool, name, slot):
    return pool.arrays[name][:, slot].numpy().copy()


class TestAdapterRegistry:
    def test_register_validates(self):
        reg = tserving.AdapterRegistry(_cfg())
        with pytest.raises(ValueError, match="reserved"):
            reg.register(0, tserving.init_lora(_cfg(), 4))
        bad = tserving.init_lora(_cfg(), 4)
        bad["ak"] = bad["aq"]            # k/v factors fork the KV
        with pytest.raises(ValueError, match="q/o-projection"):
            reg.register(1, bad)
        short = {k: v for k, v in tserving.init_lora(_cfg(), 4).items()
                 if k != "bo"}
        with pytest.raises(ValueError, match="missing"):
            reg.register(1, short)
        wrong = tserving.init_lora(_cfg(), 4)
        wrong["bq"] = wrong["bq"][:, :2]
        with pytest.raises(ValueError, match="shape"):
            reg.register(1, wrong)

    def test_merge_rejects_quantized(self):
        q = tgen.quantize_weights(_params(), _cfg(), bits=8)
        with pytest.raises(ValueError, match="quantized"):
            tserving.merge_lora(q, _cfg(), _reg().get(1))


class TestAdapterPool:
    def test_refcounts_shared_slot_and_release(self):
        pool = _pool(slots=2)
        s1 = pool.acquire(1)
        assert s1 == pool.acquire(1) and pool.pins(1) == 2
        assert pool.loads_total == 1 and pool.slot_hits_total == 1
        pool.release(1)
        assert pool.pins(1) == 1 and pool.resident(1)
        pool.release(1)
        pool.release(1)                  # idempotent on zero pins
        assert pool.pins(1) == 0 and pool.resident(1)

    def test_lru_reclaim_and_backpressure(self):
        pool = _pool(slots=2)
        pool.acquire(1)
        pool.acquire(2)
        assert not pool.slot_available()
        with pytest.raises(tserving.AdapterPoolExhausted):
            pool.acquire(3)
        assert issubclass(tserving.AdapterPoolExhausted,
                          tserving.PoolExhausted)
        pool.release(1)
        assert pool.slot_available()
        s3 = pool.acquire(3)
        assert not pool.resident(1) and pool.resident(3)
        assert s3 == pool.slot_of(3) and pool.evictions_total == 1

    def test_base_id_is_slot0_and_free(self):
        pool = _pool(slots=1)
        assert pool.acquire(0) == 0 and pool.pins(0) == 0
        assert pool.slot_of(0) == 0 and pool.resident(0)
        pool.release(0)
        assert not pool.arrays["aq"][:, 0].any()
        assert float(pool.arrays["scale"][0]) == 0.0

    def test_rank_bucket_pads_and_bounds(self):
        reg = tserving.AdapterRegistry(_cfg())
        reg.register(1, tserving.init_lora(_cfg(), 2, seed=9))
        reg.register(2, tserving.init_lora(_cfg(), 8, seed=9))
        pool = _pool(slots=2, registry=reg)
        pool.acquire(1)
        a = _slot_rows(pool, "aq", pool.slot_of(1))
        assert a[:, :, 2:].max() == 0.0 and np.abs(a[:, :, :2]).max() > 0
        b = _slot_rows(pool, "bq", pool.slot_of(1))
        assert b[:, 2:].max() == 0.0
        assert float(pool.arrays["scale"][pool.slot_of(1)]) == 1.0
        with pytest.raises(ValueError, match="rank"):
            pool.acquire(2)
        with pytest.raises(KeyError):
            pool.acquire(77)

    def test_demote_promote_roundtrip_crc(self):
        store = tserving.HostPageStore(page_size=8)
        pool = _pool(slots=1, store=store)
        pool.acquire(1)
        src = {n: _slot_rows(pool, n, 1) for n in tserving.FACTOR_NAMES}
        pool.release(1)
        pool.acquire(2)                  # evicts 1: demoted
        assert pool.demotions_total == 1
        entry = store.get(b"adapter/1", touch=False)
        assert entry is not None and entry.get("checksums")
        assert entry["extra"] == {"alpha": 4.0, "rank": 4, "adapter_id": 1}
        pool.release(2)
        pool.acquire(1)                  # promoted back
        assert pool.promotions_total == 1
        for n in tserving.FACTOR_NAMES:
            np.testing.assert_array_equal(
                _slot_rows(pool, n, pool.slot_of(1)), src[n])

    def test_standing_store_promotes_across_restart(self, tmp_path):
        pool = _pool(slots=1, store=tserving.HostPageStore(
            page_size=8, path=str(tmp_path)))
        pool.acquire(1)
        src = {n: _slot_rows(pool, n, 1) for n in tserving.FACTOR_NAMES}
        pool.release(1)
        pool.acquire(2)                  # demotes 1, to disk too
        pool2 = _pool(slots=1, registry=tserving.AdapterRegistry(_cfg()),
                      store=tserving.HostPageStore(page_size=8,
                                                   path=str(tmp_path)))
        pool2.acquire(1)
        assert pool2.promotions_total == 1
        for n in tserving.FACTOR_NAMES:
            np.testing.assert_array_equal(
                _slot_rows(pool2, n, pool2.slot_of(1)), src[n])

    def test_torn_payload_quarantines_and_falls_back(self):
        store = tserving.HostPageStore(page_size=8)
        pool = _pool(slots=1, store=store)
        pool.acquire(1)
        good = {n: _slot_rows(pool, n, 1) for n in tserving.FACTOR_NAMES}
        pool.release(1)
        pool.acquire(2)
        entry = store.get(b"adapter/1", touch=False)
        torn = entry["arrays"]["bq"].copy()
        torn.view(np.uint8).reshape(-1)[3] ^= 0xFF
        entry["arrays"]["bq"] = torn
        entry.pop("tensors", None)
        pool.release(2)
        pool.acquire(1)                  # CRC fails: a fresh load
        assert pool.fallbacks_total == 1 and store.quarantined_total == 1
        assert store.get(b"adapter/1", touch=False) is None
        for n in tserving.FACTOR_NAMES:
            np.testing.assert_array_equal(
                _slot_rows(pool, n, pool.slot_of(1)), good[n])


class TestAdapterParity:
    @pytest.mark.parametrize("kv,bits", [(None, None), ("int8", None),
                                         (None, 4)])
    def test_adapter_id0_bit_identity(self, kv, bits):
        prompts = _prompts((4, 7), seed=1)
        ref = _port(kv_cache_dtype=kv, weight_bits=bits).generate(
            prompts, max_new_tokens=6)
        out = _port(kv_cache_dtype=kv, weight_bits=bits,
                    adapters=_pool()).generate(prompts, max_new_tokens=6)
        for a, b in zip(ref, out):
            np.testing.assert_array_equal(a, b)

    def test_multi_adapter_batch_matches_merged_reference(self):
        prompts = _prompts((4, 6, 7), seed=2)
        aids = (0, 1, 2)
        refs = []
        for p, aid in zip(prompts, aids):
            par = (tserving.merge_lora(_params(), _cfg(), _reg().get(aid))
                   if aid else None)
            refs.append(_port(par, max_batch=1).generate(
                [p], max_new_tokens=6)[0])
        eng = _port(adapters=_pool(), max_batch=3)
        reqs = [eng.submit(p, max_new_tokens=6, adapter_id=aid)
                for p, aid in zip(prompts, aids)]
        eng.run()
        for r, ref in zip(reqs, refs):
            np.testing.assert_array_equal(r.output, ref)
        _balanced(eng)

    def test_chunked_prefill_carries_adapter(self):
        p = _prompts((20,), seed=3)[0]
        merged = tserving.merge_lora(_params(), _cfg(), _reg().get(1))
        ref = _port(merged, max_batch=1, prefill_chunk=8).generate(
            [p], max_new_tokens=4)[0]
        eng = _port(adapters=_pool(), prefill_chunk=8)
        r = eng.submit(p, max_new_tokens=4, adapter_id=1)
        eng.run()
        np.testing.assert_array_equal(r.output, ref)

    def test_spec_verify_carries_adapter(self):
        p = np.tile(_prompts((5,), seed=5)[0], 3)
        outs = []
        for kw in ({}, {"spec_k": 3}):
            eng = _port(adapters=_pool(), **kw)
            r = eng.submit(p, max_new_tokens=8, adapter_id=1)
            eng.run()
            outs.append(r.output)
        np.testing.assert_array_equal(outs[0], outs[1])

    def test_mesh_mismatch_rejected(self):
        with pytest.raises(NotImplementedError, match="step 7"):
            _pool(mesh=object())
        with pytest.raises(NotImplementedError, match="1.9"):
            _port(mesh=object(), adapters=_pool())
        with pytest.raises(ValueError, match="device"):
            _port(adapters=_moved_pool())

    def test_adapter_without_pool_rejected(self):
        with pytest.raises(ValueError, match="adapter"):
            _port().submit(_prompts((4,), seed=0)[0], max_new_tokens=2,
                           adapter_id=1)


def _moved_pool():
    """A pool whose device is not the engine's."""
    pool = _pool(slots=1)
    pool.device = torch.device("cuda")
    return pool


class TestAdapterLifecycle:
    def test_preempt_swap_resume_with_live_adapter(self):
        ref_eng = _port(max_batch=1, adapters=_pool())
        ref = ref_eng.submit(_prompts((6,), seed=12)[0], max_new_tokens=8,
                             adapter_id=1)
        ref_eng.run()
        pool = _pool()
        eng = _port(max_batch=1, host_tier=True, adapters=pool)
        sched = tserving.ServingScheduler(eng)
        a = sched.submit(_prompts((6,), seed=12)[0], max_new_tokens=8,
                         priority=tserving.Priority.LOW, adapter_id=1)
        while len(a.tokens) < 3:
            sched.step()
        assert pool.pins(1) == 1
        sched.submit(_prompts((4,), seed=13)[0], max_new_tokens=2,
                     priority=tserving.Priority.HIGH)
        sched.step()
        assert a.preemptions == 1 and a.slot is None
        assert pool.pins(1) == 0
        sched.run()
        assert a.done and a.finish_reason in ("eos", "max_len")
        np.testing.assert_array_equal(a.output, ref.output)
        st = eng.stats()
        assert st["swap_outs_total"] >= 1 and st["swap_ins_total"] >= 1
        _balanced(eng)

    def test_scheduler_defers_on_pinned_pool(self):
        pool = _pool(slots=1)
        eng = _port(adapters=pool)
        sched = tserving.ServingScheduler(eng)
        r1 = sched.submit(_prompts((4,), seed=14)[0], max_new_tokens=4,
                          adapter_id=1)
        r2 = sched.submit(_prompts((5,), seed=15)[0], max_new_tokens=4,
                          adapter_id=2)
        sched.run()
        assert r1.done and r2.done
        assert {r1.finish_reason, r2.finish_reason} <= {"eos", "max_len"}
        assert pool.evictions_total >= 1
        _balanced(eng)

    def test_unknown_adapter_rejected_at_submit(self):
        eng = _port(adapters=_pool())
        with pytest.raises(ValueError, match="neither registered"):
            eng.submit(_prompts((4,), seed=20)[0], max_new_tokens=2,
                       adapter_id=99)
        big = tserving.AdapterRegistry(_cfg())
        big.register(1, tserving.init_lora(_cfg(), 8, seed=50))
        e2 = _port(adapters=_pool(slots=2, registry=big))
        with pytest.raises(ValueError, match="rank bucket"):
            e2.submit(_prompts((4,), seed=20)[0], max_new_tokens=2,
                      adapter_id=1)
        r = eng.submit(_prompts((4,), seed=21)[0], max_new_tokens=2,
                       adapter_id=1)
        eng.run()
        assert r.done

    def test_pinned_pool_never_preempts_baseline_victims(self):
        pool = _pool(slots=1)
        eng = _port(adapters=pool)
        sched = tserving.ServingScheduler(eng)
        P = tserving.Priority
        lo = sched.submit(_prompts((4,), seed=22)[0], max_new_tokens=8,
                          priority=P.LOW)
        hi = sched.submit(_prompts((5,), seed=23)[0], max_new_tokens=8,
                          priority=P.HIGH, adapter_id=1)
        sched.step()
        want = sched.submit(_prompts((6,), seed=24)[0], max_new_tokens=2,
                            priority=P.NORMAL, adapter_id=2)
        sched.run()
        assert want.done and lo.done and hi.done
        assert sched.preemptions_total == 0 and lo.preemptions == 0
        _balanced(eng)

    def test_recovery_repins_journaled_adapter(self):
        pool = _pool()
        ref_eng = _port(max_batch=1, adapters=_pool())
        ref = ref_eng.submit(_prompts((5,), seed=16)[0], max_new_tokens=6,
                             adapter_id=2)
        ref_eng.run()
        inj = tserving.FaultInjector(seed=0)
        inj.arm("decode_step", "raise", nth=3)
        sup = tserving.EngineSupervisor(
            lambda: _port(max_batch=1, adapters=pool), backoff_s=0.0,
            sleep=lambda s: None)
        with inj:
            r = sup.submit(_prompts((5,), seed=16)[0], max_new_tokens=6,
                           adapter_id=2)
            sup.run()
        assert inj.fired_total == 1 and sup.recoveries == 1
        np.testing.assert_array_equal(r.output, ref.output)
        assert pool.pins(2) == 0

    @pytest.mark.parametrize("site", ["adapter_load", "adapter_promote"])
    def test_fault_at_adapter_site_recovers_token_identically(self, site):
        store = tserving.HostPageStore(page_size=8)
        pool = _pool(slots=1, store=store)
        p = _prompts((5,), seed=18)[0]
        ref_eng = _port(max_batch=1, adapters=_pool(slots=1))
        ref = ref_eng.submit(p, max_new_tokens=4, adapter_id=1)
        ref_eng.run()
        sup = tserving.EngineSupervisor(
            lambda: _port(max_batch=1, adapters=pool), backoff_s=0.0,
            sleep=lambda s: None)
        if site == "adapter_promote":
            for q, aid in zip(_prompts((4, 4), seed=19), (1, 2)):
                w = sup.submit(q, max_new_tokens=2, adapter_id=aid)
                sup.run()
                assert w.done
            assert pool.demotions_total >= 1
        inj = tserving.FaultInjector(seed=0)
        inj.arm(site, "raise", nth=1)
        with inj:
            r = sup.submit(p, max_new_tokens=4, adapter_id=1)
            sup.run()
        assert inj.fired[site] == 1, f"{site} never fired"
        assert sup.recoveries >= 1 and sup.health != "dead"
        np.testing.assert_array_equal(r.output, ref.output)

    def test_adapter_metrics_emitted(self):
        tobs.REGISTRY.clear()
        tobs.enable()
        try:
            pool = _pool(slots=1, store=tserving.HostPageStore(page_size=8))
            eng = _port(max_batch=1, adapters=pool)
            for aid in (1, 2, 1):        # load, evict + load, promote
                eng.submit(_prompts((4,), seed=17)[0], max_new_tokens=2,
                           adapter_id=aid)
                eng.run()
            snap = tobs.REGISTRY.to_json()
        finally:
            tobs.disable()
            tobs.REGISTRY.clear()
        vals = snap["serving_adapter_loads_total"]["values"]
        assert sum(vals.values()) == 3
        assert [v for k, v in vals.items() if "promote" in k] == [1]
        assert snap["serving_adapter_demotions_total"]["values"][""] >= 2
        assert snap["serving_adapter_slots_used"]["values"][""] == 1
        assert snap["serving_adapter_load_ms"]["values"][""]["count"] == 3
        # the trace-time gather hook has no caller in the port
        assert "serving_adapter_gather_bytes_total" not in snap


# --------------------------------------------------------- the port's own

def test_reclaimed_slot_keeps_no_stale_rank_columns():
    """A slot that held a rank-8 adapter, reclaimed for a rank-2 one,
    holds exactly the new factors zero-padded: the install writes the
    whole slot row, so the old adapter's rank columns 2-7 are gone."""
    reg = tserving.AdapterRegistry(_cfg())
    reg.register(1, tserving.init_lora(_cfg(), 8, seed=60))
    reg.register(2, tserving.init_lora(_cfg(), 2, seed=61, alpha=4.0))
    pool = _pool(slots=1, rank=8, registry=reg)
    assert pool.acquire(1) == 1
    pool.release(1)
    assert pool.acquire(2) == 1 and pool.evictions_total == 1
    src = reg.get(2)
    for n in tserving.FACTOR_NAMES:
        got = _slot_rows(pool, n, 1)
        want = np.zeros_like(got)
        if n in ("aq", "ao"):
            want[:, :, :2] = src[n]
        else:
            want[:, :2] = src[n]
        np.testing.assert_array_equal(got, want)
    assert float(pool.arrays["scale"][1]) == 2.0


def test_handoff_pins_on_the_importing_engine():
    """A prefilled adapter request handed to a second engine (its own
    pool, the same registry) decodes the tokens of in-place decode; the
    exporting engine's pin drops at ``finish_handoff``."""
    p = _prompts((9,), seed=30)[0]
    ref = _port(adapters=_pool())
    want = ref.submit(p, max_new_tokens=5, adapter_id=3)
    ref.run()
    src_pool, dst_pool = _pool(), _pool()
    src, dst = _port(adapters=src_pool), _port(adapters=dst_pool)
    r = src.submit(p, max_new_tokens=5, adapter_id=3)
    src._admit()
    while src.pending_prefills():
        src.prefill_step()
    payload = src.export_prefilled(r)
    assert dst.import_prefilled(r, payload)
    assert src_pool.pins(3) == 1 and dst_pool.pins(3) == 1
    src.finish_handoff(r, payload["slot"])
    assert src_pool.pins(3) == 0
    dst.run()
    assert list(r.tokens) == list(want.tokens)
    assert dst_pool.pins(3) == 0
    _balanced(src)
    _balanced(dst)


def test_drain_restore_keeps_the_adapter(tmp_path):
    """A session drained mid-decode restores into a fresh supervisor
    (the restarted process: its own pool over the same registry) with
    its adapter, and finishes with an uninterrupted run's tokens."""
    p = _prompts((6,), seed=31)[0]
    ref = _port(adapters=_pool())
    want = ref.submit(p, max_new_tokens=6, adapter_id=2)
    ref.run()
    sup = tserving.EngineSupervisor(lambda: _port(adapters=_pool()),
                                    sleep=lambda s: None)
    r = sup.submit(p, max_new_tokens=6, adapter_id=2)
    for _ in range(3):
        sup.step()
    assert 0 < len(r.tokens) < 6
    path = str(tmp_path / "drain.npz")
    sup.drain(path)
    pool = _pool()
    sup2 = tserving.EngineSupervisor.restore(
        lambda: _port(adapters=pool), path, sleep=lambda s: None)
    (got,) = sup2.restored.values()
    assert got.adapter_id == 2 and got.rid == r.rid
    sup2.run()
    assert list(got.tokens) == list(want.tokens)
    assert pool.pins(2) == 0
