"""The port's continuous-batching engine against the JAX engine, on CPU.

Both engines get the same parameters (the JAX tree through
``params_from_jax``) and serve the same sequence of workloads, greedy,
on one engine each: ``max_batch=2, page_size=8, max_len=32,
prefill_chunk=8`` and a pool of 6 usable pages, so that

1. mixed prompt lengths admit mid-decode and prefill in 8-token chunks;
2. a shared-prefix workload maps full trie pages and copies the partial
   page on write — the ``stats()`` share and CoW counts must equal the
   JAX engine's;
3. two 4-page requests cannot both fit: the second waits (pool
   back-pressure) until the first retires;
4. a request retires on its EOS token.

Greedy tokens must be identical to the JAX engine's for KV {None, int8}
x ``fused`` {off, on}, each tier against the JAX engine built with the
same ``kv_cache_dtype`` and ``fused``. With ``temperature=0.8`` the
port's requests run to ``max_new_tokens`` (no identity: the two
frameworks draw different random numbers). After each drain the
allocator is balanced.
"""
import numpy as np
import jax
import pytest
import torch

from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jl
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import params_from_jax

import test_torch_scheduler as ts

torch.set_num_threads(1)
ENGINE_KW = dict(max_batch=2, page_size=8, max_len=32, num_pages=7,
                 prefill_chunk=8)
STATS_KEYS = ("allocs_total", "frees_total", "shares_total",
              "alloc_failures", "num_used", "cow_copies",
              "prefix_evictions_total", "steps")


def _workloads(vocab):
    """(name, [(prompt, max_new, eos)]) in serving order; the EOS entry
    is filled in from the first run of its prompt."""
    rs = np.random.RandomState(11)

    def p(n):
        return rs.randint(3, vocab, (n,)).astype(np.int32)

    prefix = p(12)
    eos_prompt = p(7)
    return [
        ("mixed", [(p(5), 6, None), (p(11), 4, None), (p(3), 7, None),
                   (p(9), 5, None)]),
        ("prefix", [(np.concatenate([prefix, p(3)]), 4, None),
                    (np.concatenate([prefix, p(2)]), 4, None),
                    (np.concatenate([prefix, p(4)]), 3, None),
                    (np.concatenate([prefix, p(1)]), 4, None)]),
        ("backpressure", [(p(20), 8, None), (p(21), 8, None)]),
        ("eos_probe", [(eos_prompt, 8, None)]),
        ("eos", [(eos_prompt, 8, "probe")]),
    ]


def _serve(engine, workloads):
    """Run the workloads in order on one engine; returns per workload
    the generated tokens, finish reasons and the stats snapshot."""
    out, eos = {}, None
    for name, reqs in workloads:
        hs = []
        for prompt, new, e in reqs:
            hs.append(engine.submit(prompt, max_new_tokens=new,
                                    eos_token_id=eos if e else None))
        engine.run()
        toks = [list(h.tokens) for h in hs]
        if name == "eos_probe":
            eos = toks[0][2]        # retire the next run at its 3rd token
        st = engine.stats()
        out[name] = dict(tokens=toks,
                         reasons=[h.finish_reason for h in hs],
                         stats={k: st[k] for k in STATS_KEYS})
    return out


def _jax_engine(*a, **kw):
    """A JAX engine that shares its compiled programs
    (``test_torch_scheduler._share_programs``)."""
    eng = JaxEngine(*a, **kw)
    ts._share_programs(eng)
    return eng


@pytest.fixture(scope="module")
def setup():
    jcfg = jl.LlamaConfig.tiny(num_layers=2, max_seq_len=64)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tcfg = tl.LlamaConfig.tiny(num_layers=2, max_seq_len=64)
    work = _workloads(jcfg.vocab_size)
    ref = {(kv, fused): _serve(_jax_engine(jp, jcfg, kv_cache_dtype=kv,
                                           fused=fused, **ENGINE_KW), work)
           for kv in (None, "int8") for fused in (False, True)}
    return tcfg, tp, work, ref


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_greedy_tokens_and_stats_match_jax_engine(setup, kv, fused):
    tcfg, tp, work, ref = setup
    eng = ContinuousBatchingEngine(tp, tcfg, kv_cache_dtype=kv, fused=fused,
                                   device="cpu", **ENGINE_KW)
    got = _serve(eng, work)
    want = ref[kv, fused]
    for name, _ in work:
        assert got[name]["tokens"] == want[name]["tokens"], name
        assert got[name]["reasons"] == want[name]["reasons"], name
        assert got[name]["stats"] == want[name]["stats"], name
    # the workloads exercised what they are there for
    assert want["prefix"]["stats"]["cow_copies"] > 0
    assert (want["prefix"]["stats"]["shares_total"]
            > want["mixed"]["stats"]["shares_total"])
    assert want["backpressure"]["stats"]["alloc_failures"] > 0
    assert want["eos"]["reasons"] == ["eos"]
    assert len(want["eos"]["tokens"][0]) < 8
    _assert_balanced(eng)


def _assert_balanced(eng):
    """After a drain only the prefix trie holds pages; dropping it
    returns every reference."""
    assert eng.idle
    eng.cache.prefix.drop_all(eng.cache.allocator)
    alloc = eng.cache.allocator
    assert alloc.num_used == 0
    assert alloc.allocs_total == alloc.frees_total
    assert not eng.cache.active.any()


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_sampled_requests_run_to_max_new_tokens(setup, kv, fused):
    tcfg, tp, work, _ = setup
    eng = ContinuousBatchingEngine(
        tp, tcfg, kv_cache_dtype=kv, fused=fused, temperature=0.8,
        generator=torch.Generator().manual_seed(1), device="cpu",
        **ENGINE_KW)
    reqs = work[0][1]
    hs = [eng.submit(p, max_new_tokens=n) for p, n, _ in reqs]
    eng.run()
    for h, (_, n, _) in zip(hs, reqs):
        assert h.done and h.finish_reason == "max_len"
        assert len(h.tokens) == n
        assert all(0 <= t < tcfg.vocab_size for t in h.tokens)
    _assert_balanced(eng)


def test_oversized_and_empty_requests_raise(setup):
    tcfg, tp, _, _ = setup
    eng = ContinuousBatchingEngine(tp, tcfg, device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(np.arange(3, 30, dtype=np.int32), max_new_tokens=8)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros((0,), np.int32))
