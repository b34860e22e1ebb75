"""The port's weight bridge and model functions against the JAX package.

(b) every leaf of ``llama.init_params`` crosses ``params_from_jax`` bit
for bit, bf16 included, into the port's leaf names and layout;
(c) ``paged_prefill_chunk`` and ``paged_decode_forward`` give the JAX
functions' logits at atol = rtol = 1e-4 (XLA-CPU and PyTorch sum in
different orders) and write the same pools: fp pools at the same
tolerance, int8 pools equal after dequantization within one
quantization step. Inputs are seeded numpy, the config is
``tiny(num_layers=2, max_seq_len=64)`` in float32.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.models import generate as jgen
from paddle_tpu.models import llama as jl
from paddle_tpu_torch.models import generate as tgen
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import params_from_jax

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
_JAX = {}


def _jax_once(key, fn):
    """A JAX result that cases share (``fused`` is the port's flag alone),
    computed once a module."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trips_every_leaf(dtype):
    jcfg = jl.LlamaConfig.tiny(num_layers=2, max_seq_len=64,
                               dtype=getattr(jnp, dtype))
    jp = jax.tree.map(np.asarray, jl.init_params(jax.random.key(3), jcfg))
    tp = dict(_leaves(params_from_jax(jp, device="cpu")))
    want = dict(_leaves(jp))
    assert tp.keys() == want.keys()
    for name, a in want.items():
        t = tp[name]
        assert t.dtype == getattr(torch, dtype), name
        assert tuple(t.shape) == a.shape, name
        if dtype == "bfloat16":
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                a.view(np.uint16), err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), a, err_msg=name)
    # the port's own init builds the same tree: names, shapes, dtype
    own = dict(_leaves(tl.init_params(
        tl.LlamaConfig.tiny(num_layers=2, max_seq_len=64,
                            dtype=getattr(torch, dtype)),
        torch.Generator().manual_seed(0), device="cpu")))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tp.items()}


def test_rms_norm_and_rope_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 4, 16).astype(np.float32)
    w = rs.randn(16).astype(np.float32)
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-6, atol=1e-6)
    jc, js = jl.rope_tables(64, 16, 10000.0)
    tc, ts = tl.rope_tables(64, 16, 10000.0, device="cpu")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(
        tl.apply_rope(torch.from_numpy(x), tc[:5], ts[:5]).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), jc[:5], js[:5])),
        rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    jcfg = jl.LlamaConfig.tiny(num_layers=2, max_seq_len=64)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tl.LlamaConfig.tiny(num_layers=2, max_seq_len=64), tp


def _check_pools(jpool, tpool):
    if "ks" not in jpool:
        for n in ("k", "v"):
            np.testing.assert_allclose(tpool[n].numpy(),
                                       np.asarray(jpool[n]), **TOL)
        return
    for n, s in (("k", "ks"), ("v", "vs")):
        jq = np.asarray(jpool[n]).astype(np.float32)
        js = np.asarray(jpool[s])
        tq = tpool[n].numpy().astype(np.float32)
        ts = tpool[s].numpy()
        np.testing.assert_allclose(ts, js, **TOL)
        step = np.maximum(js, ts)[..., None]      # one quantization step
        assert np.all(np.abs(jq * js[..., None] - tq * ts[..., None])
                      <= step * (1 + 1e-4))


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_prefill_chunks_then_decode_match_jax(model, kv, fused):
    """Two prefill chunks into a 4-page block table (the second against
    a gathered, right-aligned context), then two decode steps of a
    2-row batch whose second row is inactive. The token seed is one at
    which no K/V value lands within an ulp of an int8 rounding boundary:
    where one does (seeds 4 and 7), XLA's and PyTorch's f32 sums round it
    to neighbouring int8 steps — which ``_check_pools`` accepts — and the
    logits then differ by ~1e-3, beyond the 1e-4 bound."""
    jcfg, jp, tcfg, tp = model
    page, P = 8, 9
    rs = np.random.RandomState(5)
    tokens = rs.randint(3, jcfg.vocab_size, (15,)).astype(np.int32)
    table = np.asarray([3, 5, 1, 7], np.int32)
    jpool = jgen.init_paged_cache(jcfg, P, page, kv_dtype=kv)
    tpool = tgen.init_paged_cache(tcfg, P, page, kv_dtype=kv, device="cpu")
    done = 0
    for take in (6, 8):
        chunk = np.zeros((1, 8), np.int32)
        chunk[0, :take] = tokens[done:done + take]
        ctx_cap = -(-done // page) * page
        jl_, jpool = _jax_once(
            ("chunk", kv, done), lambda: jgen.paged_prefill_chunk(
                jp, jnp.asarray(chunk), jpool, jnp.asarray(table), jcfg,
                ctx_cap=ctx_cap, ctx_len=done, chunk_len=take))
        tl_, tpool = tgen.paged_prefill_chunk(
            tp, torch.from_numpy(chunk), tpool, torch.from_numpy(table),
            tcfg, ctx_cap=ctx_cap, ctx_len=done, chunk_len=take,
            fused=fused)
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **TOL)
        _check_pools(jpool, tpool)
        done += take
    tables = np.stack([table, np.zeros(4, np.int32)])
    active = np.asarray([True, False])
    last = np.asarray([tokens[done], 0], np.int32)
    for step in range(2):
        lengths = np.asarray([done + step, 0], np.int32)
        jlog, jpool = _jax_once(
            ("decode", kv, step), lambda: jgen.paged_decode_forward(
                jp, jnp.asarray(last), jpool, jnp.asarray(tables),
                jnp.asarray(lengths), jcfg, active=jnp.asarray(active)))
        tlog, tpool = tgen.paged_decode_forward(
            tp, torch.from_numpy(last), tpool, torch.from_numpy(tables),
            torch.from_numpy(lengths), tcfg,
            active=torch.from_numpy(active), fused=fused)
        np.testing.assert_allclose(tlog.numpy()[0], np.asarray(jlog)[0],
                                   **TOL)
        _check_pools(jpool, tpool)
        last = np.asarray([int(np.argmax(np.asarray(jlog)[0])), 0],
                          np.int32)


def test_bad_kv_dtype_raises():
    cfg = tl.LlamaConfig.tiny()
    with pytest.raises(ValueError, match="not supported"):
        tgen.init_paged_cache(cfg, 4, 8, kv_dtype="int4", device="cpu")
