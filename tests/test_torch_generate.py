"""The port's dense decoding against the JAX package's, on the CPU.

Kernel B7's plain version (``ops.kernels.fused.decode_attention_plain``)
is held against the JAX ``decode_attention`` Pallas kernel in interpret
mode (``block_k=16`` over S = 40: three key blocks, the last ragged) and
against the JAX composition ``_attn_with_cache(use_kernel=False)``, in
float32 with fp and int8 rows, GQA rep 1 and 2, per-row lengths from 1
to S: atol = rtol = 1e-5 (the kernel's online softmax sums in another
order). One decode step's logits of ``_forward_cached`` go against the
JAX function's through its kernel and through its composition: 1e-5 for
fp caches; int8 caches hold each dequantized row within one quantization
step of JAX's and the logits within 1e-4 (a value within an ulp of a
rounding boundary may land on the neighbouring int8 step).
``quantize_weights`` is bit-equal to JAX's (int4 held as int8 values),
and so is ``_w``. Greedy ``generate`` and ``beam_search`` give JAX's
tokens over KV {fp, int8} x weights {fp, int8, int4}, EOS, left-padded
batches and the prompt cache; sampling is checked by its own rules (the
two frameworks draw different random numbers). On the CPU the decode
steps run B7's plain version once per layer and step, which a counter on
it shows. The engine's ``weight_bits`` gives the JAX engine's tokens.
Config: ``tiny(num_layers=2, max_seq_len=64)`` in float32.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import generate as jgen
from paddle_tpu.models import llama as jl
from paddle_tpu.ops.pallas import fused as jfz
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import generate as tgen
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import params_from_jax
from paddle_tpu_torch.ops.kernels import fused as fk

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
NEW = 8
_JAX = {}


def _jax_once(key, fn):
    """A JAX result that parametrised cases share, computed once a
    module."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


@pytest.fixture(scope="module")
def model():
    jcfg = jl.LlamaConfig.tiny(num_layers=2, max_seq_len=64)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tl.LlamaConfig.tiny(num_layers=2, max_seq_len=64), tp


@pytest.fixture(scope="module")
def prompt():
    return np.random.RandomState(0).randint(3, 256, (3, 7)).astype(np.int32)


@pytest.fixture(scope="module")
def quantized(model):
    """{bits: (JAX params, port params)} for fp, int8 and int4."""
    jcfg, jp, tcfg, tp = model
    out = {None: (jp, tp)}
    for bits in (8, 4):
        out[bits] = (jgen.quantize_weights(jp, jcfg, bits=bits),
                     tgen.quantize_weights(tp, tcfg, bits=bits))
    return out


def _jgen(params, prompt, cfg, **kw):
    return np.asarray(jgen.generate(params, jnp.asarray(prompt), cfg, **kw))


def _tgen(params, prompt, cfg, **kw):
    return tgen.generate(params, prompt, cfg, **kw).numpy()


# ---------------- B7's plain version ----------------
def _decode_inputs(q8: bool, rep: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    B, S, HK, D = 4, 40, 2, 16
    q = rs.randn(B, HK * rep, D).astype(np.float32)
    if q8:
        k = rs.randint(-127, 128, (B, S, HK, D)).astype(np.int8)
        v = rs.randint(-127, 128, (B, S, HK, D)).astype(np.int8)
        ks = (rs.rand(B, S, HK) * 0.05 + 0.01).astype(np.float32)
        vs = (rs.rand(B, S, HK) * 0.05 + 0.01).astype(np.float32)
    else:
        k = rs.randn(B, S, HK, D).astype(np.float32)
        v = rs.randn(B, S, HK, D).astype(np.float32)
        ks = vs = None
    return q, k, v, ks, vs


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("q8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("rep", [1, 2])
def test_decode_attention_plain_matches_jax_kernel_and_composition(q8, rep):
    q, k, v, ks, vs = _decode_inputs(q8, rep)
    lens = np.asarray([1, 40, 17, 33], np.int32)
    want = jfz.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        block_k=16, k_dequant_rows=None if ks is None else jnp.asarray(ks),
        v_dequant_rows=None if vs is None else jnp.asarray(vs))
    got = fk.decode_attention(_t(q), _t(k), _t(v), _t(lens), k_rows=_t(ks),
                              v_rows=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for n in (40, 17):     # the composition takes one length for all rows
        want = jgen._attn_with_cache(
            jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v), n,
            q.shape[1], use_kernel=False,
            k_rows=None if ks is None else jnp.asarray(ks),
            v_rows=None if vs is None else jnp.asarray(vs))[:, 0]
        got = fk.decode_attention_plain(_t(q), _t(k), _t(v), n,
                                        k_rows=_t(ks), v_rows=_t(vs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_attention_rows_go_together():
    q, k, v, ks, _ = _decode_inputs(True, 1)
    with pytest.raises(ValueError, match="together"):
        fk.decode_attention(_t(q), _t(k), _t(v), 4, k_rows=_t(ks))
    with pytest.raises(ValueError, match="together"):
        jfz.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             4, k_dequant_rows=jnp.asarray(ks))


# ---------------- the decode step ----------------
@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("jax_kernel", [True, False],
                         ids=["jax-kernel", "jax-composition"])
def test_decode_step_logits_match_jax(model, prompt, kv, jax_kernel):
    """Prefill a prompt into a dense cache, then one decode step: the
    port's logits (B7's plain version) against JAX's, through its Pallas
    kernel in interpret mode or its composition."""
    jcfg, jp, tcfg, tp = model
    S, max_len = prompt.shape[1], 16
    tc = tgen.init_cache(tcfg, 3, max_len, kv_dtype=kv, device="cpu")
    # the prefill does not see ``jax_kernel``: once a KV dtype
    jc = _jax_once(("prefill", kv), lambda: jgen._forward_cached(
        jp, jnp.asarray(prompt), jgen.init_cache(jcfg, 3, max_len,
                                                 kv_dtype=kv),
        0, jcfg, max_len)[1])
    tgen._forward_cached(tp, torch.from_numpy(prompt), tc, 0, tcfg, max_len)
    tok = np.asarray([[5], [77], [200]], np.int32)
    jlog, jc = jgen._forward_cached(jp, jnp.asarray(tok), jc, S, jcfg,
                                    max_len, use_kernel=jax_kernel)
    tlog = tgen._forward_cached(tp, torch.from_numpy(tok), tc, S, tcfg,
                                max_len)
    if kv is None:
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       **TOL)
        return
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    for n, s in (("k", "ks"), ("v", "vs")):
        js, ts = np.asarray(jc[s]), tc[s].numpy()
        np.testing.assert_allclose(ts, js, **TOL)
        jrow = np.asarray(jc[n]).astype(np.float32) * js[..., None]
        trow = tc[n].numpy().astype(np.float32) * ts[..., None]
        assert np.all(np.abs(jrow - trow)
                      <= np.maximum(js, ts)[..., None] * (1 + 1e-4))


def test_use_kernel_true_raises_on_the_cpu(model, prompt):
    _, _, tcfg, tp = model
    with pytest.raises(ValueError, match="CUDA"):
        tgen.generate(tp, prompt, tcfg, max_new_tokens=3, use_kernel=True)


# ---------------- weight quantization ----------------
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_weights_bit_equal_to_jax(model, quantized, bits):
    jcfg, _, tcfg, _ = model
    jq, tq = quantized[bits]
    # the JAX leaves crossed over (int4 arrives as int8 values)
    cross = params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
        for leaf in (name, name + "_scale"):
            a, b = tq["layers"][leaf], cross["layers"][leaf]
            assert a.dtype == b.dtype and torch.equal(a, b), leaf
        for l in range(jcfg.num_layers):
            jw = jgen._w(jax.tree.map(lambda x: x[l], jq["layers"]), name,
                         jnp.float32)
            tw = tgen._w(tl.layer_params(tq, l), name, torch.float32)
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert torch.equal(tq["lm_head"], cross["lm_head"])
    assert torch.equal(tq["lm_head_scale"], cross["lm_head_scale"])
    np.testing.assert_array_equal(
        tgen._w(tq, "lm_head", torch.float32).numpy(),
        np.asarray(jgen._w(jq, "lm_head", jnp.float32)))
    if bits == 4:
        assert int(tq["layers"]["wq"].abs().max()) <= 7
        assert tq["layers"]["wq_scale"].dim() == 3           # (L, G, out)
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        tgen.quantize_weights(model[3], tcfg, bits=3)


# ---------------- greedy generate ----------------
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["w-fp", "w8", "w4"])
@pytest.mark.parametrize("kv", [None, "int8"], ids=["kv-fp", "kv8"])
def test_greedy_generate_matches_jax(model, quantized, prompt, kv, bits):
    jcfg, _, tcfg, _ = model
    jp, tp = quantized[bits]
    want = _jgen(jp, prompt, jcfg, max_new_tokens=NEW, kv_cache_dtype=kv)
    got = _tgen(tp, prompt, tcfg, max_new_tokens=NEW, kv_cache_dtype=kv)
    np.testing.assert_array_equal(got, want)


def test_eos_pins_the_tail_as_jax(model, prompt):
    jcfg, jp, tcfg, tp = model
    free = _jgen(jp, prompt, jcfg, max_new_tokens=NEW)
    eos = int(free[0, prompt.shape[1] + 2])       # row 0's third token
    want = _jgen(jp, prompt, jcfg, max_new_tokens=NEW, eos_token_id=eos)
    got = _tgen(tp, prompt, tcfg, max_new_tokens=NEW, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, prompt.shape[1] + 2:] == eos).all()


def test_left_padded_batches_match_jax_and_unpadded(model, prompt):
    jcfg, jp, tcfg, tp = model
    pad = 0
    padded = prompt.copy()
    padded[1, :3] = pad
    padded[2, :5] = pad
    lens = np.asarray([7, 4, 2], np.int32)
    for kw in (dict(pad_token_id=pad), dict(prompt_lengths=lens)):
        want = _jgen(jp, padded, jcfg, max_new_tokens=NEW, **kw)
        got = _tgen(tp, padded, tcfg, max_new_tokens=NEW, **kw)
        np.testing.assert_array_equal(got, want)
    # row 2 decodes as its unpadded 2-token prompt would
    alone = _tgen(tp, prompt[2:, 5:], tcfg, max_new_tokens=NEW)
    np.testing.assert_array_equal(got[2, 7:], alone[0, 2:])


@pytest.mark.parametrize("kv", [None, "int8"])
def test_prompt_cache_matches_jax_and_the_concatenated_prompt(model, prompt,
                                                              kv):
    jcfg, jp, tcfg, tp = model
    prefix = np.random.RandomState(1).randint(3, 256, (6,)).astype(np.int32)
    jpc = jgen.precompute_prompt_cache(jp, jnp.asarray(prefix), jcfg,
                                       kv_cache_dtype=kv)
    tpc = tgen.precompute_prompt_cache(tp, prefix, tcfg, kv_cache_dtype=kv)
    want = _jgen(jp, prompt, jcfg, max_new_tokens=NEW, kv_cache_dtype=kv,
                 prompt_cache=jpc)
    got = _tgen(tp, prompt, tcfg, max_new_tokens=NEW, kv_cache_dtype=kv,
                prompt_cache=tpc)
    np.testing.assert_array_equal(got, want)
    full = np.concatenate([np.broadcast_to(prefix, (3, 6)), prompt], 1)
    whole = _tgen(tp, full, tcfg, max_new_tokens=NEW, kv_cache_dtype=kv)
    np.testing.assert_array_equal(got[:, 7:], whole[:, 13:])


def test_errors_equal_jax(model, prompt):
    jcfg, jp, tcfg, tp = model
    prefix = np.arange(3, 9, dtype=np.int32)
    jpc = jgen.precompute_prompt_cache(jp, jnp.asarray(prefix), jcfg)
    tpc = tgen.precompute_prompt_cache(tp, prefix, tcfg)
    cases = [
        ("int8", dict(kv_cache_dtype="int8", prompt_cache=(jpc, tpc))),
        ("prompt_cache", dict(pad_token_id=0, prompt_cache=(jpc, tpc))),
    ]
    for match, kw in cases:
        for side, (p, cfg, run) in enumerate(((jp, jcfg, _jgen),
                                              (tp, tcfg, _tgen))):
            kw2 = {k: (v[side] if k == "prompt_cache" else v)
                   for k, v in kw.items()}
            with pytest.raises(ValueError, match=match):
                run(p, prompt, cfg, max_new_tokens=3, **kw2)
    for p, cfg, mod, pre in ((jp, jcfg, jgen, jnp.asarray),
                             (tp, tcfg, tgen, torch.from_numpy)):
        with pytest.raises(ValueError, match="one sequence"):
            mod.precompute_prompt_cache(p, pre(np.zeros((2, 4), np.int32)),
                                        cfg)
    with pytest.raises(AssertionError):
        _jgen(jp, prompt, jcfg, max_new_tokens=NEW, max_len=10)
    with pytest.raises(AssertionError):
        _tgen(tp, prompt, tcfg, max_new_tokens=NEW, max_len=10)


# ---------------- sampling ----------------
def test_sampling_rules(model, prompt):
    _, _, tcfg, tp = model
    greedy = _tgen(tp, prompt, tcfg, max_new_tokens=NEW)
    for kw in (dict(top_p=1e-6), dict(top_k=1)):
        got = _tgen(tp, prompt, tcfg, max_new_tokens=NEW, temperature=0.7,
                    **kw)
        np.testing.assert_array_equal(got, greedy)

    def draw(seed, **kw):
        return _tgen(tp, prompt, tcfg, max_new_tokens=NEW, temperature=1.5,
                     generator=torch.Generator().manual_seed(seed), **kw)

    k = 3
    for kw in (dict(top_k=k), dict(top_k=k, top_p=0.95)):
        a = draw(7, **kw)
        np.testing.assert_array_equal(a, draw(7, **kw))
        # each sampled token lies in its step's top-k set
        logits = tl.forward(tp, torch.from_numpy(a[:, :-1].copy()), tcfg)
        S = prompt.shape[1]
        topk = torch.topk(logits[:, S - 1:], k, dim=-1).indices.numpy()
        assert (topk == a[:, S:, None]).any(-1).all()
    assert not np.array_equal(draw(7), greedy)


# ---------------- beam search ----------------
def test_beam_search_matches_jax(model, prompt):
    jcfg, jp, tcfg, tp = model
    one = tgen.beam_search(tp, prompt, tcfg, num_beams=1,
                           max_new_tokens=NEW).numpy()
    np.testing.assert_array_equal(one, _tgen(tp, prompt, tcfg,
                                             max_new_tokens=NEW))
    np.testing.assert_array_equal(one, np.asarray(jgen.beam_search(
        jp, jnp.asarray(prompt), jcfg, num_beams=1, max_new_tokens=NEW)))
    four = tgen.beam_search(tp, prompt, tcfg, num_beams=4,
                            max_new_tokens=NEW).numpy()
    eos = int(four[1, prompt.shape[1] + 1])
    padded = prompt.copy()
    padded[2, :4] = 0
    for p, kw in ((prompt, {}), (prompt, dict(eos_token_id=eos)),
                  (padded, dict(pad_token_id=0, eos_token_id=eos))):
        want = np.asarray(jgen.beam_search(jp, jnp.asarray(p), jcfg,
                                           num_beams=4, max_new_tokens=NEW,
                                           **kw))
        got = tgen.beam_search(tp, p, tcfg, num_beams=4, max_new_tokens=NEW,
                               **kw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


# ---------------- B7 on the decode steps ----------------
def test_decode_steps_run_b7_once_per_layer(model, prompt, monkeypatch):
    _, _, tcfg, tp = model
    calls = []
    plain = fk.decode_attention_plain
    monkeypatch.setattr(fk, "decode_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    L = tcfg.num_layers
    for kw, want in ((dict(), L * (NEW - 1)),
                     (dict(kv_cache_dtype="int8"), L * (NEW - 1)),
                     (dict(pad_token_id=0), 0),
                     (dict(use_kernel=False), 0)):
        calls.clear()
        _tgen(tp, prompt, tcfg, max_new_tokens=NEW, **kw)
        assert len(calls) == want, kw
    calls.clear()
    tgen.beam_search(tp, prompt, tcfg, num_beams=2, max_new_tokens=NEW)
    assert len(calls) == L * (NEW - 1)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["kv-fp", "kv-int8"])
def test_decode_steps_build_one_device_length_tensor(model, prompt, kv,
                                                     monkeypatch):
    """Each dense decode step hands B7 one (B,) int32 length tensor on
    the model's device, built once for all its layers (no layer builds
    its own), holding the step's length; ``generate`` reads no tensor on
    the host (the kernel reads the lengths on the card)."""
    _, _, tcfg, tp = model
    seen = []
    plain = fk.decode_attention_plain

    def spy(q, k, v, n, **kw):
        seen.append(n)
        return plain(q, k, v, n, **kw)

    def host_read(*a, **k):
        raise AssertionError("generate read a tensor on the host")

    monkeypatch.setattr(fk, "decode_attention_plain", spy)
    for name in ("item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    out = tgen.generate(tp, prompt, tcfg, max_new_tokens=NEW,
                        kv_cache_dtype=kv)
    monkeypatch.undo()
    L, (B, S) = tcfg.num_layers, prompt.shape
    assert tuple(out.shape) == (B, S + NEW) and len(seen) == L * (NEW - 1)
    for i in range(NEW - 1):
        step = seen[i * L:(i + 1) * L]
        assert all(t is step[0] for t in step), i
        assert isinstance(step[0], torch.Tensor)
        assert step[0].dtype == torch.int32 and step[0].device == out.device
        assert torch.equal(step[0], torch.full((B,), S + i + 1,
                                               dtype=torch.int32)), i


# ---------------- the engine's weight_bits ----------------
ENGINE_KW = dict(max_batch=2, page_size=8, max_len=32, prefill_chunk=8)


@pytest.fixture(scope="module")
def engine_prompts():
    rs = np.random.RandomState(3)
    return [rs.randint(3, 256, (n,)).astype(np.int32) for n in (5, 11, 3)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_engine_weight_bits_matches_jax_engine(model, engine_prompts, bits,
                                               fused):
    jcfg, jp, tcfg, tp = model
    want = JaxEngine(jp, jcfg, weight_bits=bits, fused=fused,
                     **ENGINE_KW).generate(engine_prompts, max_new_tokens=6)
    eng = ContinuousBatchingEngine(tp, tcfg, weight_bits=bits, fused=fused,
                                   device="cpu", **ENGINE_KW)
    got = eng.generate(engine_prompts, max_new_tokens=6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert eng.stats()["weight_bits"] == bits
    assert eng.params["layers"]["wq"].dtype == torch.int8


def test_draft_engine_with_int8_weights_matches_plain(model, engine_prompts):
    """Greedy draft-model speculation over int8 weights (the draft's
    layer views carry their scales) gives the plain int8 engine's
    tokens."""
    _, _, tcfg, tp = model
    plain = ContinuousBatchingEngine(tp, tcfg, weight_bits=8, device="cpu",
                                     **ENGINE_KW)
    draft = ContinuousBatchingEngine(tp, tcfg, weight_bits=8, device="cpu",
                                     spec_k=2, draft_layers=1, **ENGINE_KW)
    want = plain.generate(engine_prompts, max_new_tokens=6)
    got = draft.generate(engine_prompts, max_new_tokens=6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert draft.stats()["spec_verify_steps"] > 0
    assert "wq_scale" in draft.draft_params["layers"]
