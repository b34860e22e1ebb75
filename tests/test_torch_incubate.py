"""The port's ``incubate.nn.functional`` fused serving ops against the
JAX package's, on the CPU, and the Paddle fused-op decoder of
``chip_smoke.py`` phase 3d against the same decoder written on the JAX
package.

Each op runs in two modes on both sides. "composition": no kernel path
(the JAX package off a TPU without interpret mode; the port on CPU
tensors). "forced": ``PADDLE_TPU_FORCE_PALLAS_FUSED=1`` and, on the JAX
side, the Pallas kernels in interpret mode (``set_interpret``), so the
fused paths run: B4a (``fused_rms_norm``), B5a (``swiglu``), B6
(``fused_rotary_position_embedding``) and B8 (the pure-decode branch of
``block_multihead_attention``), whose port wrappers take their plain
versions on CPU tensors. Inputs are seeded numpy arrays handed to both.
Tolerances, float32: outputs atol 2e-5 and gradients 2e-4 (the same
f32 math summed in other orders, as the JAX package's own dispatch
tests hold); the caches that ``block_multihead_attention`` returns, int8
included, bit for bit. The decoder (2 layers, 4 heads of 16, vocab 128,
prompts of 12, 6 new tokens, pages of 8, KV f32 and int8 with dynamic
scales): identical greedy tokens and logits within 1e-4.
"""
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as JF
from paddle_tpu.models import llama as jl
from paddle_tpu.ops.pallas import flash_attention as jfa
import paddle_tpu_torch as ptt
from paddle_tpu_torch.incubate.nn import functional as TF
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import params_from_jax
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import fused as tfz

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the phase-3d decoder)

torch.set_num_threads(1)
ATOL, GTOL = 2e-5, 2e-4


@pytest.fixture(params=["composition", "forced"])
def mode(request, monkeypatch):
    if request.param == "forced":
        monkeypatch.setenv("PADDLE_TPU_FORCE_PALLAS_FUSED", "1")
        jfa.set_interpret(True)
    else:
        monkeypatch.delenv("PADDLE_TPU_FORCE_PALLAS_FUSED", raising=False)
    yield request.param
    jfa.set_interpret(False)


def _both(a, sg=True):
    """(JAX Tensor, port Tensor on the CPU) of the numpy array ``a``."""
    a = np.asarray(a)
    return (paddle.to_tensor(a.copy(), stop_gradient=sg),
            ptt.to_tensor(a.copy(), place="cpu", stop_gradient=sg))


def _close(port, jax_t, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_t.numpy()),
                               atol=atol, rtol=0)


def _r(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _spy(monkeypatch, name):
    """Count the calls of ``ops.kernels.fused.<name>``."""
    calls = [0]
    fn = getattr(tfz, name)

    def counted(*a, **k):
        calls[0] += 1
        return fn(*a, **k)
    monkeypatch.setattr(tfz, name, counted)
    return calls


# ---------------- norms, swiglu ----------------
def test_fused_rms_norm_with_grads(mode, monkeypatch):
    calls = _spy(monkeypatch, "rms_norm_fwd_plain")
    (jx, tx), (jw, tw) = _both(_r(4, 64), sg=False), \
        _both(_r(64, seed=1), sg=False)
    jo, to = (F.fused_rms_norm(x, norm_weight=w, epsilon=1e-6)
              for F, x, w in ((JF, jx, jw), (TF, tx, tw)))
    jo.sum().backward()
    to.sum().backward()
    _close(to, jo)
    _close(tx.grad, jx.grad, GTOL)
    _close(tw.grad, jw.grad, GTOL)
    assert calls[0] == (mode == "forced")


def test_fused_rms_norm_residual(mode):
    (jx, tx), (jr, tr), (jw, tw) = (_both(_r(3, 32, seed=s))
                                    for s in (2, 3, 4))
    jw, tw = _both(_r(32, seed=4))
    outs = [F.fused_rms_norm(x, norm_weight=w, residual=r)
            for F, x, r, w in ((JF, jx, jr, jw), (TF, tx, tr, tw))]
    for j, t in zip(*outs):
        _close(t, j)
    # no weight: the composition on both sides, whatever the mode
    j, t = (F.fused_rms_norm(x, residual=r)
            for F, x, r in ((JF, jx, jr), (TF, tx, tr)))
    _close(t[0], j[0])
    _close(t[1], j[1])


def test_fused_norms_with_biases_and_axes(mode):
    """Pre-norm bias, norm bias, a norm over the last two axes, and
    fused_layer_norm with a residual: the composition on both sides."""
    (jx, tx), (jb, tb) = _both(_r(2, 3, 8, seed=5)), _both(_r(8, seed=6))
    (jw, tw), (jr, tr) = _both(_r(8, seed=7)), _both(_r(2, 3, 8, seed=8))
    res = []
    for F, x, b, w, r in ((JF, jx, jb, jw, jr), (TF, tx, tb, tw, tr)):
        res.append([
            F.fused_rms_norm(x, norm_weight=w, norm_bias=b, bias=b),
            F.fused_rms_norm(x, begin_norm_axis=1),
            *F.fused_layer_norm(x, norm_weight=w, norm_bias=b, residual=r,
                                bias=b),
            F.fused_layer_norm(x, norm_weight=w, norm_bias=b)])
    for j, t in zip(*res):
        _close(t, j)


@pytest.mark.parametrize("split", [False, True], ids=["two-arg", "one-arg"])
def test_swiglu_with_grads(mode, monkeypatch, split):
    calls = _spy(monkeypatch, "swiglu_fwd_plain")
    (jx, tx), (jy, ty) = _both(_r(4, 64, seed=9), sg=False), \
        _both(_r(4, 64, seed=10), sg=False)
    if split:
        jo, to = JF.swiglu(jx), TF.swiglu(tx)
    else:
        jo, to = JF.swiglu(jx, jy), TF.swiglu(tx, ty)
    jo.sum().backward()
    to.sum().backward()
    _close(to, jo)
    _close(tx.grad, jx.grad, GTOL)
    if not split:
        _close(ty.grad, jy.grad, GTOL)
    assert calls[0] == (mode == "forced")


# ---------------- rope ----------------
def _tables(S, D, full):
    inv = 1.0 / 10000.0 ** (np.arange(0, D, 2) / D)
    fr = np.outer(np.arange(S), inv)
    c, s = np.cos(fr).astype(np.float32), np.sin(fr).astype(np.float32)
    return (np.tile(c, (1, 2)), np.tile(s, (1, 2))) if full else (c, s)


ROPE_CASES = {
    "qk": dict(),
    "qk-gqa": dict(H=4),
    "qk-tables-full": dict(tables="full"),
    "qk-tables-half": dict(tables="half"),
    "position-ids": dict(pid=True),
    "gptj": dict(neox=False),
    "qkv": dict(v=True),
    "q-only": dict(k=False),
}


@pytest.mark.parametrize("case", list(ROPE_CASES))
def test_fused_rotary_position_embedding(mode, monkeypatch, case):
    """Forced neox q/k calls with shared tables take B6 (the VJP too);
    the other cases take the composition on both sides."""
    c = dict(dict(H=2, tables=None, pid=False, neox=True, v=False, k=True),
             **ROPE_CASES[case])
    calls = _spy(monkeypatch, "rope_plain")
    B, S, D = 2, 8, 16
    (jq, tq) = _both(_r(B, S, c["H"], D, seed=11), sg=False)
    (jk, tk) = _both(_r(B, S, 2, D, seed=12)) if c["k"] else (None, None)
    (jv, tv) = _both(_r(B, S, 2, D, seed=13)) if c["v"] else (None, None)
    kw = dict(use_neox_rotary_style=c["neox"])
    jkw, tkw = dict(kw), dict(kw)
    if c["tables"]:
        cos, sin = _tables(S, D, c["tables"] == "full")
        (jkw["cos"], tkw["cos"]), (jkw["sin"], tkw["sin"]) = \
            _both(cos), _both(sin)
    if c["pid"]:
        pid = np.random.RandomState(14).randint(0, S, (B, S))
        jkw["position_ids"], tkw["position_ids"] = _both(pid)
    jout = JF.fused_rotary_position_embedding(jq, jk, jv, **jkw)
    tout = TF.fused_rotary_position_embedding(tq, tk, tv, **tkw)
    assert [o is None for o in jout] == [o is None for o in tout]
    for j, t in zip(jout, tout):
        if j is not None:
            _close(t, j, 1e-5)
    jout[0].sum().backward()
    tout[0].sum().backward()
    _close(tq.grad, jq.grad, GTOL)
    fused = (mode == "forced" and c["neox"] and not c["pid"] and c["k"]
             and not c["v"])
    assert calls[0] == (4 if fused else 0)      # q, k forward; dq, dk


def test_rope_is_norm_preserving_and_the_model_rope():
    q = _r(2, 8, 2, 16, seed=15)
    qr, _, _ = TF.fused_rotary_position_embedding(
        ptt.to_tensor(q, place="cpu"))
    np.testing.assert_allclose(qr.numpy()[:, 0], q[:, 0], rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(qr.numpy(), axis=-1),
                               np.linalg.norm(q, axis=-1), rtol=1e-5)
    cos, sin = tl.rope_tables(8, 16, 10000.0, device="cpu")
    ref = tl.apply_rope(torch.from_numpy(q), cos, sin)
    np.testing.assert_allclose(qr.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_blha_get_max_len():
    me, md = TF.blha_get_max_len(ptt.to_tensor([3, 7], place="cpu"),
                                 ptt.to_tensor([5, 2], place="cpu"))
    assert me.shape == [1] and int(me.numpy()[0]) == 7
    assert int(md.numpy()[0]) == 5


# ---------------- block_multihead_attention ----------------
NH, HD, BS = 2, 8, 4


def _blha_case(name):
    """(positional args, keyword args) as numpy, per case; the qkv batch
    rows follow the reference tests of ``test_fused_serving.py``."""
    rs = np.random.RandomState(
        ("prefill", "mixed", "decode", "decode-int8").index(name))
    if name.startswith("decode"):            # pure decode: B8 when forced
        B = 2
        if name.endswith("int8"):
            kc = rs.randint(-90, 90, (6, NH, BS, HD)).astype(np.int8)
            vc = rs.randint(-90, 90, (6, NH, BS, HD)).astype(np.int8)
        else:
            kc = (rs.randn(6, NH, BS, HD) * 0.4).astype(np.float32)
            vc = (rs.randn(6, NH, BS, HD) * 0.4).astype(np.float32)
        args = [(rs.randn(B, 3 * NH * HD) * 0.4).astype(np.float32), kc, vc,
                np.zeros(B, np.int32), np.array([5, 9], np.int32),
                np.ones(B, np.int32)]
        kw = dict(block_tables=np.array([[0, 2, -1], [4, 1, 3]], np.int32))
        return args, kw
    B, nblocks = 2, 8
    bt = np.array([[0, 1, -1, -1], [2, 3, -1, -1]], np.int32)
    kc = np.zeros((nblocks, NH, BS, HD), np.float32)
    vc = np.zeros((nblocks, NH, BS, HD), np.float32)
    if name == "mixed":                       # row 0 prefill, row 1 decode
        for j in range(3):
            kc[2 + j // BS, :, j % BS] = rs.randn(NH, HD) * 0.5
            vc[2 + j // BS, :, j % BS] = rs.randn(NH, HD) * 0.5
        enc, dec, this = [5, 0], [0, 3], [5, 1]
    else:                                     # two prefill rows
        enc, dec, this = [6, 5], [0, 0], [6, 5]
    total = sum(this)
    args = [(rs.randn(total, 3 * NH * HD) * 0.5).astype(np.float32), kc, vc,
            np.array(enc, np.int32), np.array(dec, np.int32),
            np.array(this, np.int32)]
    return args, dict(block_tables=bt)


def _add_quant(args, kw, dynamic, dequant=False, seed=0):
    rs = np.random.RandomState(seed)
    args[1] = np.zeros(args[1].shape, np.int8) if args[1].dtype != np.int8 \
        else args[1]
    args[2] = np.zeros(args[2].shape, np.int8) if args[2].dtype != np.int8 \
        else args[2]
    shape = (2, NH) if dynamic else (NH,)
    kw.update(cache_k_quant_scales=(60 + 80 * rs.rand(*shape)).astype(
        np.float32), cache_v_quant_scales=(60 + 80 * rs.rand(*shape)).astype(
        np.float32), use_dynamic_cachekv_quant=dynamic)
    if dequant:
        kw["cache_k_dequant_scales"] = (1.1 / kw["cache_k_quant_scales"])
        kw["cache_v_dequant_scales"] = (0.9 / kw["cache_v_quant_scales"])


def _blha_kw(name):
    args, kw = _blha_case(name.split(":")[0])
    opt = name.split(":")[1] if ":" in name else ""
    rs = np.random.RandomState(17)
    if opt.startswith("int8"):
        _add_quant(args, kw, dynamic="dyn" in opt, dequant="dq" in opt)
    if opt in ("rope-neox", "rope-gptj"):
        ang = np.linspace(0, 2, 8 * HD).reshape(8, HD)
        kw["rope_emb"] = np.stack([np.cos(ang), np.sin(ang)]).reshape(
            2, 1, 1, 8, HD).astype(np.float32)
        kw["use_neox_style"] = opt == "rope-neox"
    if opt == "mask":
        m = np.zeros((1, 1, 8, 8), np.float32)
        m[..., 1:3] = -1e30
        kw["mask"] = m
    if opt == "pre":
        B = len(args[5])
        kw["pre_key_cache"] = (rs.randn(B, NH, 3, HD) * 0.5).astype(
            np.float32)
        kw["pre_value_cache"] = (rs.randn(B, NH, 3, HD) * 0.5).astype(
            np.float32)
    if opt == "bias":
        kw["qkv_bias"] = (rs.randn(3 * NH * HD) * 0.1).astype(np.float32)
    return args, kw


BLHA_CASES = ["prefill", "prefill:int8", "prefill:int8-dyn", "mixed",
              "mixed:int8-dyn", "prefill:rope-neox", "mixed:rope-gptj",
              "prefill:mask", "prefill:pre", "mixed:pre", "prefill:bias",
              "decode", "decode:pre", "decode:bias", "decode-int8:int8",
              "decode-int8:int8-dyn", "decode-int8:int8-dyn-dq"]


@pytest.mark.parametrize("case", BLHA_CASES)
def test_block_multihead_attention(mode, monkeypatch, case):
    """Output within 2e-5 of the JAX package's, the returned caches bit
    for bit (the new rows written, int8 quantized half to even, as
    ``jnp.round``), in both modes. Pure-decode batches take B8 in the
    forced mode on both sides; pre caches and the loop cases never."""
    calls = _spy(monkeypatch, "paged_decode_attention_plain")
    args, kw = _blha_kw(case)
    jres = JF.block_multihead_attention(
        *(paddle.to_tensor(a.copy()) for a in args),
        **{k: paddle.to_tensor(v.copy()) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    targs = [ptt.to_tensor(a.copy(), place="cpu") for a in args]
    tres = TF.block_multihead_attention(
        *targs, **{k: ptt.to_tensor(v.copy(), place="cpu")
                   if isinstance(v, np.ndarray) else v
                   for k, v in kw.items()})
    _close(tres[0], jres[0])
    for i in (2, 3):
        np.testing.assert_array_equal(tres[i].numpy(),
                                      np.asarray(jres[i].numpy()))
        assert tres[i] is targs[i - 1]      # written in place, returned
    pure = case.startswith("decode") and ":pre" not in case
    assert calls[0] == (mode == "forced" and pure)


def test_block_multihead_attention_int8_tracks_fp():
    """int8 caches (static and dynamic per-row scales from the rows'
    amax) track the fp-cache output within quantization error."""
    args, kw = _blha_case("prefill")
    t = [ptt.to_tensor(a, place="cpu") for a in args]
    ref = TF.block_multihead_attention(*t, **kw)[0].numpy()
    q3 = args[0].reshape(-1, 3, NH, HD)
    for dynamic in (False, True):
        if dynamic:
            amax = np.stack([np.abs(q3[:6, 1:]).max(axis=(0, 1, 3)),
                             np.abs(q3[6:, 1:]).max(axis=(0, 1, 3))])
            scales = (127.0 / amax).astype(np.float32)
        else:
            scales = np.full((NH,), 127.0 / np.abs(args[0]).max(),
                             np.float32)
        z = np.zeros(args[1].shape, np.int8)
        out, _, kc, _ = TF.block_multihead_attention(
            *(ptt.to_tensor(a, place="cpu") for a in
              (args[0], z, z, *args[3:])), **kw,
            cache_k_quant_scales=scales, cache_v_quant_scales=scales,
            use_dynamic_cachekv_quant=dynamic)
        assert kc.dtype == torch.int8 and np.abs(kc.numpy()).max() > 0
        np.testing.assert_allclose(out.numpy(), ref, atol=0.05, rtol=0.05)


def test_block_multihead_attention_raises_on_unpaired_inputs():
    args, kw = _blha_case("prefill")
    t = [ptt.to_tensor(a, place="cpu") for a in args]
    with pytest.raises(ValueError, match="together"):
        TF.block_multihead_attention(
            *t, **kw, cache_k_quant_scales=np.ones(NH, np.float32))
    with pytest.raises(ValueError, match="together"):
        TF.block_multihead_attention(
            *t, **kw, pre_key_cache=np.zeros((2, NH, 3, HD), np.float32))
    with pytest.raises(ValueError, match=r"\[B, num_head\]"):
        TF.block_multihead_attention(
            *t, **kw, cache_k_quant_scales=np.ones(NH, np.float32),
            cache_v_quant_scales=np.ones(NH, np.float32),
            use_dynamic_cachekv_quant=True)


# ---------------- the slice: the Paddle fused-op decoder ----------------
def _jax_decoder(jp, cfg, prompt, new, cos, sin, bs, kv_int8, seed=0):
    """``chip_smoke.paddle_decoder`` written on the JAX package: the same
    ops in the same order, ``jnp`` projections, the caches carried as
    the JAX op returns them. Returns (logits (new, B, V), tokens (B,
    new))."""
    B, S = prompt.shape
    L, nh, hd, eps = cfg.num_layers, cfg.num_heads, cfg.hd, cfg.rms_eps
    lay = jp["layers"]
    wqkv = [jnp.concatenate([lay[n][l] for n in ("wq", "wk", "wv")], -1)
            for l in range(L)]
    head = jp["embed"].T if cfg.tie_embeddings else jp["lm_head"]
    pps = -(-(S + new) // bs)
    bt = np.random.default_rng(seed).permutation(B * pps).reshape(
        B, pps).astype(np.int32)
    dt = jnp.int8 if kv_int8 else cfg.dtype
    kc = [jnp.zeros((B * pps, nh, bs, hd), dt) for _ in range(L)]
    vc = [jnp.zeros((B * pps, nh, bs, hd), dt) for _ in range(L)]
    quant = [dict() for _ in range(L)]

    def scales(t):
        a = jnp.max(jnp.abs(t.astype(jnp.float32)), axis=(1, 3))
        return 127.0 / jnp.maximum(a, 1e-6)

    def forward(x, T, enc, dec, c, s):
        this = np.full((B,), T, np.int32)
        mlp = None
        for l in range(L):
            if mlp is None:
                h1 = JF.fused_rms_norm(x, norm_weight=lay["attn_norm"][l],
                                       epsilon=eps)._value
            else:
                h1, x = (t._value for t in JF.fused_rms_norm(
                    mlp, norm_weight=lay["attn_norm"][l], epsilon=eps,
                    residual=x))
            qkv = (h1 @ wqkv[l]).reshape(B, T, 3, nh, hd)
            rq, rk, _ = JF.fused_rotary_position_embedding(
                qkv[:, :, 0], qkv[:, :, 1], sin=s, cos=c)
            rq, rk = rq._value, rk._value
            if kv_int8 and T > 1:
                quant[l] = dict(cache_k_quant_scales=scales(rk),
                                cache_v_quant_scales=scales(qkv[:, :, 2]),
                                use_dynamic_cachekv_quant=True)
            qkv = jnp.stack([rq, rk, qkv[:, :, 2]], axis=2).reshape(
                B * T, 3 * nh * hd)
            o, _, kc[l], vc[l] = JF.block_multihead_attention(
                qkv, kc[l], vc[l], enc, dec, this, block_tables=bt,
                block_size=bs, **quant[l])
            kc[l], vc[l] = kc[l]._value, vc[l]._value
            h2, x = (t._value for t in JF.fused_rms_norm(
                o._value @ lay["wo"][l], norm_weight=lay["mlp_norm"][l],
                epsilon=eps, residual=x))
            act = JF.swiglu(h2 @ lay["wg"][l], h2 @ lay["wu"][l])._value
            mlp = act @ lay["wd"][l]
        h = JF.fused_rms_norm(mlp, norm_weight=jp["final_norm"],
                              epsilon=eps, residual=x)[0]._value
        return (h.reshape(B, T, -1)[:, -1] @ head).astype(jnp.float32)

    zeros = np.zeros((B,), np.int32)
    logits = [forward(jp["embed"][prompt].reshape(B * S, -1), S,
                      np.full((B,), S, np.int32), zeros, cos[:S], sin[:S])]
    toks = [jnp.argmax(logits[-1], -1)]
    for i in range(new - 1):
        p = S + i
        logits.append(forward(jp["embed"][toks[-1]], 1, zeros,
                              np.full((B,), p, np.int32), cos[p:p + 1],
                              sin[p:p + 1]))
        toks.append(jnp.argmax(logits[-1], -1))
    return np.stack(logits), np.stack(toks, axis=1)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["kv-f32", "kv-int8"])
def test_paddle_decoder_matches_jax(monkeypatch, kv_int8):
    """``chip_smoke.paddle_decoder`` on the port against the same decoder
    on the JAX package, the fused paths forced on both sides (B4a, B5a,
    B6 and B8 through their plain versions here, the kernels on the
    card): identical greedy tokens, logits within 1e-4, and the plain
    versions called as often as phase 3d counts launches per decode
    step (B6 2L, B8 L, B4a 2L + 1, B5a L), the prefill included for all
    but B8."""
    monkeypatch.setenv("PADDLE_TPU_FORCE_PALLAS_FUSED", "1")
    calls = {n: _spy(monkeypatch, n) for n in (
        "rope_plain", "paged_decode_attention_plain", "rms_norm_fwd_plain",
        "swiglu_fwd_plain")}
    kw = dict(num_layers=2, num_heads=4, num_kv_heads=4, hidden_size=64,
              vocab_size=128)
    jcfg, tcfg = jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    B, S, new, bs = 3, 12, 6, 8
    prompt = np.random.default_rng(1).integers(3, 128, (B, S)).astype(
        np.int32)
    inv = 1.0 / 10000.0 ** (np.arange(0, jcfg.hd, 2) / jcfg.hd)
    fr = np.outer(np.arange(S + new), inv)
    cos, sin = np.cos(fr).astype(np.float32), np.sin(fr).astype(np.float32)
    jfa.set_interpret(True)
    try:
        jlog, jtok = _jax_decoder(jp, jcfg, jnp.asarray(prompt), new,
                                  jnp.asarray(cos), jnp.asarray(sin), bs,
                                  kv_int8)
    finally:
        jfa.set_interpret(False)
    kernels.reset_launch_counts()
    outs = list(chip_smoke.paddle_decoder(
        torch, np, TF, tp, tcfg, torch.from_numpy(prompt), new,
        torch.from_numpy(cos), torch.from_numpy(sin), block_size=bs,
        kv_int8=kv_int8))
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)
    tlog = torch.stack([o[0] for o in outs]).numpy()
    ttok = torch.stack([o[1] for o in outs], dim=1).numpy()
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_allclose(tlog, jlog, atol=1e-4, rtol=0)
    L, steps = tcfg.num_layers, new - 1
    assert {n: c[0] for n, c in calls.items()} == {
        "rope_plain": 2 * L * new, "paged_decode_attention_plain": L * steps,
        "rms_norm_fwd_plain": (2 * L + 1) * new,
        "swiglu_fwd_plain": L * new}
