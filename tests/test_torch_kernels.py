"""The port's kernel functions against the JAX package's, on the CPU.

For B9 (ragged paged decode), B10 (fused RoPE paged decode) and B11
(flash chunk attention, linear; the tree form is in
``tests/test_torch_spec.py``), the same seeded numpy inputs go through
the JAX reference, the JAX Pallas kernel in interpret mode and the
port's plain PyTorch version: fp32 and int8 tiers, GQA rep = 2, mixed
lengths and -1 block-table entries. Tolerance rtol = atol = 2e-5: the
math is the same f32 composition, summed in another order. The port's
wrappers, given CPU tensors, take the plain versions and launch nothing.

B6 (fused RoPE, ``rope_qk`` with its VJP) and B8 (decode attention over
a head-major page pool) go against the JAX package's Pallas kernels in
interpret mode: RoPE with (S, D) and (S, D/2) tables and GQA, atol 1e-5
forward (the same f32 products, rounded once) and 2e-4 for the
gradients; B8 with GQA, -1 table entries, NaN in every slot past a
row's length and in page 0, a row of length 0, f32 and bfloat16 queries
and int8 pages with (HK,) and (B, HK) scales, atol 2e-5 in f32 and one
bfloat16 ulp (rtol 2^-7) where the output is bfloat16.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu.ops.pallas import fused as jfz
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.ops.pallas import serving_fused as jsf
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import fused as tfz
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import serving_fused as tsf

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _interpret(fn, *a, **k):
    fa.set_interpret(True)
    try:
        return np.asarray(fn(*a, **k))
    finally:
        fa.set_interpret(False)


def _decode_case(seed, quant):
    """B = 3 rows of lengths 5, 17, 1 over an 8-token-page pool; table
    entries past each row's live pages are -1."""
    rs = np.random.RandomState(seed)
    P, page, HK, D, B, pp, H = 10, 8, 2, 16, 3, 3, 4
    lens = np.asarray([5, 17, 1], np.int32)
    bt = np.stack([rs.choice(np.arange(1, P), pp, replace=False)
                   for _ in range(B)]).astype(np.int32)
    for b, n in enumerate(lens):
        bt[b, -(-n // page):] = -1
    x = dict(q=rs.randn(B, H, D).astype(np.float32), bt=bt, lens=lens)
    if quant:
        x["k"] = rs.randint(-127, 128, (P, page, HK, D)).astype(np.int8)
        x["v"] = rs.randint(-127, 128, (P, page, HK, D)).astype(np.int8)
        x["ks"] = (rs.rand(P, page, HK) * 0.05 + 0.01).astype(np.float32)
        x["vs"] = (rs.rand(P, page, HK) * 0.05 + 0.01).astype(np.float32)
    else:
        x["k"] = rs.randn(P, page, HK, D).astype(np.float32)
        x["v"] = rs.randn(P, page, HK, D).astype(np.float32)
        x["ks"] = x["vs"] = None
    cos = np.cos(np.outer(lens - 1, 1.0 / 10000 ** (np.arange(0, D, 2) / D)))
    sin = np.sin(np.outer(lens - 1, 1.0 / 10000 ** (np.arange(0, D, 2) / D)))
    x["cos"], x["sin"] = cos.astype(np.float32), sin.astype(np.float32)
    return x


def _j(a):
    return None if a is None else jnp.asarray(a)


def _tt(a):
    return None if a is None else _t(a)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_b9_paged_decode_matches_jax(quant):
    x = _decode_case(0, quant)
    jargs = (jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
             jnp.asarray(x["bt"]), jnp.asarray(x["lens"]))
    jkw = dict(ks_pages=_j(x["ks"]), vs_pages=_j(x["vs"]))
    ref = np.asarray(jpa.paged_attention_reference(*jargs, **jkw))
    ker = _interpret(jpa.paged_attention_kernel, *jargs, **jkw)
    targs = (_t(x["q"]), _t(x["k"]), _t(x["v"]), _t(x["bt"]), _t(x["lens"]))
    tkw = dict(ks_pages=_tt(x["ks"]), vs_pages=_tt(x["vs"]))
    kernels.reset_launch_counts()
    plain = tpa.paged_attention_plain(*targs, **tkw).numpy()
    wrapped = tpa.paged_attention(*targs, **tkw).numpy()
    np.testing.assert_allclose(plain, ref, **TOL)
    np.testing.assert_allclose(plain, ker, **TOL)
    np.testing.assert_array_equal(wrapped, plain)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_b10_fused_paged_decode_matches_jax(quant):
    x = _decode_case(1, quant)
    jargs = (jnp.asarray(x["q"]), jnp.asarray(x["cos"]),
             jnp.asarray(x["sin"]), jnp.asarray(x["k"]),
             jnp.asarray(x["v"]), jnp.asarray(x["bt"]),
             jnp.asarray(x["lens"]))
    jkw = dict(ks_pages=_j(x["ks"]), vs_pages=_j(x["vs"]))
    ref = np.asarray(jsf.fused_paged_decode_reference(*jargs, **jkw))
    ker = _interpret(jsf.fused_paged_decode_kernel, *jargs, **jkw)
    targs = (_t(x["q"]), _t(x["cos"]), _t(x["sin"]), _t(x["k"]),
             _t(x["v"]), _t(x["bt"]), _t(x["lens"]))
    tkw = dict(ks_pages=_tt(x["ks"]), vs_pages=_tt(x["vs"]))
    kernels.reset_launch_counts()
    plain = tsf.fused_paged_decode_plain(*targs, **tkw).numpy()
    wrapped = tsf.fused_paged_decode_attention(*targs, **tkw).numpy()
    np.testing.assert_allclose(plain, ref, **TOL)
    np.testing.assert_allclose(plain, ker, **TOL)
    np.testing.assert_array_equal(wrapped, plain)
    # the rotation alone is the model's rope at T=1, bit for bit
    np.testing.assert_array_equal(
        tsf.rotate_q_plain(_t(x["q"]), _t(x["cos"]), _t(x["sin"])).numpy(),
        np.asarray(jsf.rotate_q_reference(*jargs[:3])))
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


def _chunk_case(seed, quant):
    """B = 2 rows, T = 8 chunk queries against a W = 24 temp cache whose
    valid columns start at kstart = (3, 0)."""
    rs = np.random.RandomState(seed)
    B, T, H, HK, D, W = 2, 8, 4, 2, 16, 24
    x = dict(q=rs.randn(B, T, H, D).astype(np.float32), W=W,
             kstart=np.asarray([3, 0], np.int32))
    if quant:
        x["ck"] = rs.randint(-127, 128, (B, W, HK, D)).astype(np.int8)
        x["cv"] = rs.randint(-127, 128, (B, W, HK, D)).astype(np.int8)
        x["kr"] = (rs.rand(B, W, HK) * 0.05 + 0.01).astype(np.float32)
        x["vr"] = (rs.rand(B, W, HK) * 0.05 + 0.01).astype(np.float32)
    else:
        x["ck"] = rs.randn(B, W, HK, D).astype(np.float32)
        x["cv"] = rs.randn(B, W, HK, D).astype(np.float32)
        x["kr"] = x["vr"] = None
    return x


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_b11_flash_chunk_matches_jax(quant):
    x = _chunk_case(2, quant)
    jargs = (jnp.asarray(x["q"]), jnp.asarray(x["ck"]),
             jnp.asarray(x["cv"]), x["W"], jnp.asarray(x["kstart"]))
    jkw = dict(k_rows=_j(x["kr"]), v_rows=_j(x["vr"]))
    ref = np.asarray(jsf.flash_chunk_attention_reference(*jargs, **jkw))
    ker = _interpret(jsf.flash_chunk_attention_kernel, *jargs,
                     block_k=8, **jkw)
    targs = (_t(x["q"]), _t(x["ck"]), _t(x["cv"]), x["W"],
             _t(x["kstart"]))
    tkw = dict(k_rows=_tt(x["kr"]), v_rows=_tt(x["vr"]))
    kernels.reset_launch_counts()
    plain = tsf.flash_chunk_attention_plain(*targs, **tkw).numpy()
    wrapped = tsf.flash_chunk_attention(*targs, **tkw).numpy()
    np.testing.assert_allclose(plain, ref, **TOL)
    np.testing.assert_allclose(plain, ker, **TOL)
    np.testing.assert_array_equal(wrapped, plain)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


def test_tree_mask_and_unpaired_scales_raise():
    x = _chunk_case(3, False)
    args = (_t(x["q"]), _t(x["ck"]), _t(x["cv"]), x["W"], _t(x["kstart"]))
    with pytest.raises(ValueError, match="tree_mask must be"):
        tsf.flash_chunk_attention(*args,
                                  tree_mask=torch.ones(2, 8, 7, dtype=bool))
    d = _decode_case(4, True)
    with pytest.raises(ValueError, match="together"):
        tpa.paged_attention(_t(d["q"]), _t(d["k"]), _t(d["v"]), _t(d["bt"]),
                            _t(d["lens"]), ks_pages=_t(d["ks"]))


def test_gather_pages_matches_jax():
    x = _decode_case(5, False)
    got = tpa.gather_pages(_t(x["k"]), _t(x["bt"])).numpy()
    want = np.asarray(jpa.gather_pages(jnp.asarray(x["k"]),
                                       jnp.asarray(x["bt"])))
    np.testing.assert_array_equal(got, want)


def _rope_tables(S, D):
    inv = 1.0 / 10000.0 ** (np.arange(0, D, 2) / D)
    fr = np.outer(np.arange(S), inv)
    return np.cos(fr).astype(np.float32), np.sin(fr).astype(np.float32)


@pytest.mark.parametrize("table", ["half", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b6_rope_qk_matches_jax(dtype, table):
    """``rope_qk`` on q (B, S, H, D) and k (B, S, HK, D), GQA, and its
    VJP (the rotation by -theta), against the Pallas kernel's custom VJP
    in interpret mode; the tables given as (S, D/2) or as repeated-half
    (S, D). bfloat16: the same f32 result rounded once on both sides, so
    within one ulp (rtol 2^-7, atol 1e-6)."""
    B, S, H, HK, D = 2, 48, 4, 2, 32
    rs = np.random.RandomState(6)
    q, k, gq, gk = (rs.randn(B, S, h, D).astype(np.float32)
                    for h in (H, HK, H, HK))
    cos, sin = _rope_tables(S, D)
    if table == "full":
        cos, sin = np.tile(cos, (1, 2)), np.tile(sin, (1, 2))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = (dict(atol=1e-5, rtol=0) if dtype == "float32"
           else dict(atol=1e-6, rtol=2.0 ** -7))
    fa.set_interpret(True)
    try:
        (jq, jk), vjp = jax.vjp(
            lambda a, b: jfz.rope_qk(a, b, jnp.asarray(cos),
                                     jnp.asarray(sin), block_seq=16),
            jnp.asarray(q).astype(jd), jnp.asarray(k).astype(jd))
        jgq, jgk = vjp(tuple(jnp.asarray(g).astype(jd) for g in (gq, gk)))
    finally:
        fa.set_interpret(False)
    tq, tk = (_t(a).to(td).requires_grad_() for a in (q, k))
    kernels.reset_launch_counts()
    oq, ok = tfz.rope_qk(tq, tk, _t(cos), _t(sin))
    torch.autograd.backward((oq, ok), (_t(gq).to(td), _t(gk).to(td)))
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)
    for got, want in ((oq, jq), (ok, jk)):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol)
    gtol = tol if dtype == "bfloat16" else dict(atol=2e-4, rtol=0)
    for got, want in ((tq.grad, jgq), (tk.grad, jgk)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **gtol)


B8_CASES = {"f32-mha": ("float32", 2, None), "f32-gqa": ("float32", 4, None),
            "bf16-gqa": ("bfloat16", 4, None),
            "int8-hk-scales": ("float32", 4, "hk"),
            "int8-bhk-scales": ("float32", 2, "bhk")}


@pytest.mark.parametrize("case", list(B8_CASES))
def test_b8_paged_decode_matches_jax(case):
    """``paged_decode_attention`` over a head-major (P, HK, page, D) pool
    against the Pallas kernel in interpret mode: rows of lengths 6, 21,
    0 and 1 (the empty row gives zeros on both sides), block-table
    entries past each row's pages -1 (read as page 0), and in float pools
    NaN in page 0 and in every slot past a row's length, which neither
    side may let reach the output."""
    dtype, H, scales = B8_CASES[case]
    rs = np.random.RandomState(7)
    B, HK, D, page, pps = 4, 2, 16, 8, 3
    P = 1 + B * pps
    lens = np.asarray([6, 21, 0, 1], np.int32)
    bt = (rs.permutation(P - 1) + 1).reshape(B, pps).astype(np.int32)
    for b, n in enumerate(lens):
        bt[b, -(-n // page):] = -1
    q = rs.randn(B, H, D).astype(np.float32)
    kw = {}
    if scales is None:
        kp, vp = (rs.randn(P, HK, page, D).astype(np.float32)
                  for _ in range(2))
        for b, n in enumerate(lens):
            for j in range(n, pps * page):
                if bt[b, j // page] >= 0:
                    kp[bt[b, j // page], :, j % page] = np.nan
                    vp[bt[b, j // page], :, j % page] = np.nan
        kp[0] = vp[0] = np.nan
    else:
        kp, vp = (rs.randint(-127, 128, (P, HK, page, D)).astype(np.int8)
                  for _ in range(2))
        shape = (HK,) if scales == "hk" else (B, HK)
        kw = dict(k_dequant_scale=(rs.rand(*shape) * 0.05 + 0.01).astype(
            np.float32), v_dequant_scale=(rs.rand(*shape) * 0.05
                                          + 0.01).astype(np.float32))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jkv = [jnp.asarray(a) if scales else jnp.asarray(a).astype(jd)
           for a in (kp, vp)]
    tkv = [_t(a) if scales else _t(a).to(td) for a in (kp, vp)]
    fa.set_interpret(True)
    try:
        want = np.asarray(jfz.paged_decode_attention(
            jnp.asarray(q).astype(jd), *jkv, jnp.asarray(bt),
            jnp.asarray(lens), **{k: jnp.asarray(v) for k, v in kw.items()}
        ).astype(jnp.float32))
    finally:
        fa.set_interpret(False)
    kernels.reset_launch_counts()
    got = tfz.paged_decode_attention(
        _t(q).to(td), *tkv, _t(bt), _t(lens),
        **{k: _t(v) for k, v in kw.items()}).float().numpy()
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)
    assert np.isfinite(got).all() and not got[2].any()
    tol = (dict(rtol=2.0 ** -7, atol=1e-6) if dtype == "bfloat16"
           else dict(rtol=0, atol=2e-5))
    np.testing.assert_allclose(got, want, **tol)
