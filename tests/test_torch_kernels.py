"""The port's kernel functions against the JAX package's, on the CPU.

For B9 (ragged paged decode), B10 (fused RoPE paged decode) and B11
(flash chunk attention, linear; the tree form is in
``tests/test_torch_spec.py``), the same seeded numpy inputs go through
the JAX reference, the JAX Pallas kernel in interpret mode and the
port's plain PyTorch version: fp32 and int8 tiers, GQA rep = 2, mixed
lengths and -1 block-table entries. Tolerance rtol = atol = 2e-5: the
math is the same f32 composition, summed in another order. The port's
wrappers, given CPU tensors, take the plain versions and launch nothing.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.ops.pallas import serving_fused as jsf
from paddle_tpu_torch.ops import kernels
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
