"""The port's ``nn.functional`` attention functionals against
``paddle_tpu.nn.functional``'s, on the CPU.

Every name of the module runs on both sides over the same seeded numpy
inputs (``Tensor``\\ s with ``stop_gradient=False``): the output, then
``.backward()`` of ``sum(out * w)`` for a seeded cotangent ``w`` and the
inputs' gradients. On the CPU both sides take the reference composition
(the JAX package's Pallas flash kernels are off outside a TPU without
interpret mode; the port's flash kernels run only for CUDA tensors).
Tolerances, float32: outputs atol 2e-5, gradients atol 2e-4 (the same
f32 math summed in other orders). Dropout: with ``seed(s)`` on both
sides the keep-mask is threefry bits on both, so a 0.1 dropout gives the
JAX package's output to the same limits, and another seed does not.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
import paddle_tpu_torch as ptt
from paddle_tpu_torch.nn import functional as TF

torch.set_num_threads(1)
ATOL, GTOL = 2e-5, 2e-4
B, S, H, D = 2, 16, 2, 8
NAMES = ("flash_attention", "scaled_dot_product_attention",
         "flash_attn_unpadded", "sdp_kernel", "flash_attn_qkvpacked",
         "flash_attn_varlen_qkvpacked", "flashmask_attention")


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run(fn_name, arrays, grad_of, kw_np=(), seed=None, first=True, **kw):
    """Run ``fn_name`` on both sides. ``arrays``: the tensor arguments
    (numpy), those at the indices ``grad_of`` with gradients; ``kw_np``:
    keyword arguments given as numpy arrays (made Tensors on each
    side); ``first``: the output is the first of a tuple. Returns
    (port out, jax out, port grads, jax grads)."""
    res = []
    for pkg, F, place in ((ptt, TF, "cpu"), (paddle, JF, None)):
        kwp = {} if place is None else {"place": place}
        ts = [pkg.to_tensor(a.copy(), stop_gradient=i not in grad_of, **kwp)
              for i, a in enumerate(arrays)]
        kws = dict(kw, **{k: pkg.to_tensor(v.copy(), **kwp)
                          for k, v in dict(kw_np).items()})
        if seed is not None:
            pkg.seed(seed)
        out = getattr(F, fn_name)(*ts, **kws)
        if first:
            out = out[0]
        w = pkg.to_tensor(_r(*out.shape, seed=99), **kwp)
        (out * w).sum().backward()
        res.append((out.numpy(), [np.asarray(ts[i].grad.numpy())
                                  for i in grad_of]))
    (po, pg), (jo, jg) = res
    np.testing.assert_allclose(po, jo, atol=ATOL, rtol=0)
    for a, b in zip(pg, jg):
        np.testing.assert_allclose(a, b, atol=GTOL, rtol=0)
    return po, jo


def test_every_name_is_ported():
    for n in NAMES:
        assert callable(getattr(TF, n)) and callable(getattr(JF, n)), n


@pytest.mark.parametrize("sq,causal,bias,drop", [
    (S, False, False, 0.0), (S, True, True, 0.0), (5, True, False, 0.0),
    (S, True, False, 0.2)])
def test_sdpa_xla_matches_jax(sq, causal, bias, drop):
    """``_sdpa_xla`` on raw arrays: Sq < Sk aligns the causal mask to the
    bottom right; dropout with the same threefry key on both sides."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.nn.functional import attention as JA
    from paddle_tpu_torch._core import random as prng
    from paddle_tpu_torch.nn.functional import attention as TA
    q = _r(B, sq, H, D, seed=1)
    k, v = _r(B, S, H, D, seed=2), _r(B, S, H, D, seed=3)
    b = _r(B, H, sq, S, seed=4) if bias else None
    want = JA._sdpa_xla(*(jnp.asarray(a) for a in (q, k, v)),
                        bias=None if b is None else jnp.asarray(b),
                        causal=causal, scale=0.5, dropout=drop,
                        dropout_key=jax.random.key(11))
    got = TA._sdpa_xla(*(torch.as_tensor(a) for a in (q, k, v)),
                       bias=None if b is None else torch.as_tensor(b),
                       causal=causal, scale=0.5, dropout=drop,
                       dropout_key=prng.key(11))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("backend", [None, "xla"])
def test_flash_attention(causal, backend):
    q, k, v = (_r(B, S, H, D, seed=i) for i in range(3))
    _run("flash_attention", [q, k, v], (0, 1, 2), causal=causal,
         backend=backend)
    out = TF.flash_attention(*(ptt.to_tensor(a, place="cpu")
                               for a in (q, k, v)), causal=causal)
    assert isinstance(out, tuple) and out[1] is None


@pytest.mark.parametrize("seed", [0, 7])
def test_flash_attention_dropout_draws_jax_keep_mask(seed):
    q, k, v = (_r(B, S, H, D, seed=i) for i in range(3))
    po, jo = _run("flash_attention", [q, k, v], (0, 1, 2), seed=seed,
                  dropout=0.1, causal=True)
    ptt.seed(seed + 1)
    other = TF.flash_attention(*(ptt.to_tensor(a, place="cpu")
                                 for a in (q, k, v)), dropout=0.1,
                               causal=True)[0].numpy()
    assert np.abs(other - jo).max() > 1e-3
    # training=False: no dropout on either side
    _run("flash_attention", [q, k, v], (0,), seed=seed, dropout=0.1,
         training=False)


@pytest.mark.parametrize("mask", [None, "bool", "float"])
@pytest.mark.parametrize("is_causal", [False, True])
def test_scaled_dot_product_attention(mask, is_causal):
    q, k, v = (_r(B, S, H, D, seed=i) for i in range(3))
    kw = {}
    if mask == "bool":
        m = np.random.RandomState(5).rand(B, 1, S, S) > 0.3
        m[..., 0] = True                       # no fully masked row
        kw["attn_mask"] = m
    elif mask == "float":
        kw["attn_mask"] = _r(B, H, S, S, seed=6)
    _run("scaled_dot_product_attention", [q, k, v], (0, 1, 2), kw_np=kw,
         first=False, is_causal=is_causal)


def test_scaled_dot_product_attention_dropout():
    q, k, v = (_r(B, S, H, D, seed=i) for i in range(3))
    _run("scaled_dot_product_attention", [q, k, v], (0, 1, 2), seed=3,
         first=False, dropout_p=0.1)


CU = np.array([0, 5, 12, 20], np.int32)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_unpadded(causal):
    q, k, v = (_r(20, H, D, seed=i) for i in range(3))
    _run("flash_attn_unpadded", [q, k, v, CU, CU], (0, 1, 2),
         max_seqlen_q=8, max_seqlen_k=8, scale=0.3, causal=causal)


def test_sdp_kernel_is_a_no_op_context():
    with TF.sdp_kernel(enable_flash=True) as ctx:
        assert ctx is not None


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_qkvpacked(causal):
    _run("flash_attn_qkvpacked", [_r(B, S, 3, H, D)], (0,), causal=causal)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_varlen_qkvpacked(causal):
    _run("flash_attn_varlen_qkvpacked", [_r(20, 3, H, D), CU, CU], (0,),
         max_seqlen_q=8, max_seqlen_k=8, scale=0.25, causal=causal)


@pytest.mark.parametrize("heads", [1, H])
@pytest.mark.parametrize("causal", [False, True])
def test_flashmask_attention(heads, causal):
    q, k, v = (_r(B, S, H, D, seed=i) for i in range(3))
    rs = np.random.RandomState(8)
    sri = rs.randint(1, S + 1, (B, heads, S, 1)).astype(np.int32)
    sri = np.maximum(sri, np.arange(S)[None, None, :, None] + 1)
    _run("flashmask_attention", [q, k, v], (0, 1, 2), first=False,
         kw_np={"startend_row_indices": sri}, causal=causal)
    po, _ = _run("flashmask_attention", [q, k, v], (0,), first=True,
                 kw_np={"startend_row_indices": sri}, causal=causal,
                 return_softmax_lse=True)
    out = TF.flashmask_attention(*(ptt.to_tensor(a, place="cpu")
                                   for a in (q, k, v)),
                                 startend_row_indices=ptt.to_tensor(
                                     sri, place="cpu"),
                                 return_seed_offset=True)
    assert len(out) == 3 and out[1] is None and out[2] is None


def test_flashmask_without_indices_is_flash_attention():
    q, k, v = (_r(B, S, H, D, seed=i) for i in range(3))
    _run("flashmask_attention", [q, k, v], (0, 1, 2), causal=True)


def test_cuda_tensors_would_take_the_flash_kernels(monkeypatch):
    """The switch: on CUDA tensors (faked here by the ``place`` the
    switch reads) with no dropout and ``backend != "xla"`` the op calls
    ``ops.kernels.flash_attention.flash_attention``; with dropout or
    ``backend="xla"`` it does not."""
    from paddle_tpu_torch.nn.functional import attention as A
    calls = []

    def fake(q, k, v, causal=False):
        calls.append(causal)
        return q * 1.0

    monkeypatch.setattr(A._fa, "flash_attention", fake)
    monkeypatch.setattr(type(ptt.to_tensor(np.zeros(1), place="cpu")),
                        "place", property(lambda self: torch.device(
                            "cuda", 0)))
    q, k, v = (ptt.to_tensor(_r(B, S, H, D, seed=i), place="cpu")
               for i in range(3))
    TF.flash_attention(q, k, v, causal=True)
    TF.flash_attention(q, k, v, causal=True, backend="xla")
    ptt.seed(0)
    TF.flash_attention(q, k, v, dropout=0.1)
    assert calls == [True]
