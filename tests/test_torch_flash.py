"""The port's flash attention (B1-B3) against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX ``flash_attention`` (its
Pallas kernels in interpret mode, 128-row blocks, so the sequences below
leave ragged last blocks) and through the port: the plain forward
``flash_attention_plain`` with autograd through it, the public
``flash_attention`` (whose ``autograd.Function`` runs each kernel's plain
version on CPU tensors), and the plain B2/B3 against the JAX backward
kernels on the JAX forward's residuals. Causal and full, GQA, and
Sq != Sk (the causal mask is top-left aligned). Tolerances, float32:
forward and lse 2e-5, gradients 1e-4 (the same f32 math summed in
another order; the gradients sum over up to 320 products of O(1)).
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

torch.set_num_threads(1)
FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _interpret():
    jfa.set_interpret(True)
    yield
    jfa.set_interpret(False)


def _case(seed, sq, sk, h, hk, d=64):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for shape in
            ((1, sq, h, d), (1, sk, hk, d), (1, sk, hk, d), (1, sq, h, d))]


CASES = [  # causal, sq, sk, H, HK
    (False, 160, 160, 2, 2),
    (True, 160, 160, 2, 2),
    (True, 192, 320, 4, 2),
    (True, 320, 192, 2, 1),
    (False, 128, 192, 4, 2),
]


def _id(c):
    return (f"{'causal' if c[0] else 'full'}-sq{c[1]}-sk{c[2]}-"
            f"rep{c[3] // c[4]}")


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_flash_attention_matches_jax(case):
    causal, sq, sk, h, hk = case
    q, k, v, do = _case(sum(case[1:]), sq, sk, h, hk)
    kw = dict(causal=causal, block_q=128, block_k=128)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, **kw) * jnp.asarray(do))

    jout = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)),
                                          **kw))
    jgrads = [np.asarray(g) for g in jax.grad(jloss, (0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))]

    kernels.reset_launch_counts()
    # the public op: autograd.Function over the kernels' plain versions
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), jout, **FWD)
    for t, g in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), g, **GRAD)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)

    # autograd through the plain forward (kv heads repeated first)
    pq, pk, pv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    rk = torch.repeat_interleave(pk, h // hk, dim=2)
    rv = torch.repeat_interleave(pv, h // hk, dim=2)
    pout, _ = tfa.flash_attention_plain(pq, rk, rv, causal=causal)
    pout.backward(torch.from_numpy(do))
    np.testing.assert_allclose(pout.detach().numpy(), jout, **FWD)
    for t, g in zip((pq, pk, pv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), g, **GRAD)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_each_kernel_plain_matches_its_pallas_kernel(causal):
    """B1's plain (O, lse) against ``_fwd``, then plain B2 and B3 against
    ``_bwd`` on the JAX forward's own residuals (O and lse), on the
    (B*H, S, D) layout the Pallas kernels take."""
    sq, sk, h, d = 192, 160, 2, 64
    q, k, v, do = _case(7, sq, sk, h, h, d)
    scale = 1.0 / math.sqrt(d)

    def bhsd(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(h, -1, d))

    res_q, res_k, res_v = bhsd(q), bhsd(k), bhsd(v)
    jout, jlse = jfa._fwd(res_q, res_k, res_v, scale, causal, 128, 128)
    jdq, jdk, jdv = jfa._bwd(scale, causal, 128, 128, None, None,
                             (res_q, res_k, res_v, jout, jlse), bhsd(do))

    def back(a, s):  # (H, S, D) -> (1, S, H, D)
        return np.asarray(a).reshape(1, h, s, d).transpose(0, 2, 1, 3)

    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    out, lse = tfa.flash_attention_plain(*t[:3], causal=causal, scale=scale)
    np.testing.assert_allclose(out.numpy(), back(jout, sq), **FWD)
    np.testing.assert_allclose(lse.numpy()[0], np.asarray(jlse)[..., 0],
                               **FWD)
    # the backward kernels on the JAX forward's O and lse
    jo = torch.from_numpy(back(jout, sq).copy())
    lse = torch.from_numpy(np.asarray(jlse)[None, ..., 0].copy())
    delta = (jo * t[3]).sum(-1).transpose(1, 2).contiguous()
    dk, dv = tfa.flash_bwd_dkv_plain(*t, lse, delta, causal, scale)
    dq = tfa.flash_bwd_dq_plain(*t, lse, delta, causal, scale)
    np.testing.assert_allclose(dq.numpy(), back(jdq, sq), **GRAD)
    np.testing.assert_allclose(dk.numpy(), back(jdk, sk), **GRAD)
    np.testing.assert_allclose(dv.numpy(), back(jdv, sk), **GRAD)


def test_kernel_launchers_refuse_cpu_tensors_and_odd_heads():
    q = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tfa._check("flash_fwd", q, q, q)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(torch.zeros((1, 8, 3, 64)), q, q)
