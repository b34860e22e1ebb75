"""A CPU model of the numerics of the Hopper flash kernels (B1, B2, B3)
against the JAX package's flash attention, on the CPU.

``csrc/flash_attention.cu`` computes, for bf16 on an H100, what the
emulation below computes step by step: B1 walks 128-key tiles with an
online softmax in exp2 (``scale * log2(e)`` folded into one multiply-add,
the running max kept in raw ``q.k`` units), rounds p to the value dtype
before ``p @ v`` while l sums it unrounded, rounds ``O = acc * (1 / l)``
once, and returns ``lse = m * scale + log(l)`` in natural-log units; B3
walks 64-key tiles with ``p = 2^(s * c - lse * log2(e))`` and rounds
``ds = p * (dp - delta) * scale`` to the key dtype before ``ds @ k``. B2
is key-stationary: a CTA holds 64 keys and streams 64-row query tiles
from the first one that reaches its keys (under the causal mask) to the
end, computes the transposed scores ``k . q^T`` and ``v . dO^T`` with
the same p and ds, rounds p to dO's dtype and ds to q's before ``p^T
dO`` and ``ds^T q``, masks queries past Sq (zero-filled, lse 0: p would
be 1) and above the diagonal only on the tiles that cross them, and
writes zeros for keys that no query sees. The kernels cannot
run here; this model settles that those choices compute what the TPU
kernels compute.

The same seeded numpy inputs go through the JAX ``_fwd`` (O, lse) and
``_bwd`` (dQ, dK, dV, on the JAX forward's own O and lse) in interpret
mode, 128 blocks, as ``tests/test_torch_flash.py`` runs them, and
through the model. Lengths that are not multiples of a tile, Sq != Sk
both ways (Sq = 45 against Sk = 300: under the causal mask four of the
five key tiles see no query), causal (top-left aligned) and full.
Tolerances: float32, O 2e-5, lse 1e-5 and dQ, dK, dV 1e-4 (the same f32
math summed in another order; the gradients sum up to 320 products of
O(1), as ``test_torch_flash.py`` holds gradients); bfloat16 inputs,
``chip_smoke.py``'s row rule (every D-vector within ``ROW_RTOL * |its
row| + ROW_FLOOR * rms``) for O and the gradients, lse 1e-5.
"""
import math
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the row rule and its limits)

torch.set_num_threads(1)
LOG2E = 1.4426950408889634
F32 = dict(o=2e-5, dq=1e-4, dkv=1e-4)
LSE_ATOL = 1e-5


def _visible(sq, sk, c0, c1, causal):
    """(Sq, c1 - c0) bool: query row t sees key c (c < Sk, and c <= t
    under the causal mask)."""
    rows = torch.arange(sq)[:, None]
    cols = torch.arange(c0, c1)[None, :]
    ok = cols < sk
    return ok & (cols <= rows) if causal else ok.expand(sq, -1)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def model_fwd(q, k, v, causal, scale, block=128):
    """B1 on one head: q (Sq, D), k, v (Sk, D) in the model dtype ->
    O (Sq, D) in that dtype, lse (Sq,) f32."""
    sq, sk = q.shape[0], k.shape[0]
    c = _f32(scale) * _f32(LOG2E)
    m = torch.full((sq, 1), -math.inf)
    l = torch.zeros((sq, 1))
    acc = torch.zeros((sq, q.shape[1]))
    c_end = min(sk, sq) if causal else sk  # no row sees a key past this
    for c0 in range(0, c_end, block):
        # rows past Sk arrive as zeros (TMA's fill) and are masked
        kt = torch.zeros((block, k.shape[1]), dtype=k.dtype)
        vt = torch.zeros_like(kt)
        kt[:min(block, sk - c0)] = k[c0:c0 + block]
        vt[:min(block, sk - c0)] = v[c0:c0 + block]
        s = q.float() @ kt.float().T
        s = torch.where(_visible(sq, sk, c0, c0 + block, causal), s,
                        -math.inf)
        mn = torch.maximum(m, s.amax(dim=1, keepdim=True))
        mc = torch.where(mn == -math.inf, 0.0, mn * c)
        alpha = torch.exp2(m * c - mc)
        p = torch.exp2(s * c - mc)
        l = l * alpha + p.sum(dim=1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vt.float()
        m = mn
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    lse = torch.where(l > 0, m * _f32(scale) + torch.log(l), -math.inf)
    return (acc * inv).to(q.dtype), lse[:, 0]


def model_dq(q, k, v, do, lse, delta, causal, scale, block=64):
    """B3 on one head: dQ (Sq, D) in q's dtype from lse, delta (Sq,)."""
    sq, sk = q.shape[0], k.shape[0]
    c = _f32(scale) * _f32(LOG2E)
    lse2 = (lse * _f32(LOG2E))[:, None]
    dq = torch.zeros((sq, q.shape[1]))
    c_end = min(sk, sq) if causal else sk
    for c0 in range(0, c_end, block):
        kt = torch.zeros((block, k.shape[1]), dtype=k.dtype)
        vt = torch.zeros_like(kt)
        kt[:min(block, sk - c0)] = k[c0:c0 + block]
        vt[:min(block, sk - c0)] = v[c0:c0 + block]
        s = q.float() @ kt.float().T
        dp = do.float() @ vt.float().T
        p = torch.where(_visible(sq, sk, c0, c0 + block, causal),
                        torch.exp2(s * c - lse2), 0.0)
        ds = p * (dp - delta[:, None]) * _f32(scale)
        dq = dq + ds.to(k.dtype).float() @ kt.float()
    return dq.to(q.dtype)


def model_dkv(q, k, v, do, lse, delta, causal, scale, keys=64, block=64):
    """B2 on one head: dK, dV (Sk, D) in k's and v's dtypes from lse,
    delta (Sq,). A CTA holds ``keys`` keys and streams ``block``-row
    query tiles."""
    sq, sk, d = q.shape[0], k.shape[0], q.shape[1]
    c = _f32(scale) * _f32(LOG2E)
    dk = torch.zeros((sk, d))
    dv = torch.zeros((sk, d))
    for k0 in range(0, sk, keys):
        kt = torch.zeros((keys, d), dtype=k.dtype)
        vt = torch.zeros_like(kt)
        m = min(keys, sk - k0)
        kt[:m], vt[:m] = k[k0:k0 + m], v[k0:k0 + m]
        rows = torch.arange(k0, k0 + keys)[:, None]
        dkc = torch.zeros((keys, d))
        dvc = torch.zeros((keys, d))
        # no query before k0 sees these keys under the causal mask
        for q0 in range(k0 if causal else 0, sq, block):
            # rows past Sq arrive as zeros, with lse and delta 0
            qt = torch.zeros((block, d), dtype=q.dtype)
            ot = torch.zeros_like(qt)
            n = min(block, sq - q0)
            qt[:n], ot[:n] = q[q0:q0 + n], do[q0:q0 + n]
            lse2 = torch.zeros(block)
            dl = torch.zeros(block)
            lse2[:n] = lse[q0:q0 + n] * _f32(LOG2E)
            dl[:n] = delta[q0:q0 + n]
            st = kt.float() @ qt.float().T        # (keys, queries)
            dpt = vt.float() @ ot.float().T
            p = torch.exp2(st * c - lse2[None, :])
            if q0 + block > sq or (causal and q0 < k0 + keys - 1):
                cols = torch.arange(q0, q0 + block)[None, :]
                hide = cols >= sq
                if causal:
                    hide = hide | (cols < rows)
                p = torch.where(hide, 0.0, p)
            ds = p * (dpt - dl[None, :]) * _f32(scale)
            dvc = dvc + p.to(do.dtype).float() @ ot.float()
            dkc = dkc + ds.to(q.dtype).float() @ qt.float()
        dk[k0:k0 + m], dv[k0:k0 + m] = dkc[:m], dvc[:m]
    return dk.to(k.dtype), dv.to(v.dtype)


def _jax_reference(q, k, v, do, causal, scale, jdt):
    """JAX ``_fwd`` and ``_bwd`` (interpret mode, 128 blocks) on
    (1, S, H, D) numpy inputs -> O, dQ (1, Sq, H, D), dK, dV (1, Sk, H,
    D) f32 numpy and lse (H, Sq), delta (H, Sq)."""
    _, sq, h, d = q.shape
    sk = k.shape[1]

    def bhsd(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(h, -1, d), jdt)

    @jax.jit
    def run(q, k, v, do):
        out, lse = jfa._fwd(q, k, v, scale, causal, 128, 128)
        dq, dk, dv = jfa._bwd(scale, causal, 128, 128, None, None,
                              (q, k, v, out, lse), do)
        delta = jnp.sum(out.astype(jnp.float32) * do.astype(jnp.float32),
                        axis=-1)
        return out, lse, dq, dk, dv, delta

    out, lse, dq, dk, dv, delta = run(bhsd(q), bhsd(k), bhsd(v), bhsd(do))

    def back(a, s):  # (H, S, D) -> (1, S, H, D)
        return np.asarray(a.astype(jnp.float32)).reshape(
            1, h, s, d).transpose(0, 2, 1, 3)

    return (back(out, sq), np.array(lse)[..., 0], back(dq, sq),
            back(dk, sk), back(dv, sk), np.array(delta))


CASES = [(sq, sk, causal)
         for sq, sk in ((200, 200), (72, 136), (320, 192), (45, 300))
         for causal in (True, False)]


@pytest.fixture(autouse=True)
def _interpret():
    jfa.set_interpret(True)
    yield
    jfa.set_interpret(False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[
    f"sq{c[0]}-sk{c[1]}-{'causal' if c[2] else 'full'}" for c in CASES])
def test_hopper_tiling_model_matches_jax(case, dtype):
    sq, sk, causal = case
    h, d = 1, 64
    scale = 1.0 / math.sqrt(d)
    rs = np.random.RandomState(sq + 7 * sk + causal)
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(rs.randn(1, s, h, d).astype(np.float32))
                   .to(tdt) for s in (sq, sk, sk, sq))
    jo, jlse, jdq, jdk, jdv, jdelta = _jax_reference(
        *(t.float().numpy() for t in (q, k, v, do)), causal, scale,
        getattr(jnp, dtype))
    # the model per head, on the JAX forward's lse and delta for B3
    fwd = [model_fwd(q[0, :, i], k[0, :, i], v[0, :, i], causal, scale)
           for i in range(h)]
    o = torch.stack([f[0] for f in fwd], dim=1)[None]
    lse = torch.stack([f[1] for f in fwd])
    dq = torch.stack([model_dq(q[0, :, i], k[0, :, i], v[0, :, i],
                               do[0, :, i], torch.from_numpy(jlse[i]),
                               torch.from_numpy(jdelta[i]), causal, scale)
                      for i in range(h)], dim=1)[None]
    dkv = [model_dkv(q[0, :, i], k[0, :, i], v[0, :, i], do[0, :, i],
                     torch.from_numpy(jlse[i]), torch.from_numpy(jdelta[i]),
                     causal, scale) for i in range(h)]
    dk = torch.stack([t[0] for t in dkv], dim=1)[None]
    dv = torch.stack([t[1] for t in dkv], dim=1)[None]
    if causal and sk > sq:   # keys no query sees: zeros on both sides
        assert not dk[0, sq:].any() and not dv[0, sq:].any()
        assert not jdk[0, sq:].any() and not jdv[0, sq:].any()
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=0, atol=LSE_ATOL)
    if dtype == "float32":
        np.testing.assert_allclose(o.numpy(), jo, rtol=F32["o"],
                                   atol=F32["o"])
        np.testing.assert_allclose(dq.numpy(), jdq, rtol=F32["dq"],
                                   atol=F32["dq"])
        for got, want in ((dk, jdk), (dv, jdv)):
            np.testing.assert_allclose(got.numpy(), want, rtol=F32["dkv"],
                                       atol=F32["dkv"])
        return
    for name, got, want in (("O", o, jo), ("dQ", dq, jdq), ("dK", dk, jdk),
                            ("dV", dv, jdv)):
        ratio = chip_smoke.row_ratio(torch, got, torch.tensor(want))
        assert ratio <= 1.0, f"{name}: worst row at {ratio:.3g} of its limit"
