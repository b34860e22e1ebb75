"""A CPU model of the numerics of the Hopper flash kernels (B1, B3) against
the JAX package's flash attention, on the CPU.

``csrc/flash_attention.cu`` computes, for bf16 on an H100, what the
emulation below computes step by step: B1 walks 128-key tiles with an
online softmax in exp2 (``scale * log2(e)`` folded into one multiply-add,
the running max kept in raw ``q.k`` units), rounds p to the value dtype
before ``p @ v`` while l sums it unrounded, rounds ``O = acc * (1 / l)``
once, and returns ``lse = m * scale + log(l)`` in natural-log units; B3
walks 64-key tiles with ``p = 2^(s * c - lse * log2(e))`` and rounds
``ds = p * (dp - delta) * scale`` to the key dtype before ``ds @ k``. The
kernels cannot run here; this model settles that those choices compute
what the TPU kernels compute.

The same seeded numpy inputs go through the JAX ``_fwd`` (O, lse) and
``_bwd`` (dQ, on the JAX forward's own O and lse) in interpret mode, 128
blocks, as ``tests/test_torch_flash.py`` runs them, and through the
model. Lengths that are not multiples of a tile, Sq != Sk both ways,
causal (top-left aligned) and full. Tolerances: float32, O 2e-5, lse
1e-5 and dQ 1e-4 (the same f32 math summed in another order; dQ sums up
to 320 products of O(1), as ``test_torch_flash.py`` holds gradients);
bfloat16 inputs, ``chip_smoke.py``'s row rule (every D-vector within
``ROW_RTOL * |its row| + ROW_FLOOR * rms``) for O and dQ, lse 1e-5.
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
F32 = dict(o=2e-5, dq=1e-4)
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


def _jax_reference(q, k, v, do, causal, scale, jdt):
    """JAX ``_fwd`` and ``_bwd`` (interpret mode, 128 blocks) on
    (1, S, H, D) numpy inputs -> O, dQ (1, Sq, H, D) f32 numpy and
    lse (H, Sq), delta (H, Sq)."""
    _, sq, h, d = q.shape
    sk = k.shape[1]

    def bhsd(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(h, -1, d), jdt)

    @jax.jit
    def run(q, k, v, do):
        out, lse = jfa._fwd(q, k, v, scale, causal, 128, 128)
        dq, _, _ = jfa._bwd(scale, causal, 128, 128, None, None,
                            (q, k, v, out, lse), do)
        delta = jnp.sum(out.astype(jnp.float32) * do.astype(jnp.float32),
                        axis=-1)
        return out, lse, dq, delta

    out, lse, dq, delta = run(bhsd(q), bhsd(k), bhsd(v), bhsd(do))

    def back(a, s):  # (H, S, D) -> (1, S, H, D)
        return np.asarray(a.astype(jnp.float32)).reshape(
            1, h, s, d).transpose(0, 2, 1, 3)

    return (back(out, sq), np.array(lse)[..., 0], back(dq, sq),
            np.array(delta))


CASES = [(sq, sk, causal) for sq, sk in ((200, 200), (72, 136), (320, 192))
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
    jo, jlse, jdq, jdelta = _jax_reference(
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
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=0, atol=LSE_ATOL)
    if dtype == "float32":
        np.testing.assert_allclose(o.numpy(), jo, rtol=F32["o"],
                                   atol=F32["o"])
        np.testing.assert_allclose(dq.numpy(), jdq, rtol=F32["dq"],
                                   atol=F32["dq"])
        return
    for name, got, want in (("O", o, jo), ("dQ", dq, jdq)):
        ratio = chip_smoke.row_ratio(torch, got, torch.tensor(want))
        assert ratio <= 1.0, f"{name}: worst row at {ratio:.3g} of its limit"
