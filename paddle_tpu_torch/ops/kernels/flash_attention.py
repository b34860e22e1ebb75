"""B1-B3 flash attention for training: the forward and its two backward
passes.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``:

- :func:`flash_fwd` (B1): O and the per-row f32 log-sum-exp. CUDA
  tensors launch ``csrc/flash_attention.cu``'s forward (it replaces the
  TPU kernel ``_fwd_kernel``).
- :func:`flash_bwd_dkv` (B2) and :func:`flash_bwd_dq` (B3): dK, dV and dQ
  from the saved q, k, v, lse and ``delta = rowsum(O * dO)``, which
  stays outside the kernels in plain torch as it does in the JAX
  package. They replace ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``.
- :class:`_FlashAttention` ties them into one ``autograd.Function`` (the
  JAX package's ``custom_vjp`` ``_flash_bhsd``), and
  :func:`flash_attention` is the public op on ``(B, S, H, D)``.

Each wrapper takes its plain PyTorch version for CPU tensors, never for
CUDA ones, and counts its kernel launches in ``.launches``. The kernels
read ``(B, S, H, D)`` in place, so no transpose to the TPU's
``(B*H, S, D)`` happens; the TPU's block sizes and its
``FLASH_WINNER.json`` tuning are not carried over (the CUDA kernels use
their own 64-row tiles), nor are ``_fwd``'s ``kv_rep`` and ``out_dtype``
options, which only the context-parallel ring attention uses.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

#: the Pallas kernels' finite mask value for scores above the diagonal
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SHAPE = (_I, _I, _I, _I, _I)          # B, H, Sq, Sk, D
_TAIL = (ctypes.c_float, _I, _I, _P)   # scale, causal, dtype, stream
SIGNATURES = {
    "ptt_flash_fwd": (_P, _P, _P, _P, _P) + _SHAPE + _TAIL,
    "ptt_flash_bwd_dkv": (_P,) * 8 + _SHAPE + _TAIL,
    "ptt_flash_bwd_dq": (_P,) * 7 + _SHAPE + _TAIL,
}


def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """(B, H, Sq, Sk) f32 scores ``q . k * scale``, masked above the
    diagonal (top-left aligned) with the Pallas kernels' mask value."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, DEFAULT_MASK_VALUE)
    return s


def flash_attention_plain(q, k, v, causal: bool = False, scale=None):
    """Plain forward, op for op what B1 computes: f32 scores, the
    ``DEFAULT_MASK_VALUE`` mask, ``p = exp(s - m)`` cast to v's dtype
    before ``p @ v`` (products summed in f32), ``O = acc / l`` and
    ``lse = m + log(l)``. Differentiable by autograd (``m`` is detached:
    O and lse do not depend on it).

    q: (B, Sq, H, D); k, v: (B, Sk, H, D) -> O (B, Sq, H, D) in q's dtype,
    lse (B, H, Sq) f32."""
    s_ = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, causal, s_)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    """The backward kernels' shared recompute: p = exp(s - lse) and
    ds = p * (dO . v - delta) * scale, (B, H, Sq, Sk) f32."""
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Plain B2: dV = p^T dO with p cast to dO's dtype, dK = ds^T q with
    ds cast to q's dtype, products summed in f32. lse, delta: (B, H, Sq)
    f32 -> dK, dV (B, Sk, H, D) in k's and v's dtypes."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Plain B3: dQ = ds k with ds cast to k's dtype, summed in f32."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def _check(what: str, q, k, v, *rest):
    """Raise unless q (B, Sq, H, D) and k, v (B, Sk, H, D) are CUDA
    tensors of one dtype the kernels take, D in ``HEAD_DIMS``, every
    tensor contiguous and 16-byte aligned; returns (B, H, Sq, Sk, D)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: the kernel needs CUDA tensors, got {dev}")
    if q.dim() != 4 or q.dtype not in _DTYPES:
        raise ValueError(f"{what}: q must be (B, S, H, D) float32 or "
                         f"bfloat16, got {tuple(q.shape)} {q.dtype}")
    B, Sq, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D}; the kernels take "
                         f"{' or '.join(map(str, HEAD_DIMS))}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[2:] != (H, D):
        raise ValueError(f"{what}: k and v must be (B, Sk, H, D) = "
                         f"({B}, Sk, {H}, {D}), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    for t in (q, k, v) + rest:
        if t.device != dev:
            raise ValueError(f"{what}: all tensors must be on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be contiguous and "
                             f"16-byte aligned")
    for t in (k, v):
        if t.dtype != q.dtype:
            raise ValueError(f"{what}: q, k and v must share one dtype")
    return B, H, Sq, k.shape[1], D


def _tail(q, causal, scale):
    return (float(scale), int(bool(causal)), _DTYPES[q.dtype],
            _build.stream_handle(q.device))


def flash_fwd(q, k, v, *, causal: bool, scale: float):
    """B1: ``(O, lse)`` of q (B, Sq, H, D) against k, v (B, Sk, H, D) —
    the plain version for CPU tensors, the kernel for CUDA tensors (or an
    error)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    B, H, Sq, Sk, D = _check("flash_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention", SIGNATURES)
    rc = lib.ptt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), B, H, Sq, Sk, D,
                           *_tail(q, causal, scale))
    _build.check(lib, rc, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def _check_rows(what, q, do, lse, delta):
    B, Sq, H, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{what}: dO must match q's shape and dtype")
    for t, nm in ((lse, "lse"), (delta, "delta")):
        if t.shape != (B, H, Sq) or t.dtype != torch.float32:
            raise ValueError(f"{what}: {nm} must be float32 (B, H, Sq) = "
                             f"({B}, {H}, {Sq})")


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """B2: ``(dK, dV)`` — the plain version for CPU tensors, the kernel
    for CUDA tensors (or an error)."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    B, H, Sq, Sk, D = _check("flash_bwd_dkv", q, k, v, do, lse, delta)
    _check_rows("flash_bwd_dkv", q, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.load("flash_attention", SIGNATURES)
    rc = lib.ptt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, Sq, Sk, D, *_tail(q, causal, scale))
    _build.check(lib, rc, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """B3: dQ — the plain version for CPU tensors, the kernel for CUDA
    tensors (or an error)."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    B, H, Sq, Sk, D = _check("flash_bwd_dq", q, k, v, do, lse, delta)
    _check_rows("flash_bwd_dq", q, do, lse, delta)
    dq = torch.empty_like(q)
    lib = _build.load("flash_attention", SIGNATURES)
    rc = lib.ptt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, H, Sq, Sk, D, *_tail(q, causal, scale))
    _build.check(lib, rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_fwd.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


class _FlashAttention(torch.autograd.Function):
    """B1 forward, saving (q, k, v, O, lse); backward computes
    ``delta = rowsum(O * dO)`` in f32, then runs B2 and B3."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (out.float() * do.float()).sum(dim=-1).transpose(1, 2)
        delta = delta.contiguous()                     # (B, H, Sq)
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, scale=None):
    """(B, S, H, D) flash attention with a flash backward (B1-B3).

    q: (B, Sq, H, D); k, v: (B, Sk, HK, D) with H a multiple of HK. GQA
    repeats the kv heads first, as the JAX op does, so autograd sums dK
    and dV over each group. ``scale`` defaults to ``1/sqrt(D)``."""
    B, Sq, H, D = q.shape
    hk = k.shape[2]
    if hk != H:
        if H % hk:
            raise ValueError(f"flash_attention: {H} query heads are not a "
                             f"multiple of {hk} kv heads")
        k = torch.repeat_interleave(k, H // hk, dim=2)
        v = torch.repeat_interleave(v, H // hk, dim=2)
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    return _FlashAttention.apply(q, k, v, causal, float(s))
