"""Attention functionals.

Counterpart of ``paddle_tpu/nn/functional/attention.py`` (reference:
python/paddle/nn/functional/flash_attention.py: ``flash_attention``
:195, ``flash_attn_unpadded`` :593, the sdp kernel selection :155), on
the port's ``Tensor`` and autograd surface (``_core.autograd.apply``,
``ops/_registry``'s ``as_tensor`` and ``raw``).

:func:`flash_attention` follows the JAX package's switch, with "Pallas
is available" read as "the tensors lie on the card": CUDA tensors with
``backend != "xla"`` and no dropout take the hand-written flash kernels
(``ops/kernels/flash_attention.py``: B1 forward, B2 and B3 under
``.backward()``; head dims 64 and 128, float32 or bfloat16, else it
raises there); everything else takes :func:`_sdpa_xla`, op for op the
JAX package's einsum attention. Dropout draws its keep-mask from
``_core.random.next_rng_key()``, so under the same ``paddle.seed`` it
equals the JAX package's mask bit for bit. The other functionals are
compositions in the reference too (segment masks, a column-wise
flashmask) and stay so here.
"""
from __future__ import annotations

import math

import torch

from ..._core import random as prng
from ..._core.autograd import apply
from ...ops._registry import as_tensor, raw
from ...ops.kernels import flash_attention as _fa

_F32_MIN = torch.finfo(torch.float32).min


def _sdpa_xla(q, k, v, bias=None, causal=False, scale=None, dropout=0.0,
              dropout_key=None):
    """Reference attention on (B, S, H, D): float32 scores, an additive
    ``bias``, the causal mask aligned to the bottom right, softmax,
    dropout on the probabilities, then the product with v in q's dtype.
    Output in q's dtype."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * s
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    if causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((qlen, klen), dtype=torch.bool,
                          device=q.device).tril(klen - qlen)
        logits = torch.where(mask, logits, _F32_MIN)
    probs = torch.softmax(logits, dim=-1)
    if dropout > 0.0 and dropout_key is not None:
        keep = prng.bernoulli(dropout_key, 1.0 - dropout, probs.shape,
                              device=probs.device)
        probs = probs * keep / (1.0 - dropout)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    training=True, rng_name="", name=None, backend=None):
    """reference: python/paddle/nn/functional/flash_attention.py:195.
    Layout (batch, seq, heads, head_dim). Returns ``(out, None)``."""
    q, k, v = as_tensor(query), as_tensor(key), as_tensor(value)
    dk = None
    if dropout > 0.0 and training:
        dk = prng.next_rng_key()
    if q.place.type == "cuda" and backend != "xla" and dropout == 0.0:
        def f(qq, kk, vv):
            return _fa.flash_attention(qq, kk, vv, causal=causal)
    else:
        def f(qq, kk, vv):
            return _sdpa_xla(qq, kk, vv, causal=causal,
                             dropout=dropout if training else 0.0,
                             dropout_key=dk)
    return apply(f, q, k, v, name="flash_attention"), None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """reference: python/paddle/nn/functional/flash_attention.py
    scaled_dot_product_attention, (B, S, H, D) layout. A boolean
    ``attn_mask`` keeps where True; a float one is added to the
    scores."""
    q, k, v = as_tensor(query), as_tensor(key), as_tensor(value)
    dk = None
    if dropout_p > 0.0 and training:
        dk = prng.next_rng_key()
    args = [q, k, v]
    if attn_mask is not None:
        args.append(as_tensor(attn_mask, place=q.place))

    def f(qq, kk, vv, *rest):
        bias = None
        if rest:
            m = rest[0].to(qq.device)
            bias = (torch.where(m, 0.0, _F32_MIN)
                    if m.dtype == torch.bool else m)
        return _sdpa_xla(qq, kk, vv, bias=bias, causal=is_causal,
                         dropout=dropout_p if training else 0.0,
                         dropout_key=dk)
    return apply(f, *args, name="sdpa")


def _index(x, like):
    """An index tensor argument (cumulative lengths, flashmask rows) as
    a torch tensor on ``like``'s device."""
    return raw(as_tensor(x, place=like.place)).to(like.place)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """reference: flash_attention.py:593, varlen packed attention on
    (total, H, D): a segment mask from the cumulative lengths (causal
    within each segment) over one packed block. Returns ``(out,
    None)``; ``dropout`` is not applied, as in the JAX package."""
    q, k, v = as_tensor(query), as_tensor(key), as_tensor(value)
    cq, ck = _index(cu_seqlens_q, q), _index(cu_seqlens_k, q)

    def f(qq, kk, vv):
        iq = torch.arange(qq.shape[0], dtype=cq.dtype, device=qq.device)
        ik = torch.arange(kk.shape[0], dtype=ck.dtype, device=qq.device)
        seg_q = torch.searchsorted(cq, iq, right=True)
        seg_k = torch.searchsorted(ck, ik, right=True)
        logits = torch.einsum("qhd,khd->hqk", qq.float(),
                              kk.float()) * scale
        mask = seg_q[:, None] == seg_k[None, :]
        if causal:
            pos_q = iq - cq[seg_q - 1]
            pos_k = ik - ck[seg_k - 1]
            mask = mask & (pos_q[:, None] >= pos_k[None, :])
        logits = torch.where(mask[None], logits, _F32_MIN)
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("hqk,khd->qhd", probs.to(qq.dtype), vv)
    return apply(f, q, k, v, name="flash_attn_unpadded"), None


def sdp_kernel(*args, **kwargs):
    """Parity no-op: the kernel is chosen by :func:`flash_attention`'s
    switch."""
    class _Ctx:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    return _Ctx()


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, fixed_seed_offset=None,
                         training=True, rng_name="", name=None):
    """reference: nn/functional/flash_attention.py flash_attn_qkvpacked:
    qkv packed as (B, S, 3, H, D), unpacked onto
    :func:`flash_attention`."""
    t = as_tensor(qkv)
    return flash_attention(t[:, :, 0], t[:, :, 1], t[:, :, 2],
                           dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale=None,
                                dropout=0.0, causal=False,
                                return_softmax=False, training=True,
                                name=None):
    """reference: flash_attention.py flash_attn_varlen_qkvpacked: the
    variable-length packed layout (total, 3, H, D) with cumulative
    lengths, unpacked onto :func:`flash_attn_unpadded`."""
    t = as_tensor(qkv)
    return flash_attn_unpadded(
        t[:, 0], t[:, 1], t[:, 2], cu_seqlens_q, cu_seqlens_k,
        max_seqlen_q, max_seqlen_k, scale=scale, dropout=dropout,
        causal=causal, return_softmax=return_softmax, training=training)


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, window_size=None,
                        return_softmax_lse=False, return_seed_offset=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """reference: flash_attention.py flashmask_attention: attention under
    a column-wise mask, ``startend_row_indices`` (B, H|1, S, 1) giving
    per key column the first query row that must NOT attend (plus the
    causal mask under ``causal``), expanded to a dense mask as the JAX
    package does. Without indices it is :func:`flash_attention`."""
    q, k, v = as_tensor(query), as_tensor(key), as_tensor(value)
    if startend_row_indices is None:
        return flash_attention(q, k, v, dropout=dropout, causal=causal,
                               training=training)
    sri = _index(startend_row_indices, q)

    def f(qq, kk, vv):
        S, D = qq.shape[1], qq.shape[3]
        s = torch.einsum("bqhd,bkhd->bhqk", qq.float(),
                         kk.float()) * (1.0 / math.sqrt(D))
        start = sri[..., 0]                      # (B, H|1, S)
        rows = torch.arange(S, device=qq.device)[None, None, :, None]
        # row r attends to column c iff r < start[c] (plus causal r >= c)
        mask = rows < start[:, :, None, :]
        if causal:
            cols = torch.arange(S, device=qq.device)[None, None, None, :]
            mask = mask & (rows >= cols)
        s = torch.where(mask, s, -1e30)
        p = torch.softmax(s, dim=-1).to(qq.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, vv)

    out = apply(f, q, k, v, name="flashmask_attention")
    if return_softmax_lse or return_seed_offset:
        outs = (out, None)
        if return_seed_offset:
            outs = outs + (None,)
        return outs
    return out
