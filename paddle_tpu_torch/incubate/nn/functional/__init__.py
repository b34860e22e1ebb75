"""The fused serving ops of ``paddle.incubate.nn.functional`` (reference:
``python/paddle/incubate/nn/functional/``; CUDA kernels
``paddle/phi/kernels/fusion/*``), counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py`` for the functions that
reach a hand-written kernel:

- :func:`fused_rms_norm` (B4a through ``ops.kernels.fused.rms_norm``,
  the residual form included) and :func:`fused_layer_norm`;
- :func:`swiglu`, one- and two-operand (B5a);
- :func:`fused_rotary_position_embedding` (B6 for neox style with
  shared tables, q and k and no v; otherwise the composition, neox and
  GPT-J styles, ``position_ids``, ``v``);
- :func:`blha_get_max_len` and :func:`block_multihead_attention` (B8 for
  pure-decode batches; otherwise the per-row loop with prefill rows,
  ``rope_emb``, ``mask``, pre caches, ``qkv_bias`` and static or dynamic
  int8 scales).

The reference gates its Pallas kernels on a TPU (``_use_pallas_fused``,
``_pf.available()``); here the gate is where the tensors lie: CUDA
tensors take the kernels, CPU tensors the composition.
``PADDLE_TPU_FORCE_PALLAS_FUSED=1`` takes the fused functions anywhere
(on CPU tensors their wrappers run the kernels' plain versions, the
counterpart of the reference's interpret mode) and ``=0`` keeps the
composition everywhere. The other functions of the reference's module
(``fused_multi_transformer``, ``masked_multihead_attention``,
``fused_moe``, ...) reach no TPU kernel and wait for ROADMAP.md queue A
step 9b.

Inputs may be ``Tensor``\\ s, ``torch.Tensor``\\ s or host arrays; host
arrays go to the device of the op's first tensor argument.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as TF

from ...._core.autograd import apply
from ...._core.tensor import Tensor
from ....ops._registry import as_tensor, raw
from ....ops.kernels import fused as _fk

FORCE_ENV = "PADDLE_TPU_FORCE_PALLAS_FUSED"

__all__ = [
    "fused_rms_norm", "fused_layer_norm", "swiglu",
    "fused_rotary_position_embedding", "blha_get_max_len",
    "block_multihead_attention",
]


def _use_pallas_fused(x) -> bool:
    """Take the fused functions for ``x``: on CUDA tensors, unless
    ``PADDLE_TPU_FORCE_PALLAS_FUSED`` is "1" (anywhere) or "0"
    (nowhere)."""
    force = os.environ.get(FORCE_ENV)
    if force == "1":
        return True
    if force == "0":
        return False
    return raw(x).device.type == "cuda"


def _norm_args(x, bias, residual, norm_weight, norm_bias, begin_norm_axis):
    """(args, positions of the optional operands, normalised axes)."""
    args, opt = [x], {}
    for nm, t in (("bias", bias), ("residual", residual),
                  ("w", norm_weight), ("b", norm_bias)):
        if t is not None:
            opt[nm] = len(args)
            args.append(as_tensor(t, place=x.place))
    ax = begin_norm_axis if begin_norm_axis >= 0 else x.ndim + begin_norm_axis
    return args, opt, tuple(range(ax, x.ndim))


def _compute_type(v):
    return torch.float32 if v.dtype in (torch.bfloat16, torch.float16) \
        else v.dtype


def _pre_norm(v, rest, opt):
    """The input in its compute type with the pre-norm bias and the
    residual added: (vv, compute type)."""
    ct = _compute_type(v)
    vv = v.to(ct)
    if "bias" in opt:
        vv = vv + rest[opt["bias"] - 1].to(ct)
    if "residual" in opt:
        vv = vv + rest[opt["residual"] - 1].to(ct)
    return vv, ct


def _post_norm(v, out, res_out, rest, opt, ct):
    if "w" in opt:
        out = out * rest[opt["w"] - 1].to(ct)
    if "b" in opt:
        out = out + rest[opt["b"] - 1].to(ct)
    if "residual" in opt:
        return out.to(v.dtype), res_out.to(v.dtype)
    return out.to(v.dtype)


def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, **_):
    """RMSNorm with optional pre-norm bias and residual add (reference:
    ``fused_rms_norm.py``). Returns ``(out, residual_out)`` when
    ``residual`` is given, else ``out``. The last-axis form with a
    weight and no biases takes B4a (``ops.kernels.fused.rms_norm``) on
    CUDA tensors."""
    x = as_tensor(x)
    args, opt, naxes = _norm_args(x, bias, residual, norm_weight, norm_bias,
                                  begin_norm_axis)
    if (_use_pallas_fused(x) and norm_bias is None and bias is None
            and norm_weight is not None and naxes == (x.ndim - 1,)):
        w = args[opt["w"]]
        eps = float(epsilon)
        if residual is not None:
            return apply(lambda v, res, wv: _fk.rms_norm(v, wv, eps,
                                                         residual=res),
                         x, args[opt["residual"]], w, name="fused_rms_norm",
                         multi_out=True)
        return apply(lambda v, wv: _fk.rms_norm(v, wv, eps), x, w,
                     name="fused_rms_norm")

    def f(v, *rest):
        vv, ct = _pre_norm(v, rest, opt)
        var = torch.mean(torch.square(vv), dim=naxes, keepdim=True)
        return _post_norm(v, vv * torch.rsqrt(var + epsilon), vv, rest,
                          opt, ct)

    return apply(f, *args, name="fused_rms_norm",
                 multi_out=residual is not None)


def fused_layer_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None, **_):
    """LayerNorm with optional pre-norm bias and residual add (reference:
    ``fused_layer_norm.py``); the composition everywhere, as in the
    reference."""
    x = as_tensor(x)
    args, opt, naxes = _norm_args(x, bias, residual, norm_weight, norm_bias,
                                  begin_norm_axis)

    def f(v, *rest):
        vv, ct = _pre_norm(v, rest, opt)
        mean = torch.mean(vv, dim=naxes, keepdim=True)
        var = torch.mean(torch.square(vv - mean), dim=naxes, keepdim=True)
        return _post_norm(v, (vv - mean) * torch.rsqrt(var + epsilon), vv,
                          rest, opt, ct)

    return apply(f, *args, name="fused_layer_norm",
                 multi_out=residual is not None)


def _silu_mul(a, b):
    return TF.silu(a.float()).to(a.dtype) * b


def swiglu(x, y=None, name=None):
    """``silu(x) * y``; with ``y`` None, x is split in half along the
    last dim (reference: ``swiglu.py``). B5a on CUDA tensors."""
    x = as_tensor(x)
    fused = _use_pallas_fused(x)
    if y is None:
        def f(v):
            a, b = torch.chunk(v, 2, dim=-1)
            return _fk.swiglu(a, b) if fused else _silu_mul(a, b)
        return apply(f, x, name="swiglu")
    return apply(_fk.swiglu if fused else _silu_mul, x,
                 as_tensor(y, place=x.place), name="swiglu")


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    rotary_emb_base=10000.0,
                                    time_major=False):
    """RoPE on q, k and v (B, S, H, D) (reference:
    ``fused_rotary_position_embedding.py``, kernel
    ``fused_rope_kernel.cu``); returns the rotated ``(q, k, v)``, None
    where none was given. Tables: ``sin``/``cos`` of (S, D) or (S, D/2)
    values (their first D/2 columns are used), or f32 tables from
    ``rotary_emb_base``. Neox style with shared tables, q and k and no v
    takes B6 (``ops.kernels.fused.rope_qk``) on CUDA tensors."""
    q0 = as_tensor(next(t for t in (q, k, v) if t is not None))
    B, S, H, D = q0.shape
    dev = q0.place
    if sin is None or cos is None:
        inv = 1.0 / (rotary_emb_base ** (torch.arange(
            0, D, 2, dtype=torch.float32, device=dev) / D))
        freqs = torch.outer(torch.arange(S, dtype=torch.float32, device=dev),
                            inv)
        cos_t, sin_t = torch.cos(freqs), torch.sin(freqs)
    else:
        cos_t = raw(as_tensor(cos, place=dev)).reshape(S, -1)[:, :D // 2]
        sin_t = raw(as_tensor(sin, place=dev)).reshape(S, -1)[:, :D // 2]
    if position_ids is not None:
        pid = raw(as_tensor(position_ids, place=dev)).long()   # (B, S)
        cos_t, sin_t = cos_t[pid], sin_t[pid]                   # (B, S, D/2)

        def expand(c):
            return c[:, :, None, :]
    else:
        def expand(c):
            return c[None, :, None, :]

    if (_use_pallas_fused(q0) and use_neox_rotary_style
            and position_ids is None and q is not None and k is not None
            and v is None):
        rq, rk = apply(lambda qv, kv: _fk.rope_qk(qv, kv, cos_t, sin_t),
                       as_tensor(q), as_tensor(k, place=dev),
                       name="fused_rope", multi_out=True)
        return rq, rk, None

    def f(x):
        c, s = expand(cos_t).float(), expand(sin_t).float()
        xf = x.float()
        if use_neox_rotary_style:
            x1, x2 = torch.chunk(xf, 2, dim=-1)
            out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
        else:                          # GPT-J interleaved pairs
            x1, x2 = xf[..., 0::2], xf[..., 1::2]
            out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                              dim=-1).reshape(xf.shape)
        return out.to(x.dtype)

    return tuple(None if t is None else
                 apply(f, as_tensor(t, place=dev), name="fused_rope")
                 for t in (q, k, v))


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size=None,
                     name=None):
    """The largest encoder and decoder lengths, each as a (1,) tensor
    (reference: ``blha_get_max_len.py``)."""
    enc = raw(as_tensor(seq_lens_encoder))
    dec = raw(as_tensor(seq_lens_decoder, place=enc.device))
    return (Tensor(enc.max().reshape(1), _internal=True),
            Tensor(dec.max().reshape(1), _internal=True))


def _host(t) -> np.ndarray:
    """A length vector or block table on the host: one copy from the
    device for a tensor (a sync), none for host data."""
    if isinstance(t, (Tensor, torch.Tensor)):
        return raw(t).cpu().numpy()
    return np.asarray(t)


def _quant(x, s):
    """int8 rows of x in f32 times the quant scale s: round half to even,
    clip to +-127 (the reference's ``jnp.round`` / ``jnp.clip``)."""
    return torch.clamp(torch.round(x.float() * s), -127, 127).to(torch.int8)


def block_multihead_attention(
        qkv, key_cache, value_cache, seq_lens_encoder, seq_lens_decoder,
        seq_lens_this_time, padding_offsets=None, cum_offsets=None,
        cu_seqlens_q=None, cu_seqlens_k=None, block_tables=None,
        pre_key_cache=None, pre_value_cache=None,
        cache_k_quant_scales=None, cache_v_quant_scales=None,
        cache_k_dequant_scales=None, cache_v_dequant_scales=None,
        rope_emb=None, mask=None,
        tgt_mask=None, max_seq_len=-1, block_size=64, use_neox_style=False,
        qkv_bias=None, out_shift=None, out_smooth=None,
        max_enc_len_this_time=None, max_dec_len_this_time=None,
        use_dynamic_cachekv_quant=False, **_):
    """Attention over a paged KV cache for a varlen token batch that mixes
    prefill and decode rows (reference: ``block_multihead_attention.py``
    / ``block_multi_head_attention_kernel.cu``). Shapes:

      qkv              [total_tokens, 3 * nh * hd]
      key/value_cache  [num_blocks, nh, block_size, hd]
      block_tables     [B, max_blocks_per_seq] (-1 padded)

    Returns ``(out [total_tokens, nh * hd], qkv, key_cache,
    value_cache)``. As Paddle's CUDA op does, the new K/V rows are
    written into the caches in place and the same cache tensors come
    back (the reference returns new arrays). ``seq_lens_*`` and
    ``block_tables`` are read on the host, one copy each.

    A pure-decode batch (one token a row, no prefill row, no ``rope_emb``,
    ``mask`` or pre caches) of CUDA tensors takes B8
    (``ops.kernels.fused.paged_decode_attention``) after one vectorized
    write of the new rows; so does one of CPU tensors under
    ``PADDLE_TPU_FORCE_PALLAS_FUSED=1`` (the plain version). Otherwise
    each row gathers its pages and attends in f32 with a causal mask,
    pre caches prepended, ``mask`` added.

    int8 caches: given quant scales, the new rows are quantized with the
    per-head (static, [nh]) or per-sequence-per-head (dynamic, [B, nh])
    quant scales and the reads dequantize with the dequant scales
    (default 1 / quant)."""
    if (pre_key_cache is None) != (pre_value_cache is None):
        raise ValueError(
            "block_multihead_attention: pre_key_cache and "
            "pre_value_cache must be passed together")
    qkv_t = as_tensor(qkv)
    dev = qkv_t.place

    def val(t):
        return None if t is None else raw(as_tensor(t, place=dev))

    key_cache = as_tensor(key_cache, place=dev)
    value_cache = as_tensor(value_cache, place=dev)
    kc, vc = raw(key_cache), raw(value_cache)
    pre_k, pre_v = val(pre_key_cache), val(pre_value_cache)
    qv = raw(qkv_t)
    enc, dec = _host(seq_lens_encoder), _host(seq_lens_decoder)
    this, bt = _host(seq_lens_this_time), _host(block_tables)
    if qkv_bias is not None:
        qv = qv + val(qkv_bias).reshape(-1)
    nh, bs, hd = kc.shape[1], kc.shape[2], kc.shape[3]
    B = bt.shape[0]
    total = qv.shape[0]
    q3 = qv.reshape(total, 3, nh, hd)

    kq, vq = val(cache_k_quant_scales), val(cache_v_quant_scales)
    kdq = (val(cache_k_dequant_scales) if cache_k_dequant_scales is not None
           else (1.0 / kq if kq is not None else None))
    vdq = (val(cache_v_dequant_scales) if cache_v_dequant_scales is not None
           else (1.0 / vq if vq is not None else None))
    if (kq is None) != (vq is None):
        raise ValueError(
            "block_multihead_attention: cache_k_quant_scales and "
            "cache_v_quant_scales must be passed together (got only "
            f"{'k' if kq is not None else 'v'} scales) — an int8 cache "
            "quantizes both K and V")
    cache_quant = kq is not None
    if cache_quant:
        want = 2 if use_dynamic_cachekv_quant else 1
        for nm, s in (("cache_k_quant_scales", kq),
                      ("cache_v_quant_scales", vq)):
            if s.dim() != want:
                raise ValueError(
                    f"block_multihead_attention: {nm} must be "
                    f"{'[B, num_head]' if want == 2 else '[num_head]'} "
                    f"for use_dynamic_cachekv_quant="
                    f"{use_dynamic_cachekv_quant}, got ndim {s.dim()}")

    def _sc(scales, b, shape):
        """Per-head scales, static [nh] or dynamic [B, nh]."""
        s = scales[b] if (use_dynamic_cachekv_quant and scales.dim() == 2) \
            else scales
        return s.float().reshape(shape)

    def _write(pages, rows, k_new, v_new, qk_scales, qv_scales):
        """New rows (t, nh, hd) into the pools at (pages, :, rows)."""
        if cache_quant:
            kc[pages, :, rows] = _quant(k_new, qk_scales)
            vc[pages, :, rows] = _quant(v_new, qv_scales)
        else:
            kc[pages, :, rows] = k_new.to(kc.dtype)
            vc[pages, :, rows] = v_new.to(vc.dtype)

    def _idx(a):
        return torch.as_tensor(a.astype(np.int64), device=dev)

    def _result(out):
        return (Tensor(out, _internal=True), Tensor(qv, _internal=True),
                key_cache, value_cache)

    kernel_here = dev.type == "cuda" or os.environ.get(FORCE_ENV) == "1"
    if (rope_emb is None and mask is None and total == B
            and int(enc.max(initial=0)) == 0 and np.all(this == 1)
            and pre_k is None and kernel_here):
        pos = dec.astype(np.int64)
        if cache_quant:
            def bscale(s):   # (B, nh, 1) or (1, nh, 1)
                s = s.float()
                return s[:, :, None] if use_dynamic_cachekv_quant \
                    else s.reshape(1, nh, 1)
            qk, qvs = bscale(kq), bscale(vq)
        else:
            qk = qvs = None
        _write(_idx(bt[np.arange(B), pos // bs]), _idx(pos % bs),
               q3[:, 1], q3[:, 2], qk, qvs)
        out = _fk.paged_decode_attention(
            q3[:, 0], kc, vc,
            torch.as_tensor(bt.astype(np.int32), device=dev),
            torch.as_tensor((dec + 1).astype(np.int32), device=dev),
            k_dequant_scale=kdq if cache_quant else None,
            v_dequant_scale=vdq if cache_quant else None)
        return _result(out.reshape(B, nh * hd))

    outs = []
    tok = 0
    for b in range(B):
        t = int(this[b])
        if t == 0:
            continue
        q = q3[tok:tok + t, 0]
        k_new = q3[tok:tok + t, 1]
        v_new = q3[tok:tok + t, 2]
        start = 0 if int(enc[b]) > 0 else int(dec[b])
        if rope_emb is not None:
            rot = val(rope_emb)           # [2, 1|B, 1, max_seq, hd]
            rb = rot[:, b] if rot.shape[1] > 1 else rot[:, 0]
            cos = rb[0, 0, start:start + t][:, None, :]
            sin = rb[1, 0, start:start + t][:, None, :]

            def rope_t(tn):
                if use_neox_style:
                    h1, h2 = torch.chunk(tn, 2, dim=-1)
                    r = torch.cat([-h2, h1], dim=-1)
                else:
                    te, to = tn[..., 0::2], tn[..., 1::2]
                    r = torch.stack([-to, te], dim=-1).reshape(tn.shape)
                return tn * cos.to(tn.dtype) + r * sin.to(tn.dtype)
            q, k_new = rope_t(q), rope_t(k_new)
        pos = start + np.arange(t)
        if cache_quant:
            _write(_idx(bt[b, pos // bs]), _idx(pos % bs), k_new, v_new,
                   _sc(kq, b, (1, nh, 1)), _sc(vq, b, (1, nh, 1)))
        else:
            _write(_idx(bt[b, pos // bs]), _idx(pos % bs), k_new, v_new,
                   None, None)
        kl = start + t
        pages = [int(bt[b, p]) for p in range((kl + bs - 1) // bs)]
        ks = torch.cat([kc[p] for p in pages], dim=1)[:, :kl]
        vs = torch.cat([vc[p] for p in pages], dim=1)[:, :kl]
        if cache_quant:
            ks = ks.float() * _sc(kdq, b, (nh, 1, 1))
            vs = (vs.float() * _sc(vdq, b, (nh, 1, 1))).to(qv.dtype)
        plen = 0
        if pre_k is not None:
            # prefix-tuning virtual tokens: columns [0, plen) visible to
            # every query, real positions not shifted
            plen = pre_k.shape[2]
            ks = torch.cat([pre_k[b].to(ks.dtype), ks], dim=1)
            vs = torch.cat([pre_v[b].to(vs.dtype), vs], dim=1)
        logits = torch.einsum("qhd,hkd->hqk", q.float(),
                              ks.float()) / math.sqrt(hd)
        qpos = start + torch.arange(t, device=dev)[None, :, None]
        kpos = torch.arange(logits.shape[2], device=dev)[None, None, :]
        logits = torch.where((kpos < plen) | (kpos - plen <= qpos), logits,
                             -1e30)
        if mask is not None:
            mv = val(mask)                # [B|1, 1, Smax, Smax]
            mb = mv[b if mv.shape[0] > 1 else 0]
            mb = mb[..., start:start + t, :kl].float()
            if plen:
                # the mask addresses real cache positions; prefix columns
                # are additively transparent
                mb = torch.cat([mb.new_zeros(mb.shape[:-1] + (plen,)), mb],
                               dim=-1)
            logits = logits + mb
        p = torch.softmax(logits, dim=-1)
        o = torch.einsum("hqk,hkd->qhd", p.to(vs.dtype), vs)
        outs.append(o.reshape(t, nh * hd))
        tok += t
    out = torch.cat(outs, dim=0) if outs else \
        qv.new_zeros((0, nh * hd))
    return _result(out)
