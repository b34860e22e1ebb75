"""The serving forwards: paged prefill chunk and ragged paged decode.

Counterpart of ``paddle_tpu/models/generate.py``, ported as far as the
plain continuous-batching engine runs it: the dense and paged cache
builders, the layer body with its attention, the chunked-prefill
program and the one-token decode step. The JAX package's ``lax.scan``
over the stacked layer axis is a Python loop over layer slices here.

JAX donates the page pools and gets them back updated; the port writes
the pools IN PLACE (index assignment into the ``(L, P, page, ...)``
tensors) and returns the same dict, so a GB-scale pool is never copied.
The dense temp cache of a prefill chunk is likewise filled in place.

Options of the JAX signatures that this slice leaves out (tensor and
data parallelism, MoE, adapters, quantized weights, tree masks) are not
taken; ROADMAP.md lists them in porting order.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.kernels import paged_attention as _pa
from ..ops.kernels import serving_fused as _sf
from .llama import (LlamaConfig, _lm_head, _mlp, layer_params, rms_norm,
                    rope_tables)


def _kv_zeros(cfg: LlamaConfig, shape, kv_dtype, what: str, device):
    """Zero K/V arrays of ``shape`` ``(L, N, S, nkv, hd)`` in the model
    dtype, or int8 with per-row f32 dequant scales ``ks``/``vs`` of
    ``shape[:4]``."""
    if kv_dtype is not None and kv_dtype not in ("int8", torch.int8):
        raise ValueError(
            f"{what}: kv_dtype={kv_dtype!r} is not supported — pass None "
            f"(model dtype) or 'int8' (quantized cache with per-row scales)")
    quant = kv_dtype is not None
    dt = torch.int8 if quant else cfg.dtype
    out = {n: torch.zeros(shape, dtype=dt, device=device)
           for n in ("k", "v")}
    if quant:
        out.update({n: torch.zeros(shape[:4], dtype=torch.float32,
                                   device=device) for n in ("ks", "vs")})
    return out


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, kv_dtype=None,
               device=None) -> Dict:
    """Dense ``(L, batch, max_len, nkv, hd)`` cache. ``kv_dtype="int8"``
    (or ``torch.int8``) stores int8 rows with per-row f32 dequant
    scales ``ks``/``vs`` ``(L, batch, max_len, nkv)``."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd)
    return _kv_zeros(cfg, shape, kv_dtype, "init_cache", device)


def init_paged_cache(cfg: LlamaConfig, num_pages: int, page_size: int,
                     kv_dtype=None, device=None) -> Dict:
    """Paged KV cache: one pool of ``page_size``-token pages per layer,
    ``(L, num_pages, page_size, nkv, hd)``, indexed by per-request block
    tables; ``kv_dtype="int8"`` adds the per-row scale pools
    ``ks``/``vs`` ``(L, num_pages, page_size, nkv)``."""
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, cfg.hd)
    return _kv_zeros(cfg, shape, kv_dtype, "init_paged_cache", device)


def _scatter_rows(pool: torch.Tensor, dst: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """Write token rows into pool slots IN PLACE: pool (L, P, page, ...),
    dst (N,) flat slot ids (page*page_size + offset), rows (L, N, ...)."""
    L, P, page = pool.shape[0], pool.shape[1], pool.shape[2]
    flat = pool.view((L, P * page) + tuple(pool.shape[3:]))
    flat[:, dst] = rows.to(pool.dtype)
    return pool


def _rope_rows(x, cos, sin, rpos):
    """Per-row rope: x (B,T,H,hd), rpos (B,T) logical positions."""
    c = cos[rpos][:, :, None, :]
    s = sin[rpos][:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def _rowq(t):
    """Per-row symmetric int8: (..., hd) -> (int8 rows, (...) f32
    scales), ``torch.round`` rounding half to even like ``jnp.round``."""
    sc = torch.clamp_min(torch.amax(torch.abs(t.float()), dim=-1) / 127.0,
                         1e-8)
    ti = torch.clamp(torch.round(t.float() / sc[..., None]), -127, 127)
    return ti.to(torch.int8), sc.float()


def _kv_rows(k, v, quant: bool) -> Dict[str, torch.Tensor]:
    """The rows a layer writes to its cache, by cache key: K and V as
    they are, or int8 rows with their per-row scales."""
    if not quant:
        return {"k": k, "v": v}
    kq, ksc = _rowq(k)
    vq, vsc = _rowq(v)
    return {"k": kq, "v": vq, "ks": ksc, "vs": vsc}


def _attn_with_cache(q, ck, cv, length: int, kstart, k_rows=None,
                     v_rows=None, fused=False):
    """q (B,T,nh,hd) vs cache (B,Smax,nkv,hd); positions >= length
    masked, and below ``kstart`` (B,). ``fused`` runs the flash chunk
    kernel (B11); the plain branch is the JAX composition, op for op,
    which is B11's plain version. The JAX branch for ``kstart=None``
    decode (kernel B7) serves dense ``generate`` only and is not
    ported."""
    attn = (_sf.flash_chunk_attention if fused
            else _sf.flash_chunk_attention_plain)
    return attn(q, ck, cv, length, kstart, k_rows=k_rows, v_rows=v_rows)


def _block_infer(x, lp, cache: Dict, l: int, pos: int, cos, sin,
                 cfg: LlamaConfig, rpos, kstart, fused=False):
    """One decoder layer over T tokens written at cache index ``pos``
    (layer ``l`` of the dense ``cache``, updated in place); ``rpos``
    (B, T) are their rope positions, ``kstart`` (B,) the first valid
    cache column."""
    B, T, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    h1 = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q = (h1 @ lp["wq"]).reshape(B, T, nh, hd)
    k = (h1 @ lp["wk"]).reshape(B, T, nkv, hd)
    v = (h1 @ lp["wv"]).reshape(B, T, nkv, hd)
    q = _rope_rows(q, cos, sin, rpos)
    k = _rope_rows(k, cos, sin, rpos)
    quant = "ks" in cache
    for name, rows in _kv_rows(k, v, quant).items():
        cache[name][l, :, pos:pos + T] = rows.to(cache[name].dtype)
    o = _attn_with_cache(q, cache["k"][l], cache["v"][l], pos + T,
                         kstart=kstart,
                         k_rows=cache["ks"][l] if quant else None,
                         v_rows=cache["vs"][l] if quant else None,
                         fused=fused)
    x = x + o.reshape(B, T, nh * hd) @ lp["wo"]
    return _mlp(x, lp, cfg)


def _forward_cached(params, tokens, cache: Dict, pos: int,
                    cfg: LlamaConfig, max_len: int, rpos, kstart,
                    logits_at: Optional[int] = None, fused=False):
    """tokens (B, T) at cache positions [pos, pos+T) -> logits (B, V)
    f32 at row ``logits_at`` (default the last row); ``cache`` is
    updated in place."""
    x = params["embed"][tokens.long()].to(cfg.dtype)
    cos, sin = rope_tables(max_len, cfg.hd, cfg.rope_theta,
                           device=x.device)
    for l in range(cfg.num_layers):
        x = _block_infer(x, layer_params(params, l), cache, l, pos, cos,
                         sin, cfg, rpos=rpos, kstart=kstart, fused=fused)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if logits_at is not None:
        idx = min(max(int(logits_at), 0), x.shape[1] - 1)
        x = x[:, idx:idx + 1]
    return (x[:, -1] @ _lm_head(params, cfg, x.dtype)).float()


def paged_prefill_chunk(params, tokens: torch.Tensor, paged: Dict,
                        block_table: torch.Tensor, cfg: LlamaConfig, *,
                        ctx_cap: int, ctx_len: int, chunk_len: int,
                        fused: bool = False):
    """Prefill ONE chunk of a request's prompt against the KV already in
    its pages (chunked prefill and the prefix-cache continuation).

    tokens:      (1, C) int chunk, RIGHT-padded past ``chunk_len``
    paged:       :func:`init_paged_cache` pools (int8 tier included)
    block_table: (ppseq,) int — the slot's page ids, logical order
    ctx_cap:     page multiple >= ctx_len, the gathered-context width
    ctx_len:     tokens already in the slot's pages
    chunk_len:   valid tokens in this chunk
    returns (logits (1, V) at the chunk's last valid token, ``paged``
    with the chunk's rows written in place).

    The slot's first ``ctx_len`` rows are gathered from its pages and
    RIGHT-ALIGNED into a ``(1, ctx_cap + C)`` dense temp cache (garbage
    below masked by ``kstart``), the chunk forwards at temp positions
    ``[ctx_cap, ctx_cap + C)`` with rope positions ``ctx_len + i``, and
    the new rows scatter into the slot's pages (pad rows go to the trash
    page). ``fused`` runs the chunk's attention through the flash chunk
    kernel (B11)."""
    B, C = tokens.shape
    if B != 1:
        raise ValueError(
            f"paged_prefill_chunk: one request at a time (got batch {B})")
    page = paged["k"].shape[2]
    if ctx_cap % page:
        raise ValueError(
            f"paged_prefill_chunk: ctx_cap={ctx_cap} must be a multiple "
            f"of the page size {page}")
    dev = paged["k"].device
    ext = block_table.shape[0] * page
    quant = "ks" in paged
    W = ctx_cap + C
    ctx_len, chunk_len = int(ctx_len), int(chunk_len)
    pad = ctx_cap - ctx_len                       # garbage rows below
    dense = init_cache(cfg, 1, W, kv_dtype="int8" if quant else None,
                       device=dev)
    block_table = block_table.to(device=dev, dtype=torch.long)
    if ctx_cap:
        ppc = ctx_cap // page
        ctx_tbl = block_table[:ppc]
        srows = torch.clamp(torch.arange(ctx_cap, device=dev) - pad, 0,
                            ctx_cap - 1)
        for name in paged:
            g = paged[name][:, ctx_tbl]                # (L, ppc, pg, ...)
            g = g.reshape((g.shape[0], ppc * page) + tuple(g.shape[3:]))
            dense[name][:, 0, :ctx_cap] = g[:, srows].to(dense[name].dtype)
    kstart = torch.tensor([pad], dtype=torch.int32, device=dev)
    rpos = (ctx_len + torch.arange(C, device=dev))[None, :]
    logits = _forward_cached(params, tokens.to(dev), dense, ctx_cap, cfg,
                             W, rpos=rpos, kstart=kstart,
                             logits_at=chunk_len - 1, fused=bool(fused))
    pos = torch.arange(C, device=dev)
    logical = torch.clamp(ctx_len + pos, 0, ext - 1)
    dst = torch.where(pos < chunk_len,
                      block_table[logical // page] * page + logical % page,
                      0)
    for name in paged:
        _scatter_rows(paged[name], dst, dense[name][:, 0, ctx_cap:])
    return logits, paged


def paged_decode_forward(params, tokens: torch.Tensor, paged: Dict,
                         block_tables: torch.Tensor, lengths: torch.Tensor,
                         cfg: LlamaConfig, *, active=None,
                         fused: bool = False):
    """One continuous-batching decode step over the ragged batch.

    tokens:       (B,) int — each slot's previous token
    block_tables: (B, ppseq) int page ids per slot
    lengths:      (B,) valid lengths; the new token's KV lands at
                  position ``lengths`` and attention sees ``lengths+1``
    active:       (B,) bool — inactive slots still compute, their KV
                  writes go to the trash page and their logits are
                  garbage to be ignored
    returns (logits (B, V) f32, ``paged`` updated in place).

    Attention runs through the paged decode kernel (B9) or, with
    ``fused``, the fused RoPE + paged decode kernel (B10), which takes q
    unrotated with its per-row cos/sin rows."""
    fused = bool(fused)
    dev = paged["k"].device
    B = tokens.shape[0]
    page = paged["k"].shape[2]
    ext = block_tables.shape[1] * page
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    quant = "ks" in paged
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    active = active.to(dev)
    lengths = lengths.to(device=dev, dtype=torch.int32)
    block_tables = block_tables.to(device=dev, dtype=torch.int32)
    cos, sin = rope_tables(ext, hd, cfg.rope_theta, device=dev)
    lpos = lengths.long()
    rpos = lpos[:, None]                             # (B, 1)
    if fused:
        # per-row rope rows for the in-kernel rotation
        cos_row, sin_row = cos[lpos], sin[lpos]      # (B, hd/2)
    # per-row destination slot; inactive rows dump into the trash page
    row = torch.arange(B, device=dev)
    dst = torch.where(active,
                      block_tables[row, lpos // page].long() * page
                      + lpos % page, 0)
    x = params["embed"][tokens.to(dev).long()][:, None].to(cfg.dtype)
    ksp = vsp = None
    for l in range(cfg.num_layers):
        lp = layer_params(params, l)
        h1 = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q = (h1 @ lp["wq"]).reshape(B, 1, nh, hd)
        k = (h1 @ lp["wk"]).reshape(B, 1, nkv, hd)
        v = (h1 @ lp["wv"]).reshape(B, 1, nkv, hd)
        if not fused:
            q = _rope_rows(q, cos, sin, rpos)
        k = _rope_rows(k, cos, sin, rpos)
        for name, rows in _kv_rows(k[:, 0], v[:, 0], quant).items():
            _scatter_rows(paged[name][l:l + 1], dst, rows[None])
        kp, vp = paged["k"][l], paged["v"][l]
        if quant:
            ksp, vsp = paged["ks"][l], paged["vs"][l]
        if fused:
            o = _sf.fused_paged_decode_attention(
                q[:, 0], cos_row, sin_row, kp, vp, block_tables,
                lengths + 1, ks_pages=ksp, vs_pages=vsp)
        else:
            o = _pa.paged_attention(
                q[:, 0], kp, vp, block_tables, lengths + 1,
                ks_pages=ksp, vs_pages=vsp)
        x = x + o.reshape(B, 1, nh * hd) @ lp["wo"]
        x = _mlp(x, lp, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = (x[:, -1] @ _lm_head(params, cfg, x.dtype)).float()
    return logits, paged
