"""The serving forwards: paged prefill chunk, ragged paged decode and
the speculative verify.

Counterpart of ``paddle_tpu/models/generate.py``, ported as far as the
continuous-batching engine runs it: the dense and paged cache makers,
the layer body with its attention, the chunked-prefill program, the
one-token decode step, the batched speculative verify (linear and
token-tree), the tree commit and the truncated-layer draft model. The
JAX package's ``lax.scan`` over the stacked layer axis is a Python loop
over layer slices here.

JAX donates the page pools and gets them back updated; the port writes
the pools IN PLACE (index assignment into the ``(L, P, page, ...)``
tensors) and returns the same dict, so a GB-scale pool is never copied.
The dense temp cache of a prefill chunk is likewise filled in place.

Options of the JAX signatures that the port leaves out (tensor and
data parallelism, MoE, adapters, quantized weights) are not taken;
ROADMAP.md lists them in porting order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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
                     v_rows=None, fused=False, tree_mask=None):
    """q (B,T,nh,hd) vs cache (B,Smax,nkv,hd); positions >= length
    masked, and below ``kstart`` (B,). ``fused`` runs the flash chunk
    kernel (B11); the plain branch is the JAX composition, op for op,
    which is B11's plain version. ``tree_mask`` (B, T, T) bool: the T
    chunk lanes are token-tree nodes and the ancestor-or-self matrix
    replaces the in-chunk causal triangle (B11-tree when fused); it
    needs the verify layout, the chunk being the cache's last T rows.
    The JAX branch for ``kstart=None`` decode (kernel B7) serves dense
    ``generate`` only and is not ported."""
    if tree_mask is not None and int(length) != ck.shape[1]:
        raise ValueError(
            "_attn_with_cache: tree_mask requires the verify layout — "
            f"static length ({length}) == Smax ({ck.shape[1]})")
    attn = (_sf.flash_chunk_attention if fused
            else _sf.flash_chunk_attention_plain)
    return attn(q, ck, cv, length, kstart, k_rows=k_rows, v_rows=v_rows,
                tree_mask=tree_mask)


def _block_infer(x, lp, cache: Dict, l: int, pos: int, cos, sin,
                 cfg: LlamaConfig, rpos, kstart, fused=False,
                 tree_mask=None):
    """One decoder layer over T tokens written at cache index ``pos``
    (layer ``l`` of the dense ``cache``, updated in place); ``rpos``
    (B, T) are their rope positions, ``kstart`` (B,) the first valid
    cache column, ``tree_mask`` an optional (B, T, T) ancestor matrix
    (:func:`_attn_with_cache`)."""
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
                         fused=fused, tree_mask=tree_mask)
    x = x + o.reshape(B, T, nh * hd) @ lp["wo"]
    return _mlp(x, lp, cfg)


def _forward_cached(params, tokens, cache: Dict, pos: int,
                    cfg: LlamaConfig, max_len: int, rpos, kstart,
                    logits_at: Optional[int] = None, fused=False,
                    logits_all: bool = False, tree_mask=None):
    """tokens (B, T) at cache positions [pos, pos+T) -> logits (B, V)
    f32 at row ``logits_at`` (default the last row), or (B, T, V) at
    every row with ``logits_all`` (the verify's targets); ``cache`` is
    updated in place. ``tree_mask``: see :func:`_attn_with_cache`."""
    x = params["embed"][tokens.long()].to(cfg.dtype)
    cos, sin = rope_tables(max_len, cfg.hd, cfg.rope_theta,
                           device=x.device)
    for l in range(cfg.num_layers):
        x = _block_infer(x, layer_params(params, l), cache, l, pos, cos,
                         sin, cfg, rpos=rpos, kstart=kstart, fused=fused,
                         tree_mask=tree_mask)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if logits_all:
        return (x @ _lm_head(params, cfg, x.dtype)).float()
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


def _slot_ids(block_tables: torch.Tensor, pos: torch.Tensor,
              page: int) -> torch.Tensor:
    """Flat pool slot ids (page * page_size + offset) of the logical
    positions ``pos`` (B, N) of each row's block table."""
    row = torch.arange(pos.shape[0], device=pos.device)[:, None]
    return block_tables[row, pos // page].long() * page + pos % page


def paged_verify_forward(params, tokens: torch.Tensor, paged: Dict,
                         block_tables: torch.Tensor, lengths: torch.Tensor,
                         cfg: LlamaConfig, *, ctx_cap: int, active=None,
                         fused: bool = False, tree_depth=None,
                         tree_mask=None):
    """Batched speculative VERIFY: score a ``T``-token chunk of EVERY
    row against its paged KV in one forward — the batched form of
    :func:`paged_prefill_chunk`.

    tokens:       (B, T) int — per row ``[last token, draft_1, ...]``
                  (rows with fewer drafts right-pad; the pad lanes are
                  causally after every real one)
    block_tables: (B, ppseq) int page ids per slot
    lengths:      (B,) tokens already committed in each row's pages
                  (the chunk lands at ``lengths + i``), <= ``ctx_cap``
    ctx_cap:      page multiple >= max(lengths): the gathered context
                  width (the engine buckets it to power-of-two pages)
    active:       (B,) bool — inactive rows compute, their KV writes go
                  to the trash page
    returns (logits (B, T, V) f32 at every chunk position, ``paged``
    with the T new rows of every row written in place).

    Each row's context is gathered from its pages and RIGHT-ALIGNED into
    a ``(B, ctx_cap + T)`` dense temp cache (``kstart = ctx_cap -
    lengths`` masks the pad rows below), the chunk forwards at temp
    positions ``[ctx_cap, ctx_cap + T)`` with rope positions
    ``lengths + i``, and the new rows scatter into each row's pages.
    Rejected drafts need no rollback: the caller advances ``lengths``
    past the accepted prefix only, and later writes overwrite the rest.

    TREE mode (``tree_depth`` (B, T) per-node depths, root 0, and
    ``tree_mask`` (B, T, T) ancestor-or-self matrices): the lanes are
    token-tree nodes, rope positions are ``lengths + depth`` and the
    ancestor matrix replaces the in-chunk causal triangle, so
    ``logits[r, i]`` scores node i against exactly its root path.
    Same-depth nodes would share a page slot, so tree mode places
    nothing: it returns ``(logits, rows)`` with ``rows[name]`` the
    (L, B, T, ...) per-node new KV rows, for :func:`paged_tree_commit`.
    """
    B, T = tokens.shape
    tree = tree_depth is not None
    if tree != (tree_mask is not None):
        raise ValueError("paged_verify_forward: tree_depth requires "
                         "tree_mask (and vice versa)")
    page = paged["k"].shape[2]
    if ctx_cap % page:
        raise ValueError(
            f"paged_verify_forward: ctx_cap={ctx_cap} must be a multiple "
            f"of the page size {page}")
    dev = paged["k"].device
    ext = block_tables.shape[1] * page
    quant = "ks" in paged
    W = ctx_cap + T
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    active = torch.as_tensor(active).to(dev)
    block_tables = block_tables.to(device=dev, dtype=torch.long)
    lengths = torch.clamp(lengths.to(device=dev, dtype=torch.long), 0,
                          ctx_cap)
    pad = ctx_cap - lengths                               # (B,)
    dense = init_cache(cfg, B, W, kv_dtype="int8" if quant else None,
                       device=dev)
    if ctx_cap:
        srows = torch.clamp(torch.arange(ctx_cap, device=dev)[None, :]
                            - pad[:, None], 0, ctx_cap - 1)
        src = _slot_ids(block_tables, srows, page)        # (B, ctx_cap)
        for name in paged:
            pool = paged[name]
            flat = pool.view((pool.shape[0], pool.shape[1] * page)
                             + tuple(pool.shape[3:]))
            dense[name][:, :, :ctx_cap] = flat[:, src]
    if tree:
        rpos = lengths[:, None] + torch.as_tensor(tree_depth).to(
            device=dev, dtype=torch.long)
        tree_mask = torch.as_tensor(tree_mask).to(dev).bool()
    else:
        rpos = lengths[:, None] + torch.arange(T, device=dev)[None, :]
    logits = _forward_cached(params, tokens.to(dev), dense, ctx_cap, cfg,
                             W, rpos=rpos, kstart=pad.to(torch.int32),
                             fused=bool(fused), logits_all=True,
                             tree_mask=tree_mask if tree else None)
    if tree:
        # no placement: same-depth nodes share a page slot, so the rows
        # wait for the host's accepted root path (paged_tree_commit)
        return logits, {name: dense[name][:, :, ctx_cap:].contiguous()
                        for name in paged}
    ok = active[:, None] & (rpos < ext)
    dst = torch.where(ok, _slot_ids(block_tables,
                                    torch.clamp(rpos, 0, ext - 1), page),
                      0).reshape(-1)                      # (B*T,)
    for name in paged:
        rows = dense[name][:, :, ctx_cap:]                # (L, B, T, ...)
        _scatter_rows(paged[name], dst,
                      rows.reshape((rows.shape[0], B * T)
                                   + tuple(rows.shape[3:])))
    return logits, paged


def paged_tree_commit(paged: Dict, rows: Dict, block_tables: torch.Tensor,
                      lengths: torch.Tensor, path_nodes: torch.Tensor,
                      path_len: torch.Tensor) -> Dict:
    """Place the ACCEPTED root path of a tree verify into the pools, in
    place — the deferred second half of :func:`paged_verify_forward`'s
    tree mode.

    rows:       per-node new KV rows, ``rows[name]`` (L, B, T, ...)
    path_nodes: (B, T) node indices of each row's accepted root path in
                commit order (entry 0 the root, placed at ``lengths``);
                entries past ``path_len`` are don't-care
    path_len:   (B,) committed node count (accepted + 1; 0 for rows
                that commit nothing, whose nodes go to the trash page)

    Pure data movement: the pools end up bit-identical to what a linear
    verify of the accepted path would have written, and unaccepted
    nodes are never placed."""
    some = next(iter(rows.values()))
    B, T = some.shape[1], some.shape[2]
    dev = some.device
    page = paged["k"].shape[2]
    ext = block_tables.shape[1] * page
    block_tables = block_tables.to(device=dev, dtype=torch.long)
    path_nodes = torch.clamp(torch.as_tensor(path_nodes).to(
        device=dev, dtype=torch.long), 0, T - 1)
    path_len = torch.as_tensor(path_len).to(device=dev, dtype=torch.long)
    d = torch.arange(T, device=dev)[None, :]
    pos = torch.as_tensor(lengths).to(device=dev,
                                      dtype=torch.long)[:, None] + d
    ok = (d < path_len[:, None]) & (pos < ext)
    dst = torch.where(ok, _slot_ids(block_tables,
                                    torch.clamp(pos, 0, ext - 1), page),
                      0).reshape(-1)
    row = torch.arange(B, device=dev)[:, None]
    for name, r in rows.items():
        r = r[:, row, path_nodes]                         # path order
        _scatter_rows(paged[name], dst,
                      r.reshape((r.shape[0], B * T) + tuple(r.shape[3:])))
    return paged


def make_draft_params(params, cfg: LlamaConfig,
                      n_layers: int) -> Tuple[Dict, LlamaConfig]:
    """The truncated-layer, shared-embedding DRAFT model: the first
    ``n_layers`` decoder layers of the target with its embedding, final
    norm and head. Every leaf is the target's own storage (the layer
    stacks are views ``[:n_layers]``), so the draft costs no weight
    memory. Returns ``(draft_params, draft_cfg)``, a smaller Llama that
    every forward of this module takes."""
    L = next(iter(params["layers"].values())).shape[0]
    if not 1 <= n_layers < L:
        raise ValueError(
            f"make_draft_params: n_layers must be in [1, {L}), got "
            f"{n_layers} (the draft must be a strict truncation)")
    draft = {k: v for k, v in params.items() if k != "layers"}
    draft["layers"] = {k: v[:n_layers] for k, v in params["layers"].items()}
    return draft, dataclasses.replace(cfg, num_layers=n_layers)


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
