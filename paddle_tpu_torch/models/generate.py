"""The serving forwards: dense ``generate``, ``beam_search`` and
``precompute_prompt_cache``, weight-only quantization, the paged prefill
chunk, ragged paged decode and the speculative verify.

Counterpart of ``paddle_tpu/models/generate.py``, ported as far as the
dense decoding path and the continuous-batching engine run it: the dense
and paged cache makers, ``quantize_weights`` / ``_w`` (int8 per output
channel, int4 per group of input rows), the layer body with its
attention (one-token decode steps through kernel B7), the cached
forward, dense ``generate`` (greedy, temperature, top-k, top-p, EOS,
left-padded ragged prompts, int8 KV, a shared prompt cache) and
``beam_search``, the chunked-prefill program, the one-token paged decode
step, the batched speculative verify (linear and token-tree), the tree
commit and the truncated-layer draft model. The JAX package's
``lax.scan`` over the stacked layer axis, and over the decode steps, is
a Python loop here.

JAX donates the caches and page pools and gets them back updated; the
port writes them IN PLACE (index assignment into the ``(L, B, S, ...)``
cache and the ``(L, P, page, ...)`` pools) and returns the same dict, so
a GB-scale cache is never copied. ``beam_search`` gathers the winning
beams' cache rows into a new cache each step, as the JAX package does.

The paged forwards take the adapter pool's multi-LoRA term
(``adapters=`` / ``adapter_slots=``, :func:`_lora_delta`): the q and o
projections of every row add ``(x @ A_i) @ B_i * alpha/r`` of its slot's
factors; slot 0's are exact zeros, and ``adapters=None`` leaves the term
out.

An MoE config (``cfg.moe``) swaps every layer's MLP for the serving
expert FFN :func:`_moe_ffn` in all of these forwards. Options of the
JAX signatures that the port leaves out (tensor, data and expert
parallelism, the trace-time observability hooks) are not taken;
ROADMAP.md lists them in porting order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..observability import hooks as _obs
from ..ops.kernels import fused as _fz
from ..ops.kernels import paged_attention as _pa
from ..ops.kernels import serving_fused as _sf
from .llama import (LlamaConfig, _lm_head, _mlp, _w, apply_rope,
                    layer_params, rms_norm, rope_tables)


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


def quantize_weights(params, cfg: LlamaConfig, bits: int = 8,
                     group_size: int = 128) -> Dict:
    """Weight-only quantization for serving, the JAX package's
    ``quantize_weights``: each projection of every layer (``wq`` ...
    ``wd``), and ``lm_head`` when the embeddings are untied, becomes
    quantized values beside a ``name + "_scale"`` f32 leaf, which
    :func:`~.llama._w` dequantizes at every use; the embedding and the
    norms stay as they are, and so do an MoE tree's router and expert
    stacks (``moe_*``), in place of the dense ``wg``/``wu``/``wd``.

    ``bits=8``: per-output-channel symmetric int8, ``w ~= q *
    scale[None, :]``, scale ``(L, out)``. ``bits=4``: per-group
    symmetric int4 over ``group_size`` input rows (one group over the
    whole input dim where it does not divide), scale ``(L, G, out)``.
    The int4 values in [-7, 7] are held in int8 tensors, as torch has
    no 4-bit dtype with arithmetic: twice the JAX package's ``jnp.int4``
    weight bytes. Layers are quantized one at a time, so the f32
    temporaries never hold a whole stack."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def q8(w):
        wf = w.float()
        scale = torch.clamp_min(torch.amax(torch.abs(wf), dim=0) / 127.0,
                                1e-8)
        qw = torch.clamp(torch.round(wf / scale[None, :]), -127, 127)
        return qw.to(torch.int8), scale

    def q4(w):
        din, dout = w.shape
        g = min(group_size, din)
        if din % g:
            g = din                 # serving widths are multiples of 128
        wf = w.float().reshape(din // g, g, dout)
        scale = torch.clamp_min(torch.amax(torch.abs(wf), dim=1) / 7.0,
                                1e-8)                       # (G, out)
        qw = torch.clamp(torch.round(wf / scale[:, None, :]), -7, 7)
        return qw.reshape(din, dout).to(torch.int8), scale

    q = q4 if bits == 4 else q8

    def stack(w):
        """``q`` over the stacked layer axis (the JAX ``vmap``)."""
        qs, scales = zip(*(q(w[l]) for l in range(w.shape[0])))
        return torch.stack(qs), torch.stack(scales)

    out = dict(params)
    layers = dict(params["layers"])
    for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
        if name in layers:          # MoE trees: moe_* stacks stay as given
            layers[name], layers[name + "_scale"] = stack(layers[name])
    out["layers"] = layers
    if not cfg.tie_embeddings and "lm_head" in params:
        out["lm_head"], out["lm_head_scale"] = q(params["lm_head"])
    return out


def _use_decode_kernel(x: torch.Tensor, override=None) -> bool:
    """Whether a one-token, ``kstart``-free attention goes to
    :func:`~..ops.kernels.fused.decode_attention` (B7) — the JAX gate
    ``_use_decode_kernel`` with "on a TPU" read as "on CUDA tensors":
    ``None`` takes it (the kernel for CUDA tensors, its plain version,
    the same composition op for op, for CPU ones), ``False`` the plain
    composition, and ``True`` raises for CPU tensors, as the kernel has
    no interpret mode."""
    if override is None:
        return True
    if override and x.device.type != "cuda":
        raise ValueError(
            f"use_kernel=True: decode kernel B7 runs on CUDA tensors only "
            f"(got {x.device}); pass use_kernel=None or False")
    return bool(override)


def _attn_with_cache(q, ck, cv, length: int, kstart=None, k_rows=None,
                     v_rows=None, fused=False, tree_mask=None,
                     lengths=None):
    """q (B,T,nh,hd) vs cache (B,Smax,nkv,hd); positions >= length
    masked, and below ``kstart`` (B,) when given (left-padded rows, the
    prefill and verify temp caches). With ``lengths`` (the (B,) int32
    tensor of ``length`` on q's device, which :func:`_forward_cached`
    builds for a one-token step without ``kstart`` that
    :func:`_use_decode_kernel` sends to the kernel) the step runs
    decode kernel B7. ``fused`` runs the flash chunk kernel
    (B11) for chunks with ``kstart``; the plain branch is the JAX
    composition, op for op, which is B11's plain version.
    ``tree_mask`` (B, T, T) bool: the T chunk lanes are token-tree nodes
    and the ancestor-or-self matrix replaces the in-chunk causal
    triangle (B11-tree when fused); it needs the verify layout, the
    chunk being the cache's last T rows."""
    if lengths is not None:
        return _fz.decode_attention(q[:, 0], ck, cv, lengths, k_rows=k_rows,
                                    v_rows=v_rows)[:, None]
    if tree_mask is not None and int(length) != ck.shape[1]:
        raise ValueError(
            "_attn_with_cache: tree_mask requires the verify layout — "
            f"static length ({length}) == Smax ({ck.shape[1]})")
    attn = (_sf.flash_chunk_attention if fused and kstart is not None
            else _sf.flash_chunk_attention_plain)
    return attn(q, ck, cv, length, kstart, k_rows=k_rows, v_rows=v_rows,
                tree_mask=tree_mask)


def _lora_delta(x, a, b, scale):
    """Per-row batched LoRA term, the JAX ``_lora_delta`` on factors
    already gathered per row: ``(x @ A_i) @ B_i * alpha/r`` with ``x``
    (B, T, in), ``a`` (B, in, r), ``b`` (B, r, out) and ``scale`` (B,)
    the per-row alpha/r, all in the model dtype. Slot 0 holds exact
    zeros (the base model), so a base row's term is an exact zero."""
    return torch.bmm(torch.bmm(x, a), b) * scale[:, None, None]


def _adapter_prep(adapters, adapter_slots, cfg: LlamaConfig):
    """Per-forward adapter setup: every row's factors of every layer,
    ``(L, B, ...)``, gathered out of the pool at once (4 gathers a
    forward, where the JAX scan gathers 4 a layer: the same values;
    chip_smoke.py's phase 3i times both), and the per-row alpha/r in
    the model dtype. Returns a function of the layer index giving that
    layer's ``(a_q, b_q, a_o, b_o, scale)`` for :func:`_lora_delta`, or
    None without ``adapters``."""
    if adapters is None:
        return None
    dev = adapters["scale"].device
    aslot = adapter_slots.to(device=dev, dtype=torch.long).reshape(-1)
    asc = adapters["scale"].index_select(0, aslot).to(cfg.dtype)
    rows = [adapters[n].index_select(1, aslot)
            for n in ("aq", "bq", "ao", "bo")]
    return lambda l: tuple(r[l] for r in rows) + (asc,)


def _moe_ffn(x, lp, cfg: LlamaConfig):
    """Serving MoE FFN on one device, the JAX ``_moe_ffn`` with no mesh:
    x (B, T, H) already normalised; ``lp`` carries the layer's f32
    router ``moe_gate`` (H, E) and expert stacks ``moe_wg`` / ``moe_wu``
    (E, H, i) and ``moe_wd`` (E, i, H).

    Routing is capacity-DROPLESS, unlike the training router: the top
    ``top_k`` of the f32 router logits (a descending stable sort, so a
    tie keeps the lower expert first, as ``lax.top_k``), softmax over the
    k selected logits, and the combine ``y = sum_j w_j * out_j`` over the
    k slots in slot order in f32, cast once to the model dtype.

    The JAX package applies each routed item's expert by gathering that
    expert's matrices per item (``(n, H, i)`` a projection: 11.8 GB at a
    256-token chunk of a 2048 x 5632, 16-expert model). The port computes
    the same function grouped by expert and gathers no matrix: the items
    are ordered by expert (one stable argsort, one gather of token rows),
    each expert with items runs its SwiGLU over its contiguous run of
    rows (three products, SiLU in f32), and one scatter puts the outputs
    back in item order. The run lengths are read on the host, once a
    layer: that read waits for the card, so an MoE forward is not
    fence-free as a dense one is."""
    B, T, H = x.shape
    k = cfg.moe.top_k
    dt = x.dtype
    gate = lp["moe_gate"].float()                        # (H, E)
    wg, wu, wd = lp["moe_wg"], lp["moe_wu"], lp["moe_wd"]
    N = B * T
    xf = x.reshape(N, H)
    logits = xf.float() @ gate                           # (N, E)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    w = torch.softmax(vals[:, :k], dim=-1)               # (N, k) f32
    items_e = idx[:, :k].reshape(-1)                     # (N * k,)
    order = torch.argsort(items_e, stable=True)
    counts = torch.bincount(items_e, minlength=gate.shape[-1]).tolist()
    xs = xf[order // k]                                  # rows by expert
    outs, off = [], 0
    for e, c in enumerate(counts):
        if c:
            xe = xs[off:off + c]
            g = F.silu((xe @ wg[e]).float()).to(dt)
            outs.append((g * (xe @ wu[e])) @ wd[e])
            off += c
    items_out = torch.empty_like(xs).index_copy_(0, order, torch.cat(outs))
    y = torch.sum(items_out.reshape(N, k, H).float() * w[:, :, None], dim=1)
    return y.to(dt).reshape(B, T, H)


def _ffn(x, lp, cfg: LlamaConfig):
    """The layer after the attention residual: the dense SwiGLU MLP
    (:func:`~.llama._mlp`, weights through ``_w``) or, for an MoE config,
    the RMSNorm and :func:`_moe_ffn`, each with its residual."""
    if cfg.moe is None:
        return _mlp(x, lp, cfg)
    return x + _moe_ffn(rms_norm(x, lp["mlp_norm"], cfg.rms_eps), lp, cfg)


def _block_infer(x, lp, cache: Dict, l: int, pos: int, cos, sin,
                 cfg: LlamaConfig, rpos=None, kstart=None, fused=False,
                 tree_mask=None, lengths=None, ad=None):
    """One decoder layer over T tokens written at cache index ``pos``
    (layer ``l`` of the dense ``cache``, updated in place). ``rpos``
    (B, T) are their rope positions where they differ from the cache
    index (left-padded rows, the temp caches; None rotates at ``pos +
    t``), ``kstart`` (B,) the first valid cache column, ``tree_mask`` an
    optional (B, T, T) ancestor matrix and ``lengths`` decode kernel
    B7's (B,) length tensor (:func:`_attn_with_cache`). Every weight goes
    through :func:`~.llama._w`, so quantized weights dequantize here.
    ``ad``: this layer's adapter factors (:func:`_adapter_prep`), whose
    term the q and o projections add."""
    B, T, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    h1 = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q = h1 @ _w(lp, "wq", x.dtype)
    if ad is not None:
        q = q + _lora_delta(h1, ad[0], ad[1], ad[4])
    q = q.reshape(B, T, nh, hd)
    k = (h1 @ _w(lp, "wk", x.dtype)).reshape(B, T, nkv, hd)
    v = (h1 @ _w(lp, "wv", x.dtype)).reshape(B, T, nkv, hd)
    if rpos is None:
        c, s = cos[pos:pos + T], sin[pos:pos + T]
        q, k = apply_rope(q, c, s), apply_rope(k, c, s)
    else:
        q = _rope_rows(q, cos, sin, rpos)
        k = _rope_rows(k, cos, sin, rpos)
    quant = "ks" in cache
    for name, rows in _kv_rows(k, v, quant).items():
        cache[name][l, :, pos:pos + T] = rows.to(cache[name].dtype)
    o = _attn_with_cache(q, cache["k"][l], cache["v"][l], pos + T,
                         kstart=kstart,
                         k_rows=cache["ks"][l] if quant else None,
                         v_rows=cache["vs"][l] if quant else None,
                         fused=fused, tree_mask=tree_mask, lengths=lengths)
    o = o.reshape(B, T, nh * hd)
    ow = o @ _w(lp, "wo", x.dtype)
    if ad is not None:
        ow = ow + _lora_delta(o, ad[2], ad[3], ad[4])
    return _ffn(x + ow, lp, cfg)


def _forward_cached(params, tokens, cache: Dict, pos: int,
                    cfg: LlamaConfig, max_len: int, rpos=None, kstart=None,
                    logits_at: Optional[int] = None, fused=False,
                    logits_all: bool = False, tree_mask=None,
                    use_kernel=None, adapters=None, adapter_slots=None):
    """tokens (B, T) at cache positions [pos, pos+T) -> logits (B, V)
    f32 at row ``logits_at`` (default the last row), or (B, T, V) at
    every row with ``logits_all`` (the verify's targets); ``cache`` is
    updated in place. ``rpos``, ``kstart``, ``tree_mask``: see
    :func:`_block_infer`. A one-token forward without ``kstart`` runs
    decode kernel B7 unless ``use_kernel`` is False
    (:func:`_use_decode_kernel`), on one (B,) length tensor built here,
    on the device, for every layer. ``adapters`` / ``adapter_slots``:
    the adapter pool's tensors and the (B,) slot of each row
    (:func:`paged_decode_forward`)."""
    x = params["embed"][tokens.long()].to(cfg.dtype)
    cos, sin = rope_tables(max_len, cfg.hd, cfg.rope_theta,
                           device=x.device)
    B, T = tokens.shape
    lengths = None
    if T == 1 and kstart is None and _use_decode_kernel(x, use_kernel):
        lengths = torch.full((B,), pos + 1, dtype=torch.int32,
                             device=x.device)
    ad = _adapter_prep(adapters, adapter_slots, cfg)
    for l in range(cfg.num_layers):
        x = _block_infer(x, layer_params(params, l), cache, l, pos, cos,
                         sin, cfg, rpos=rpos, kstart=kstart, fused=fused,
                         tree_mask=tree_mask, lengths=lengths,
                         ad=None if ad is None else ad(l))
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if logits_all:
        return (x @ _lm_head(params, cfg, x.dtype)).float()
    if logits_at is not None:
        idx = min(max(int(logits_at), 0), x.shape[1] - 1)
        x = x[:, idx:idx + 1]
    return (x[:, -1] @ _lm_head(params, cfg, x.dtype)).float()


def precompute_prompt_cache(params, prefix, cfg: LlamaConfig, *,
                            kv_cache_dtype=None) -> Dict:
    """Prefill a SHARED prompt prefix once and return its KV state for
    ``generate(prompt_cache=...)``, which then skips re-prefilling the
    prefix for every request.

    ``prefix``: (P,) or (1, P) int token ids (tensor or array). The
    prefix KV is stored at exactly P positions — the consumer's own cache
    provides the capacity for its prompt and new tokens.
    ``kv_cache_dtype`` must match the consumer's (int8 prefixes feed
    int8 decode caches). Runs on the params' device."""
    dev = params["embed"].device
    prefix = torch.as_tensor(prefix).to(device=dev, dtype=torch.int32)
    if prefix.dim() == 1:
        prefix = prefix[None, :]
    if prefix.shape[0] != 1:
        raise ValueError(
            "precompute_prompt_cache: the shared prefix is one sequence "
            f"(got batch {prefix.shape[0]}); it is broadcast across the "
            "request batch at generate() time")
    P = prefix.shape[1]
    cache = init_cache(cfg, 1, P, kv_dtype=kv_cache_dtype, device=dev)
    _forward_cached(params, prefix, cache, 0, cfg, P)
    return {"cache": cache, "len": P}


def _pad_starts(prompt: torch.Tensor, pad_token_id, prompt_lengths):
    """(B,) first real column of each LEFT-padded row, or None: from
    ``prompt_lengths`` (clipped to [0, S-1]), else the length of the
    leading run of ``pad_token_id`` (an all-pad row keeps its last
    slot)."""
    S = prompt.shape[1]
    if prompt_lengths is not None:
        lens = torch.as_tensor(prompt_lengths).to(device=prompt.device,
                                                  dtype=torch.int32)
        return torch.clamp(S - lens, 0, S - 1)
    if pad_token_id is None:
        return None
    real = prompt != pad_token_id
    kstart = torch.argmax(real.int(), dim=1).to(torch.int32)
    return torch.where(real.any(dim=1), kstart,
                       torch.full_like(kstart, S - 1))


def _sample(logits, temperature: float, top_k: int, top_p: float,
            generator: torch.Generator) -> torch.Tensor:
    """The JAX ``generate``'s ``sample``: greedy ``argmax`` at
    temperature 0 (the first index on ties, as ``jnp.argmax``); else
    logits / temperature, filtered by top-k and the nucleus rule in one
    descending stable sort (``jnp.argsort`` is stable) when ``top_p`` is
    set, or by the k-th largest value for top-k alone, then one draw
    from ``generator``. The draws differ from ``jax.random``'s."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lg = logits / temperature
    if top_p > 0.0:
        order = torch.argsort(-lg, dim=-1, stable=True)
        ls = torch.gather(lg, -1, order)
        keep_sorted = torch.ones_like(ls, dtype=torch.bool)
        if top_k > 0:
            keep_sorted &= (torch.arange(ls.shape[-1], device=ls.device)
                            < top_k)
        p = torch.softmax(torch.where(keep_sorted, ls, -1e30), dim=-1)
        keep_sorted &= (torch.cumsum(p, dim=-1) - p) < top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        lg = torch.where(keep, lg, -1e30)
    elif top_k > 0:
        kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
        lg = torch.where(lg < kth, -1e30, lg)
    probs = torch.softmax(lg.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def generate(params, prompt, cfg: LlamaConfig, *,
             max_new_tokens: int = 32, max_len: Optional[int] = None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             generator: Optional[torch.Generator] = None,
             eos_token_id: Optional[int] = None,
             pad_token_id: Optional[int] = None, prompt_lengths=None,
             use_kernel: Optional[bool] = None, kv_cache_dtype=None,
             prompt_cache: Optional[Dict] = None) -> torch.Tensor:
    """prompt (B, S) int -> (B, S + max_new_tokens) int32 on the params'
    device: one prefill forward of the prompt into a dense ``(L, B,
    max_len, nkv, hd)`` cache, then a decode step per new token, the
    cache updated in place. Decode steps attend through kernel B7
    (``use_kernel``: see :func:`_use_decode_kernel`).

    Greedy at ``temperature`` 0, else temperature sampling with optional
    ``top_k`` and ``top_p`` (:func:`_sample`) from ``generator`` (a
    ``torch.Generator`` on the params' device; default seeded with 0,
    the JAX package's ``key(0)``). ``eos_token_id``: a row that emits it
    is pinned to it for the rest of the run (fixed-shape output).
    ``kv_cache_dtype="int8"``: int8 cache rows with per-row scales.

    ``pad_token_id`` / ``prompt_lengths``: ragged batches LEFT-padded —
    each row's rope positions start at its first real token and pad
    slots are masked (``kstart``), so every row decodes as it would
    unpadded; those decode steps take the plain composition, as in the
    JAX package (B7 has no pad mask).

    ``prompt_cache``: a :func:`precompute_prompt_cache` result; its P
    prefix rows are copied into every row's cache and ``prompt``
    continues at position P. The result holds ``prompt`` and the new
    tokens (prefix excluded), equal to a run on ``concat(prefix,
    prompt)``."""
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt).to(device=dev, dtype=torch.int32)
    B, S = prompt.shape
    # observability anchor: prefill and decode latency histograms, token
    # counters, host spans; 0 (and no wait on the card) when disabled
    t_obs = _obs.generate_begin()
    P = 0
    if prompt_cache is not None:
        if pad_token_id is not None or prompt_lengths is not None:
            raise ValueError(
                "generate: prompt_cache cannot be combined with left-"
                "padded ragged prompts (pad_token_id/prompt_lengths) — "
                "the shared prefix assumes aligned positions")
        P = int(prompt_cache["len"])
        if ("ks" in prompt_cache["cache"]) != (kv_cache_dtype is not None):
            raise ValueError(
                "generate: prompt_cache kv dtype does not match "
                "kv_cache_dtype — an int8 prefix must feed an int8 cache")
    total = P + S + max_new_tokens
    max_len = max_len or total
    if max_len < total:
        raise AssertionError(f"generate: max_len={max_len} < {total} "
                             f"(prefix + prompt + new tokens)")
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    cache = init_cache(cfg, B, max_len, kv_dtype=kv_cache_dtype, device=dev)
    if prompt_cache is not None:
        for name, arr in cache.items():
            arr[:, :, :P] = prompt_cache["cache"][name][:, :, :P].to(
                arr.dtype)
    kstart = _pad_starts(prompt, pad_token_id, prompt_lengths)
    rpos = None
    if kstart is not None:
        rpos = torch.clamp(torch.arange(S, device=dev)[None, :]
                           - kstart[:, None].long(), min=0)
    logits = _forward_cached(params, prompt, cache, P, cfg, max_len,
                             rpos=rpos, kstart=kstart)
    t_obs = _obs.generate_phase("prefill", t_obs, logits, B * S)
    tok = _sample(logits, temperature, top_k, top_p, generator)
    eos = eos_token_id
    done = (tok == eos) if eos is not None else None
    out = [tok]
    for i in range(max_new_tokens - 1):
        drpos = (None if kstart is None
                 else (S + i - kstart.long())[:, None])
        logits = _forward_cached(params, tok[:, None], cache, P + S + i,
                                 cfg, max_len, rpos=drpos, kstart=kstart,
                                 use_kernel=use_kernel)
        tok = _sample(logits, temperature, top_k, top_p, generator)
        if eos is not None:
            tok = torch.where(done, torch.full_like(tok, eos), tok)
            done |= tok == eos
        out.append(tok)
    out = torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
    _obs.generate_phase("decode", t_obs, out, B * max_new_tokens)
    return out


def beam_search(params, prompt, cfg: LlamaConfig, *, num_beams: int = 4,
                max_new_tokens: int = 32, max_len: Optional[int] = None,
                eos_token_id: Optional[int] = None,
                length_penalty: float = 1.0,
                pad_token_id: Optional[int] = None, prompt_lengths=None,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Beam-search decoding, the JAX package's ``beam_search``: prompt
    (B, S) -> (B, S + max_new_tokens) int32, the best beam per row. The
    K = ``num_beams`` beams of a row live as K rows of the cache, and
    every step gathers the winning beams' rows (no backpointer walk);
    finished beams emit EOS forever at zero cost, so their scores freeze.

    Scores are sums of token log-probs, finalized GNMT-style as ``score /
    len ** length_penalty`` with the length counted up to and including
    the first EOS. The top K of each step come from a descending stable
    sort, so ties keep the lower index first, as ``lax.top_k`` does.
    Ragged LEFT-padded batches via ``pad_token_id`` / ``prompt_lengths``,
    as in :func:`generate`. Decode steps attend through B7 where no row
    is padded (``use_kernel``: :func:`_use_decode_kernel`)."""
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt).to(device=dev, dtype=torch.int32)
    B, S = prompt.shape
    K = num_beams
    total = S + max_new_tokens
    max_len = max_len or total
    if max_len < total:
        raise AssertionError(f"beam_search: max_len={max_len} < {total} "
                             f"(prompt + new tokens)")
    eos = eos_token_id
    kstart = _pad_starts(prompt, pad_token_id, prompt_lengths)
    ktile = rpos = None
    if kstart is not None:
        ktile = torch.repeat_interleave(kstart, K, dim=0)       # (B*K,)
        rpos = torch.clamp(torch.arange(S, device=dev)[None, :]
                           - ktile[:, None].long(), min=0)
    cache = init_cache(cfg, B * K, max_len, device=dev)
    ptile = torch.repeat_interleave(prompt, K, dim=0)           # (B*K, S)
    logits = _forward_cached(params, ptile, cache, 0, cfg, max_len,
                             rpos=rpos, kstart=ktile, use_kernel=use_kernel)
    V = logits.shape[-1]

    def top(x):
        v, i = torch.sort(x, dim=-1, descending=True, stable=True)
        return v[:, :K], i[:, :K]

    logp = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
    # all K beams are identical after prefill: expand from beam 0 only
    scores, first = top(logp[:, 0])                             # (B, K)
    first = first.to(torch.int32)
    done = ((first == eos) if eos is not None
            else torch.zeros((B, K), dtype=torch.bool, device=dev))
    gen = torch.zeros((B, K, max_new_tokens), dtype=torch.int32, device=dev)
    gen[:, :, 0] = first
    frozen = None
    if eos is not None:
        frozen = torch.full((V,), -1e30, device=dev)
        frozen[eos] = 0.0
    last = first
    brow = torch.arange(B, device=dev)[:, None] * K
    for i in range(1, max_new_tokens):
        # last holds the tokens of step i-1, at cache position S+i-1
        drpos = (None if ktile is None
                 else (S + i - 1 - ktile.long())[:, None])
        logits = _forward_cached(params, last.reshape(B * K, 1), cache,
                                 S + i - 1, cfg, max_len, rpos=drpos,
                                 kstart=ktile, use_kernel=use_kernel)
        logp = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
        if frozen is not None:
            logp = torch.where(done[:, :, None], frozen, logp)
        scores, idx = top((scores[:, :, None] + logp).reshape(B, K * V))
        beam = idx // V
        tok = (idx % V).to(torch.int32)
        gen = torch.gather(gen, 1, beam[:, :, None].expand_as(gen))
        gen[:, :, i] = tok
        if eos is not None:
            done = torch.gather(done, 1, beam) | (tok == eos)
        rows = (brow + beam).reshape(-1)                        # (B*K,)
        cache = {n: c.index_select(1, rows) for n, c in cache.items()}
        last = tok
    if eos is not None:
        hit = gen == eos
        first_eos = torch.argmax(hit.int(), dim=-1)
        lengths = torch.where(hit.any(dim=-1), first_eos + 1,
                              max_new_tokens)
    else:
        lengths = torch.full((B, K), max_new_tokens, device=dev)
    final = scores / (lengths.float() ** length_penalty)
    best = torch.argmax(final, dim=1)                           # (B,)
    seq = gen[torch.arange(B, device=dev), best]
    return torch.cat([prompt, seq], dim=1)


def paged_prefill_insert(params, prompt: torch.Tensor, paged: Dict,
                         block_table: torch.Tensor, cfg: LlamaConfig,
                         prompt_len=None):
    """Prefill ONE request and scatter its KV into the paged pools, the
    JAX ``paged_prefill_insert``; the pools are written in place and
    returned.

    prompt:      (1, S) int, LEFT-padded to S when ``prompt_len`` is
                 given (the true prompt length, an int or a one-element
                 tensor)
    paged:       :func:`init_paged_cache` pools (int8 tier included)
    block_table: (ppseq,) int page ids for this request, in logical
                 order
    returns (last-token logits (1, V), ``paged``).

    The prefill runs the dense path (:func:`_forward_cached`) over a
    temporary cache of the prompt's width S, then scatters those S rows
    into the request's pages, page slot ``s`` holding logical token
    ``s``: a left-padded prompt's rows shift down by its pad (rope
    positions and the ``kstart`` mask make its prefill row-identical to
    the unpadded one), and the rows past its length repeat the last row
    (finite, overwritten by decode before any mask exposes them). Page
    slots past the prompt keep what a previous tenant left there."""
    B, S = prompt.shape
    if B != 1:
        raise ValueError(
            f"paged_prefill_insert: one request at a time (got batch "
            f"{B}); continuous batching admits requests individually")
    page = paged["k"].shape[2]
    ext = block_table.shape[0] * page
    if S > ext:
        raise ValueError(
            f"prompt of {S} tokens exceeds the block table's "
            f"{ext}-token extent")
    dev = paged["k"].device
    prompt = torch.as_tensor(prompt).to(dev)
    quant = "ks" in paged
    dense = init_cache(cfg, 1, S, kv_dtype="int8" if quant else None,
                       device=dev)
    src = None
    if prompt_len is None:
        logits = _forward_cached(params, prompt, dense, 0, cfg, S)
    else:
        pad = S - torch.as_tensor(prompt_len).to(
            device=dev, dtype=torch.long).reshape(())
        kstart = torch.clamp(pad, 0, S - 1)[None]                # (1,)
        rpos = torch.clamp(torch.arange(S, device=dev)[None, :]
                           - kstart[:, None], min=0)
        logits = _forward_cached(params, prompt, dense, 0, cfg, S,
                                 rpos=rpos, kstart=kstart.to(torch.int32))
        src = torch.clamp(pad + torch.arange(S, device=dev), 0, S - 1)
    pos = torch.arange(S, device=dev)
    block_table = block_table.to(device=dev, dtype=torch.long)
    dst = block_table[pos // page] * page + pos % page
    for name in paged:
        rows = dense[name][:, 0]
        if src is not None:
            rows = rows[:, src]
        _scatter_rows(paged[name], dst, rows)
    return logits, paged


def paged_prefill_chunk(params, tokens: torch.Tensor, paged: Dict,
                        block_table: torch.Tensor, cfg: LlamaConfig, *,
                        ctx_cap: int, ctx_len: int, chunk_len: int,
                        fused: bool = False, adapters=None,
                        adapter_slot=None):
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
    kernel (B11). ``adapters`` / ``adapter_slot`` ((1,), the request's
    pool slot): its LoRA term, as in :func:`paged_decode_forward`; the
    chunk's cached K/V stay adapter-agnostic (q/o adapters only)."""
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
    # a fill, not a host copy: the engine dispatches this without a fence
    kstart = torch.full((1,), pad, dtype=torch.int32, device=dev)
    rpos = (ctx_len + torch.arange(C, device=dev))[None, :]
    logits = _forward_cached(params, tokens.to(dev), dense, ctx_cap, cfg,
                             W, rpos=rpos, kstart=kstart,
                             logits_at=chunk_len - 1, fused=bool(fused),
                             adapters=adapters, adapter_slots=adapter_slot)
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
                         tree_mask=None, adapters=None, adapter_slots=None):
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

    ``adapters`` / ``adapter_slots``: the rows' LoRA term, as in
    :func:`paged_decode_forward`.
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
                             tree_mask=tree_mask if tree else None,
                             adapters=adapters, adapter_slots=adapter_slots)
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
                         fused: bool = False, adapters=None,
                         adapter_slots=None):
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
    unrotated with its per-row cos/sin rows.

    ``adapters`` / ``adapter_slots``: the multi-LoRA term, the
    :class:`~..serving.adapters.AdapterPool`'s tensors (per-layer packed
    A/B factors, per-slot alpha/r) and the (B,) pool slot of each row;
    the q and o projections add :func:`_lora_delta`. The q term goes in
    before the rotation, which B10 does while staging q; the o term on
    the projection's output. Slot 0 holds exact zeros, and
    ``adapters=None`` leaves the term out."""
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
    ad = _adapter_prep(adapters, adapter_slots, cfg)
    ksp = vsp = None
    for l in range(cfg.num_layers):
        lp = layer_params(params, l)
        al = None if ad is None else ad(l)
        h1 = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q = h1 @ _w(lp, "wq", x.dtype)
        if al is not None:
            q = q + _lora_delta(h1, al[0], al[1], al[4])
        q = q.reshape(B, 1, nh, hd)
        k = (h1 @ _w(lp, "wk", x.dtype)).reshape(B, 1, nkv, hd)
        v = (h1 @ _w(lp, "wv", x.dtype)).reshape(B, 1, nkv, hd)
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
        o = o.reshape(B, 1, nh * hd)
        ow = o @ _w(lp, "wo", x.dtype)
        if al is not None:
            ow = ow + _lora_delta(o, al[2], al[3], al[4])
        x = _ffn(x + ow, lp, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = (x[:, -1] @ _lm_head(params, cfg, x.dtype)).float()
    return logits, paged
