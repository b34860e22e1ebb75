"""B9: ragged paged decode attention over block-table-indexed KV pools.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``. K/V live in
one pool of fixed-size token pages per layer, ``(P, page, HK, D)``, and
each request owns an ordered block table of page ids.

- :func:`paged_attention_plain` does op for op what the JAX package's
  ``paged_attention_reference`` does: gather, dequantize, repeat the kv
  heads, f32 scores, ``-1e30`` masks, softmax, ``p`` cast to V's dtype.
- :func:`paged_attention` is the wrapper. CPU tensors take the plain
  version. CUDA tensors launch the hand-written kernel of
  ``csrc/paged_decode.cu`` (it replaces the TPU kernels
  ``_paged_kernel`` / ``_paged_kernel_rowq``; for bf16 queries the
  key-split body of ``csrc/paged_split.cuh``, shared with B8 and B10) or
  raise; there is no fallback. ``paged_attention.launches`` counts
  kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
PAGED_DECODE_SIGNATURES = {
    "ptt_paged_decode": (
        _P, _P, _P,                     # q, cos_row, sin_row
        _P, _P, _P, _P,                 # k/v pages, k/v scales
        _P, _P, _P,                     # block tables, lengths, out
        _I, _I, _I, _I, _I, _I,         # B, H, HK, D, page, ppseq
        _L, _L, _L, _L, _L, _L,         # pool strides, scale strides
        ctypes.c_float, _I, _I, _P),    # scale, q dtype, kv int8, stream
    "ptt_paged_decode_splits": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I,
        _L, _L, _L, _L, _L, _L,
        ctypes.c_float, _I, _I, _I, _P),  # ..., kv int8, splits, stream
}
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: key splits the bf16 paged decode kernels (B8, B9, B10) can be forced
#: to (the CTAs of a thread block cluster)
DECODE_SPLITS = (1, 2, 4, 8)


def gather_pages(pages: torch.Tensor,
                 block_tables: torch.Tensor) -> torch.Tensor:
    """pages (P, page, ...) + block_tables (B, ppseq) -> (B, ppseq*page,
    ...): slot ``s`` of the result is logical token position ``s``.
    Negative ids index from the end, as ``jnp.take`` does."""
    B, ppseq = block_tables.shape
    page = pages.shape[1]
    g = pages[block_tables.reshape(-1).long()]
    return g.reshape((B, ppseq * page) + tuple(pages.shape[2:]))


def _check_pair(ks, vs, what):
    if (ks is None) != (vs is None):
        raise ValueError(
            f"{what}: k and v scales must be passed together — int8 "
            f"pools quantize both K and V")


def paged_attention_plain(q, k_pages, v_pages, block_tables, lengths, *,
                          scale=None, ks_pages=None, vs_pages=None):
    """Plain PyTorch paged decode attention.

    q:            (B, H, D) single-token queries
    k/v_pages:    (P, page, HK, D) page pools
    block_tables: (B, ppseq) int page ids (logical-position order)
    lengths:      (B,) valid lengths INCLUDING the current token
    ks/vs_pages:  (P, page, HK) f32 per-row dequant scales (int8 pools)
    """
    B, H, D = q.shape
    _check_pair(ks_pages, vs_pages, "paged_attention")
    ck = gather_pages(k_pages, block_tables)      # (B, S, HK, D)
    cv = gather_pages(v_pages, block_tables)
    if ks_pages is not None:
        k_rows = gather_pages(ks_pages, block_tables)   # (B, S, HK)
        v_rows = gather_pages(vs_pages, block_tables)
        ck = (ck.float() * k_rows[..., None]).to(q.dtype)
        cv = (cv.float() * v_rows[..., None]).to(q.dtype)
    nkv = ck.shape[2]
    if nkv != H:
        ck = torch.repeat_interleave(ck, H // nkv, dim=2)
        cv = torch.repeat_interleave(cv, H // nkv, dim=2)
    qf = q[:, None]                                # (B, 1, H, D)
    s = torch.einsum("bqhd,bkhd->bhqk", qf.float(), ck.float())
    s = s * scale if scale is not None else s / math.sqrt(D)
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=q.device).broadcast_to((B,))
    kpos = torch.arange(s.shape[3], device=q.device)[None, None, None, :]
    qpos = (lengths[:, None, None, None] - 1)
    s = torch.where(kpos <= qpos, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(cv.dtype), cv)
    return o[:, 0]                                 # (B, H, D)


def _aligned(t: torch.Tensor, dims=()) -> bool:
    """``t`` starts on a 16-byte boundary and its strides over
    ``dims`` are multiples of 16 bytes (the kernels' vector loads)."""
    esz = t.element_size()
    if t.data_ptr() % 16:
        return False
    return all((t.stride(d) * esz) % 16 == 0 for d in dims)


def launch_paged_decode(q, k_pages, v_pages, block_tables, lengths, *,
                        scale=None, ks_pages=None, vs_pages=None,
                        cos_row=None, sin_row=None,
                        splits=None) -> torch.Tensor:
    """Launch ``ptt_paged_decode`` (B9; B10 when ``cos_row``/``sin_row``
    are given) on CUDA tensors. ``splits`` (one of :data:`DECODE_SPLITS`,
    bf16 queries only) forces the key split that the kernel otherwise
    chooses from the shape, to time the choice against the others.
    Validates every input and raises on what the kernel does not take;
    never falls back."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged decode kernel needs CUDA tensors, got {dev}")
    _check_pair(ks_pages, vs_pages, "paged_decode")
    if (cos_row is None) != (sin_row is None):
        raise ValueError("paged_decode: cos_row and sin_row go together")
    if q.dim() != 3 or q.dtype not in _Q_DTYPES:
        raise ValueError(f"paged_decode: q must be (B, H, D) float32 or "
                         f"bfloat16, got {tuple(q.shape)} {q.dtype}")
    B, H, D = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("paged_decode: k/v pools must share one "
                         "(P, page, HK, D) shape")
    P, page, HK, Dk = k_pages.shape
    quant = ks_pages is not None
    kv_dtype = torch.int8 if quant else q.dtype
    if Dk != D or D not in (64, 128):
        raise ValueError(f"paged_decode: head dim {D} (pool {Dk}); the "
                         f"kernel takes 64 or 128")
    if H % HK or H // HK > 8:
        raise ValueError(f"paged_decode: H={H} must be a multiple of "
                         f"HK={HK} with at most 8 query heads per kv head")
    if splits is not None and (splits not in DECODE_SPLITS
                               or q.dtype != torch.bfloat16):
        raise ValueError(f"paged_decode: splits={splits} needs bfloat16 "
                         f"queries and one of {DECODE_SPLITS}")
    for t, nm in ((k_pages, "k_pages"), (v_pages, "v_pages")):
        if t.dtype != kv_dtype or t.device != dev:
            raise ValueError(f"paged_decode: {nm} must be {kv_dtype} on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if t.stride(3) != 1 or not _aligned(t, (0, 1, 2)):
            raise ValueError(f"paged_decode: {nm} rows must be contiguous "
                             f"and 16-byte aligned")
    if k_pages.stride() != v_pages.stride():
        raise ValueError("paged_decode: k/v pools must share strides")
    sc_strides = (0, 0, 0)
    if quant:
        for t, nm in ((ks_pages, "ks_pages"), (vs_pages, "vs_pages")):
            if (t.shape != (P, page, HK) or t.dtype != torch.float32
                    or t.device != dev):
                raise ValueError(f"paged_decode: {nm} must be float32 "
                                 f"(P, page, HK) on {dev}")
        if ks_pages.stride() != vs_pages.stride():
            raise ValueError("paged_decode: scale pools must share strides")
        sc_strides = ks_pages.stride()
    rope = cos_row is not None
    if rope:
        cos_row = cos_row.to(device=dev, dtype=torch.float32).contiguous()
        sin_row = sin_row.to(device=dev, dtype=torch.float32).contiguous()
        if cos_row.shape != (B, D // 2) or sin_row.shape != (B, D // 2):
            raise ValueError("paged_decode: cos/sin rows must be (B, D/2)")
    q = q.contiguous()
    if not _aligned(q):
        raise ValueError("paged_decode: q must be 16-byte aligned")
    bt = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    if bt.dim() != 2 or bt.shape[0] != B or bt.shape[1] == 0:
        raise ValueError("paged_decode: block_tables must be (B, ppseq)")
    lens = torch.as_tensor(lengths, device=dev).to(
        torch.int32).broadcast_to((B,)).contiguous()
    out = torch.empty_like(q)
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    lib = _build.load("paged_decode", PAGED_DECODE_SIGNATURES)

    def ptr(t: Optional[torch.Tensor]):
        return None if t is None else t.data_ptr()

    args = (ptr(q), ptr(cos_row), ptr(sin_row), ptr(k_pages),
            ptr(v_pages), ptr(ks_pages), ptr(vs_pages), ptr(bt), ptr(lens),
            ptr(out), B, H, HK, D, page, bt.shape[1],
            *k_pages.stride()[:3], *sc_strides, float(s),
            _Q_DTYPES[q.dtype], int(quant))
    if splits is None:
        rc = lib.ptt_paged_decode(*args, _build.stream_handle(dev))
    else:
        rc = lib.ptt_paged_decode_splits(*args, splits,
                                         _build.stream_handle(dev))
    _build.check(lib, rc, "paged_decode")
    return out


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale=None, ks_pages=None, vs_pages=None):
    """Paged decode attention: the plain version for CPU tensors, the
    B9 kernel for CUDA tensors (or an error)."""
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pages, v_pages, block_tables, lengths, scale=scale,
            ks_pages=ks_pages, vs_pages=vs_pages)
    out = launch_paged_decode(q, k_pages, v_pages, block_tables, lengths,
                              scale=scale, ks_pages=ks_pages,
                              vs_pages=vs_pages)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
