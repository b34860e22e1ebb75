"""B10 fused RoPE + paged decode and B11 flash chunk attention.

Counterpart of ``paddle_tpu/ops/pallas/serving_fused.py``:

- :func:`fused_paged_decode_attention`: the paged decode attention with
  q's RoPE rotation done in the kernel, so the rotated q never makes a
  round trip through device memory. CUDA tensors launch
  ``csrc/paged_decode.cu`` in its RoPE variant (it replaces the TPU
  kernels ``_fused_paged_kernel`` / ``_fused_paged_kernel_rowq``; for
  bf16 queries the key-split body of ``csrc/paged_split.cuh``, which
  rotates q as it stages it); the contract with the unfused path is
  token identity per KV tier.
- :func:`flash_chunk_attention`: multi-token ragged flash attention of
  a prefill or verify chunk against its dense temp cache. CUDA tensors
  launch ``csrc/flash_chunk.cu`` (it replaces ``_chunk_kernel`` /
  ``_chunk_kernel_rowq``, kernel B11-linear). With ``tree_mask`` (tree
  speculative verify) the call goes to
  :func:`flash_chunk_tree_attention`, the same kernel in its tree form
  (``_chunk_kernel_tree`` / ``_chunk_kernel_rowq_tree``, B11-tree),
  which counts its launches apart.

Each wrapper takes its plain PyTorch version for CPU tensors, never for
CUDA ones, and counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .paged_attention import (_Q_DTYPES, _aligned, _check_pair,
                              launch_paged_decode, paged_attention_plain)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: the tree form packs each node's ancestor row into one int32
TREE_MAX_NODES = 32
FLASH_CHUNK_SIGNATURES = {
    "ptt_flash_chunk": (
        _P, _P, _P, _P, _P, _P, _P,     # q, ck, cv, k/v rows, kstart,
        _P,                             # tree bits (or NULL), out
        _I, _I, _I, _I, _I, _I,         # B, T, H, HK, D, W
        _L, _L, _L, _L, _L, _L,         # cache strides, row-scale strides
        ctypes.c_float, _I, _I, _P),    # scale, q dtype, kv int8, stream
}


def rotate_q_plain(q, cos_row, sin_row):
    """q (B, H, D) rotated at each row's position: f32 elementwise math
    on the halves (the model's ``_rope_rows`` at T=1), cast back to q's
    dtype. cos/sin_row: (B, D/2)."""
    x1, x2 = torch.chunk(q, 2, dim=-1)
    c = cos_row.float()[:, None, :]
    s = sin_row.float()[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(q.dtype)


def fused_paged_decode_plain(q, cos_row, sin_row, k_pages, v_pages,
                             block_tables, lengths, *, scale=None,
                             ks_pages=None, vs_pages=None):
    """The unfused composition: rotate q, then plain paged attention —
    so the plain fused path equals the plain unfused path bit for bit."""
    qr = rotate_q_plain(q, cos_row, sin_row)
    return paged_attention_plain(
        qr, k_pages, v_pages, block_tables, lengths, scale=scale,
        ks_pages=ks_pages, vs_pages=vs_pages)


def fused_paged_decode_attention(q, cos_row, sin_row, k_pages, v_pages,
                                 block_tables, lengths, *, scale=None,
                                 ks_pages=None, vs_pages=None):
    """Fused RoPE + paged decode attention (B10).

    q:            (B, H, D) UNROTATED single-token queries
    cos/sin_row:  (B, D/2) f32 rope table rows at each row's position
    k/v_pages:    (P, page, HK, D) pools; ks/vs_pages (P, page, HK)
                  per-row int8 dequant scales
    block_tables: (B, ppseq) int; lengths: (B,) incl. current token
    """
    if q.device.type == "cpu":
        return fused_paged_decode_plain(
            q, cos_row, sin_row, k_pages, v_pages, block_tables, lengths,
            scale=scale, ks_pages=ks_pages, vs_pages=vs_pages)
    out = launch_paged_decode(q, k_pages, v_pages, block_tables, lengths,
                              scale=scale, ks_pages=ks_pages,
                              vs_pages=vs_pages, cos_row=cos_row,
                              sin_row=sin_row)
    fused_paged_decode_attention.launches += 1
    return out


fused_paged_decode_attention.launches = 0


def flash_chunk_attention_plain(q, ck, cv, length, kstart, *, scale=None,
                                k_rows=None, v_rows=None, tree_mask=None):
    """Plain PyTorch chunk attention, op for op the JAX package's
    ``flash_chunk_attention_reference``. Linear: query t of row b sees
    columns ``[kstart_b, length - T + t]`` (from column 0 when
    ``kstart`` is None: the dense prefill of ``generate``). With
    ``tree_mask`` (B, T, T) bool, the ancestor-or-self matrix of a token tree in the chunk's T
    lanes: every committed column below the chunk stays visible, chunk
    column ``W - T + j`` only where ``tree_mask[b, t, j]``, and the
    ``kstart`` mask still applies."""
    B, T, H, D = q.shape
    _check_pair(k_rows, v_rows, "flash_chunk_attention")
    if k_rows is not None:
        ck = (ck.float() * k_rows[..., None]).to(q.dtype)
        cv = (cv.float() * v_rows[..., None]).to(q.dtype)
    nkv = ck.shape[2]
    if nkv != H:
        ck = torch.repeat_interleave(ck, H // nkv, dim=2)
        cv = torch.repeat_interleave(cv, H // nkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck.float())
    s = s * scale if scale is not None else s / math.sqrt(D)
    dev = q.device
    kpos = torch.arange(s.shape[3], device=dev)[None, None, None, :]
    if tree_mask is None:
        qpos = (length - T) + torch.arange(T, device=dev)[None, None, :,
                                                          None]
        s = torch.where(kpos <= qpos, s, -1e30)
    else:
        smax = ck.shape[1]
        allow = torch.cat(
            [torch.ones((B, T, smax - T), dtype=torch.bool, device=dev),
             torch.as_tensor(tree_mask, device=dev).bool()], dim=2)
        s = torch.where(allow[:, None], s, -1e30)
    if kstart is not None:
        ks = torch.as_tensor(kstart, dtype=torch.int32, device=dev)
        ks = ks.broadcast_to((B,))[:, None, None, None]
        s = torch.where(kpos >= ks, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(cv.dtype), cv)


def _check_tree(tree_mask, B: int, T: int):
    if T > TREE_MAX_NODES:
        raise ValueError(
            f"flash_chunk_attention: tree mode packs ancestor rows into "
            f"int32 bitmasks, so the tree is capped at {TREE_MAX_NODES} "
            f"nodes (got T={T})")
    if tuple(tree_mask.shape) != (B, T, T):
        raise ValueError(f"flash_chunk_attention: tree_mask must be "
                         f"({B}, {T}, {T}), got {tuple(tree_mask.shape)}")


def tree_bits(tree_mask) -> torch.Tensor:
    """(B, T, T) ancestor-or-self matrix -> (B, T) int32 bitmasks, bit
    j of node t set iff chunk node j is on t's root path (the Pallas
    wrapper's packing; node 31 lands in the sign bit)."""
    m = torch.as_tensor(tree_mask).bool()
    w = torch.arange(m.shape[2], device=m.device, dtype=torch.int64)
    bits = (m.long() << w).sum(dim=2)                   # < 2**32
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(
        torch.int32)


def launch_flash_chunk(q, ck, cv, length, kstart, *, scale=None,
                       k_rows=None, v_rows=None,
                       tree_mask=None) -> torch.Tensor:
    """Launch ``ptt_flash_chunk`` on CUDA tensors: B11-linear, or with
    ``tree_mask`` B11-tree; validates every input and raises on what the
    kernel does not take."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash chunk kernel needs CUDA tensors, got {dev}")
    if q.dim() != 4 or q.dtype not in _Q_DTYPES:
        raise ValueError(f"flash_chunk: q must be (B, T, H, D) float32 or "
                         f"bfloat16, got {tuple(q.shape)} {q.dtype}")
    B, T, H, D = q.shape
    if ck.dim() != 4 or ck.shape != cv.shape or ck.shape[0] != B:
        raise ValueError("flash_chunk: ck/cv must share one (B, W, HK, D) "
                         "shape")
    W, HK = ck.shape[1], ck.shape[2]
    if int(length) != W:
        raise ValueError(f"flash_chunk: length ({length}) must equal the "
                         f"cache width W={W}")
    if ck.shape[3] != D or D not in (64, 128):
        raise ValueError(f"flash_chunk: head dim {D}; the kernel takes 64 "
                         f"or 128")
    if H % HK or W < T:
        raise ValueError(f"flash_chunk: H={H} must be a multiple of HK={HK}"
                         f" and W={W} >= T={T}")
    _check_pair(k_rows, v_rows, "flash_chunk")
    quant = k_rows is not None
    kv_dtype = torch.int8 if quant else q.dtype
    for t, nm in ((ck, "ck"), (cv, "cv")):
        if t.dtype != kv_dtype or t.device != dev:
            raise ValueError(f"flash_chunk: {nm} must be {kv_dtype} on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if t.stride(3) != 1 or not _aligned(t, (0, 1, 2)):
            raise ValueError(f"flash_chunk: {nm} rows must be contiguous "
                             f"and 16-byte aligned")
    if ck.stride() != cv.stride():
        raise ValueError("flash_chunk: ck/cv must share strides")
    r_strides = (0, 0, 0)
    if quant:
        for t, nm in ((k_rows, "k_rows"), (v_rows, "v_rows")):
            if (t.shape != (B, W, HK) or t.dtype != torch.float32
                    or t.device != dev):
                raise ValueError(f"flash_chunk: {nm} must be float32 "
                                 f"(B, W, HK) on {dev}")
        if k_rows.stride() != v_rows.stride():
            raise ValueError("flash_chunk: row scales must share strides")
        r_strides = k_rows.stride()
    q = q.contiguous()
    if not _aligned(q):
        raise ValueError("flash_chunk: q must be 16-byte aligned")
    kst = torch.as_tensor(kstart, device=dev).to(
        torch.int32).broadcast_to((B,)).contiguous()
    bits = None
    if tree_mask is not None:
        _check_tree(tree_mask, B, T)
        bits = tree_bits(torch.as_tensor(tree_mask, device=dev))
    out = torch.empty_like(q)
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    lib = _build.load("flash_chunk", FLASH_CHUNK_SIGNATURES)
    rc = lib.ptt_flash_chunk(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        k_rows.data_ptr() if quant else None,
        v_rows.data_ptr() if quant else None,
        kst.data_ptr(), bits.data_ptr() if bits is not None else None,
        out.data_ptr(), B, T, H, HK, D, W,
        *ck.stride()[:3], *r_strides, float(s), _Q_DTYPES[q.dtype],
        int(quant), _build.stream_handle(dev))
    _build.check(lib, rc, "flash_chunk")
    return out


def flash_chunk_attention(q, ck, cv, length, kstart, *, scale=None,
                          k_rows=None, v_rows=None, tree_mask=None):
    """Multi-token serving attention (B11-linear): the plain version for
    CPU tensors, the flash chunk kernel for CUDA tensors (or an error).

    q:       (B, T, H, D) rotated chunk queries
    ck/cv:   (B, W, HK, D) right-aligned temp cache (int8 with
             ``k_rows``/``v_rows`` (B, W, HK) per-row dequant scales)
    length:  static total width, ``== W``
    kstart:  (B,) first valid cache column per row
    tree_mask: optional (B, T, T) bool ancestor-or-self matrix; the call
             then goes to :func:`flash_chunk_tree_attention` (B11-tree)
    """
    if tree_mask is not None:
        return flash_chunk_tree_attention(
            q, ck, cv, length, kstart, tree_mask, scale=scale,
            k_rows=k_rows, v_rows=v_rows)
    if q.device.type == "cpu":
        return flash_chunk_attention_plain(
            q, ck, cv, length, kstart, scale=scale, k_rows=k_rows,
            v_rows=v_rows)
    out = launch_flash_chunk(q, ck, cv, length, kstart, scale=scale,
                             k_rows=k_rows, v_rows=v_rows)
    flash_chunk_attention.launches += 1
    return out


flash_chunk_attention.launches = 0


def flash_chunk_tree_attention(q, ck, cv, length, kstart, tree_mask, *,
                               scale=None, k_rows=None, v_rows=None):
    """Tree speculative verify attention (B11-tree): the chunk's T lanes
    are token-tree nodes and ``tree_mask`` (B, T, T) bool replaces the
    in-chunk causal triangle. The plain version for CPU tensors, the
    flash chunk kernel in its tree form for CUDA tensors (or an error).
    Either way T is capped at 32 nodes, the kernel's bitmask width."""
    _check_tree(tree_mask, q.shape[0], q.shape[1])
    if q.device.type == "cpu":
        return flash_chunk_attention_plain(
            q, ck, cv, length, kstart, scale=scale, k_rows=k_rows,
            v_rows=v_rows, tree_mask=tree_mask)
    out = launch_flash_chunk(q, ck, cv, length, kstart, scale=scale,
                             k_rows=k_rows, v_rows=v_rows,
                             tree_mask=tree_mask)
    flash_chunk_tree_attention.launches += 1
    return out


flash_chunk_tree_attention.launches = 0
