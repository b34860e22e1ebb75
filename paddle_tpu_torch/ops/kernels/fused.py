"""B4-B5 fused RMSNorm and SwiGLU for the training model, B6 fused RoPE
and B8 head-major paged decode attention for ``incubate``'s serving ops,
and B7 decode attention against a contiguous KV cache for dense
``generate``.

Counterpart of ``paddle_tpu/ops/pallas/fused.py``:

- :func:`rms_fwd` (B4a): the normalised rows and the per-row f32
  ``rstd``. CUDA tensors launch ``csrc/fused.cu``'s forward (it replaces
  the TPU kernel ``_rms_fwd_kernel``).
- :func:`rms_bwd` (B4b): dx and dw. The kernel writes dw as f32 partial
  sums over each CTA's ``RMS_BWD_ROWS`` rows; they are summed here and
  cast to w's dtype, as ``_rms_norm_bwd`` sums the TPU kernel's
  per-block partials. It replaces ``_rms_bwd_kernel``.
- :func:`swiglu_fwd` (B5a) and :func:`swiglu_bwd` (B5b): ``silu(g) * u``
  and its two cotangents. They replace ``_swiglu_fwd_kernel`` and
  ``_swiglu_bwd_kernel``.
- :func:`decode_attention` (B7): one-token attention of q (B, H, D)
  against the first ``cache_len[b]`` rows of a padded (B, S, HK, D)
  cache, GQA by head group, optional int8 rows with per-row f32 scales.
  CUDA tensors launch ``csrc/decode_attention.cu`` (it replaces
  ``_decode_kernel`` / ``_decode_kernel_qrow``); bf16 queries run the
  key-split body of ``csrc/paged_split.cuh`` that B8-B10 share, with
  its dense addressing, and the lengths are read on the device.
- :func:`rope_apply` (B6): neox rotate-half RoPE of x (B, S, H, D) by
  (S, D/2) f32 tables, ``sign`` -1 for the VJP. CUDA tensors launch
  ``csrc/rope.cu`` (it replaces ``_rope_kernel``); :class:`_RopeQK` and
  :func:`rope_qk` are the JAX package's ``_rope_qk`` custom VJP and
  ``rope_qk`` op.
- :func:`paged_decode_attention` (B8): one-token attention of q (B, H,
  D) over a head-major (P, HK, page, D) page pool through block
  tables, optional int8 pages with one f32 scale per (row, kv head).
  CUDA tensors launch ``csrc/decode_attention.cu``'s second entry (it
  replaces ``_paged_decode_kernel`` / ``_paged_decode_kernel_q``).
- :class:`_RMSNorm` and :class:`_SwiGLU` tie them into
  ``autograd.Function``\\ s (the JAX package's ``custom_vjp``\\ s
  ``_rms_norm_2d`` and ``_swiglu``), and :func:`rms_norm` and
  :func:`swiglu` are the public ops on any leading shape.

Each wrapper takes its plain PyTorch version for CPU tensors, never for
CUDA ones, and counts its kernel launches in ``.launches``. The TPU's
``block_rows`` (rows per grid step held in VMEM) is not carried over:
B4a runs one CTA per row, B4b one per ``RMS_BWD_ROWS`` rows, B5a and
B5b one 8-element chunk per thread. The kernels take float32 and
bfloat16, every tensor of one call in one dtype, and last dims that are
multiples of 8 (16-byte loads); RMSNorm rows up to ``MAX_WIDTH``. B6
takes float32 and bfloat16 and any even head dim. B7 and B8 take
float32 and bfloat16 queries, caches of q's dtype or int8, head dims 64
and 128 and at most 8 query heads per kv head.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .paged_attention import DECODE_SPLITS, _aligned, _check_pair

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 8192
#: rows of one B4b CTA, whose dw partial is one row of the partials
RMS_BWD_ROWS = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
SIGNATURES = {
    "ptt_rms_fwd": (_P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _P),
    "ptt_rms_bwd": (_P,) * 6 + (_I, _I, _I, _I, _P),
    "ptt_swiglu_fwd": (_P, _P, _P, _L, _I, _P),
    "ptt_swiglu_bwd": (_P,) * 5 + (_L, _I, _P),
}
DECODE_SIGNATURES = {
    "ptt_decode_attention": (
        _P, _P, _P, _P, _P,             # q, k/v caches, k/v row scales
        _P, _P,                         # lengths (B,) int32, out
        _I, _I, _I, _I, _I,             # B, H, HK, D, S
        _L, _L, _L, _L, _L, _L,         # cache strides, scale strides
        ctypes.c_float, _I, _I, _P),    # scale, q dtype, kv int8, stream
    "ptt_decode_attention_splits": (
        _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I,
        _L, _L, _L, _L, _L, _L,
        ctypes.c_float, _I, _I, _I, _P),  # ..., kv int8, splits, stream
    "ptt_paged_decode_hm": (
        _P, _P, _P, _P, _P,             # q, k/v pages, k/v scales
        _P, _P, _P,                     # block tables, lengths, out
        _I, _I, _I, _I, _I, _I,         # B, H, HK, D, page, ppseq
        _L, _L, _L, _L, _L,             # pool strides, scale strides
        ctypes.c_float, _I, _I, _P),    # scale, q dtype, kv int8, stream
    "ptt_paged_decode_hm_splits": (
        _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I,
        _L, _L, _L, _L, _L,
        ctypes.c_float, _I, _I, _I, _P),  # ..., kv int8, splits, stream
}
ROPE_SIGNATURES = {
    "ptt_rope": (_P, _P, _P, _P,              # x, cos, sin, out
                 _I, _I, _I, _I,              # B, S, H, D/2
                 _L, _L, _L,                  # x strides (b, s, h)
                 ctypes.c_float, _I, _I, _P),  # sign, dtype, vec, stream
}
#: head dims and query heads per kv head that B7 takes
DECODE_HEAD_DIMS = (64, 128)
DECODE_MAX_REP = 8


# ---------------- plain versions ----------------
def _f32(t):
    """``t`` in float32, the kernels' arithmetic (float64 stays float64,
    so that ``gradcheck`` can run the plain versions)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def rms_norm_fwd_plain(x, w, eps: float):
    """Plain B4a, op for op ``_rms_fwd_kernel``: in f32, ``rstd =
    rsqrt(mean(x^2) + eps)`` and ``x * rstd * w`` cast once to x's
    dtype. x: (N, h), w: (h,) -> out (N, h), rstd (N, 1) f32."""
    xf = _f32(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (xf * rstd * _f32(w)).to(x.dtype), rstd


def rms_norm_bwd_plain(x, w, rstd, g):
    """Plain B4b, op for op ``_rms_bwd_kernel`` over all rows at once
    (so no padded row): ``xhat = x * rstd``, ``wg = g * w``, ``dx =
    rstd * (wg - xhat * mean(wg * xhat))`` in x's dtype, and ``dw =
    sum(g * xhat)`` over the rows in f32, cast to w's dtype."""
    xf, wf, gf = _f32(x), _f32(w), _f32(g)
    xhat = xf * rstd
    wg = gf * wf
    m = torch.mean(wg * xhat, dim=-1, keepdim=True)
    dx = (rstd * (wg - xhat * m)).to(x.dtype)
    return dx, torch.sum(gf * xhat, dim=0).to(w.dtype)


def swiglu_fwd_plain(g, u):
    """Plain B5a: ``silu(g) * u`` in f32, cast to g's dtype."""
    gf = _f32(g)
    return (gf * torch.sigmoid(gf) * _f32(u)).to(g.dtype)


def swiglu_bwd_plain(g, u, d):
    """Plain B5b, op for op ``_swiglu_bwd_kernel``: ``dg = d * u *
    dsilu`` with ``dsilu = sig * (1 + g * (1 - sig))`` and ``du = d *
    silu(g)``, each in its input's dtype."""
    gf, uf, df = _f32(g), _f32(u), _f32(d)
    sig = torch.sigmoid(gf)
    silu = gf * sig
    dsilu = sig * (1.0 + gf * (1.0 - sig))
    return (df * uf * dsilu).to(g.dtype), (df * silu).to(u.dtype)


# ---------------- wrappers ----------------
def _check(what: str, *ts: torch.Tensor) -> int:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA
    tensor of the first one's dtype (float32 or bfloat16) and device,
    and the first one's last dim is a multiple of 8; returns that dim."""
    dev, dtype = ts[0].device, ts[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{what}: the kernel needs CUDA tensors, got {dev}")
    if dtype not in _DTYPES:
        raise ValueError(f"{what}: float32 or bfloat16 tensors, got {dtype}")
    for t in ts:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{what}: all tensors must be {dtype} on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be contiguous and "
                             f"16-byte aligned")
    width = ts[0].shape[-1]
    if ts[0].numel() == 0 or width % 8:
        raise ValueError(f"{what}: needs a non-empty tensor whose last dim "
                         f"is a multiple of 8 (16-byte loads), got "
                         f"{tuple(ts[0].shape)}")
    return width


def _check_rows(what: str, x, w, *rest):
    """(N, h) x, (h,) w with h <= MAX_WIDTH, the rest shaped like x."""
    h = _check(what, x, w, *rest)
    if x.dim() != 2 or w.shape != (h,) or h > MAX_WIDTH:
        raise ValueError(f"{what}: x must be (N, h) and w (h,) with h a "
                         f"multiple of 8 up to {MAX_WIDTH}, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    for t in rest:
        if t.shape != x.shape:
            raise ValueError(f"{what}: {tuple(t.shape)} is not x's shape")
    return x.shape[0], h


def _call(what: str, fn: str, *args):
    lib = _build.load("fused", SIGNATURES)
    _build.check(lib, getattr(lib, fn)(*args), what)


def rms_fwd(x, w, eps: float):
    """B4a: ``(out, rstd)`` of x (N, h) and w (h,) — the plain version
    for CPU tensors, the kernel for CUDA tensors (or an error)."""
    if x.device.type == "cpu":
        return rms_norm_fwd_plain(x, w, eps)
    n, h = _check_rows("rms_fwd", x, w)
    out = torch.empty_like(x)
    rstd = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    _call("rms_fwd", "ptt_rms_fwd", x.data_ptr(), w.data_ptr(),
          out.data_ptr(), rstd.data_ptr(), n, h, float(eps),
          _DTYPES[x.dtype], _build.stream_handle(x.device))
    rms_fwd.launches += 1
    return out, rstd


def rms_bwd(x, w, rstd, g):
    """B4b: ``(dx, dw)`` from x (N, h), w (h,), B4a's rstd (N, 1) f32 and
    the cotangent g (N, h) — the plain version for CPU tensors, the
    kernel for CUDA tensors (or an error)."""
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, w, rstd, g)
    n, h = _check_rows("rms_bwd", x, w, g)
    if rstd.shape != (n, 1) or rstd.dtype != torch.float32 \
            or rstd.device != x.device or not rstd.is_contiguous():
        raise ValueError(f"rms_bwd: rstd must be contiguous float32 "
                         f"({n}, 1) on {x.device}")
    dx = torch.empty_like(x)
    blocks = -(-n // RMS_BWD_ROWS)
    dwp = torch.empty((blocks, h), dtype=torch.float32, device=x.device)
    _call("rms_bwd", "ptt_rms_bwd", x.data_ptr(), w.data_ptr(),
          rstd.data_ptr(), g.data_ptr(), dx.data_ptr(), dwp.data_ptr(), n, h,
          RMS_BWD_ROWS, _DTYPES[x.dtype], _build.stream_handle(x.device))
    rms_bwd.launches += 1
    return dx, dwp.sum(dim=0).to(w.dtype)


def _check_same(what: str, *ts):
    _check(what, *ts)
    for t in ts[1:]:
        if t.shape != ts[0].shape:
            raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in ts]}"
                             f" differ")


def swiglu_fwd(g, u):
    """B5a: ``silu(g) * u`` — the plain version for CPU tensors, the
    kernel for CUDA tensors (or an error)."""
    if g.device.type == "cpu":
        return swiglu_fwd_plain(g, u)
    _check_same("swiglu_fwd", g, u)
    out = torch.empty_like(g)
    _call("swiglu_fwd", "ptt_swiglu_fwd", g.data_ptr(), u.data_ptr(),
          out.data_ptr(), g.numel(), _DTYPES[g.dtype],
          _build.stream_handle(g.device))
    swiglu_fwd.launches += 1
    return out


def swiglu_bwd(g, u, d):
    """B5b: ``(dg, du)`` for the cotangent d — the plain version for CPU
    tensors, the kernel for CUDA tensors (or an error)."""
    if g.device.type == "cpu":
        return swiglu_bwd_plain(g, u, d)
    _check_same("swiglu_bwd", g, u, d)
    dg, du = torch.empty_like(g), torch.empty_like(u)
    _call("swiglu_bwd", "ptt_swiglu_bwd", g.data_ptr(), u.data_ptr(),
          d.data_ptr(), dg.data_ptr(), du.data_ptr(), g.numel(),
          _DTYPES[g.dtype], _build.stream_handle(g.device))
    swiglu_bwd.launches += 1
    return dg, du


rms_fwd.launches = 0
rms_bwd.launches = 0
swiglu_fwd.launches = 0
swiglu_bwd.launches = 0


# ---------------- autograd ----------------
class _RMSNorm(torch.autograd.Function):
    """B4a forward on (N, h), saving (x, w, rstd); B4b backward."""

    @staticmethod
    def forward(ctx, x, w, eps: float):
        out, rstd = rms_fwd(x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, rstd = ctx.saved_tensors
        dx, dw = rms_bwd(x, w, rstd, g.contiguous())
        return dx, dw, None


class _SwiGLU(torch.autograd.Function):
    """B5a forward on (N, i), saving (g, u); B5b backward."""

    @staticmethod
    def forward(ctx, g, u):
        ctx.save_for_backward(g, u)
        return swiglu_fwd(g, u)

    @staticmethod
    def backward(ctx, d):
        g, u = ctx.saved_tensors
        return swiglu_bwd(g, u, d.contiguous())


def rms_norm(x, w, eps: float = 1e-6, residual=None):
    """Fused RMSNorm over the last dim (B4a forward, B4b backward). With
    ``residual``, normalises ``x + residual`` and returns ``(out, x +
    residual)``, the reference's ``fused_rms_norm`` contract."""
    if residual is not None:
        x = x + residual
        return rms_norm(x, w, eps), x
    shape = x.shape
    out = _RMSNorm.apply(x.reshape(-1, shape[-1]).contiguous(), w,
                         float(eps))
    return out.reshape(shape)


def swiglu(g, u):
    """Fused ``silu(g) * u`` (B5a forward, B5b backward) on any leading
    shape (a strided view, such as half of a split, is copied first)."""
    shape = g.shape
    out = _SwiGLU.apply(g.reshape(-1, shape[-1]).contiguous(),
                        u.reshape(-1, shape[-1]).contiguous())
    return out.reshape(shape)


# ---------------- B7: decode attention against a contiguous cache ----------
def decode_attention_plain(q, k_cache, v_cache, cache_len, *, scale=None,
                           k_rows=None, v_rows=None):
    """Plain B7, op for op the JAX package's composition in
    ``_attn_with_cache`` at T = 1 without ``kstart``: dequantize int8
    rows as ``(c.float() * rows[..., None]).to(q.dtype)``, repeat the kv
    heads, f32 scores divided by ``sqrt(D)`` (or times ``scale``), the
    ``-1e30`` mask on columns at or past ``cache_len``, softmax, then
    ``p.to(cv.dtype)`` against V.

    q:          (B, H, D) the current position's queries
    k/v_cache:  (B, S, HK, D) padded caches, model dtype or int8
    cache_len:  int or (B,) valid lengths, the current token included
    k/v_rows:   (B, S, HK) f32 per-row dequant scales of int8 caches
    returns (B, H, D) in q's dtype. A row of length 0 gives the mean of
    V here and zeros from the kernel (no path decodes at length 0)."""
    B, H, D = q.shape
    _check_pair(k_rows, v_rows, "decode_attention")
    ck, cv = k_cache, v_cache
    if k_rows is not None:
        ck = (ck.float() * k_rows[..., None]).to(q.dtype)
        cv = (cv.float() * v_rows[..., None]).to(q.dtype)
    nkv = ck.shape[2]
    if nkv != H:
        ck = torch.repeat_interleave(ck, H // nkv, dim=2)
        cv = torch.repeat_interleave(cv, H // nkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q[:, None].float(), ck.float())
    s = s * scale if scale is not None else s / math.sqrt(D)
    lens = torch.as_tensor(cache_len, dtype=torch.int32,
                           device=q.device).broadcast_to((B,))
    kpos = torch.arange(s.shape[3], device=q.device)[None, None, None, :]
    s = torch.where(kpos < lens[:, None, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(cv.dtype), cv)[:, 0]


def launch_decode(q, k_cache, v_cache, cache_len, *, scale=None,
                  k_rows=None, v_rows=None, splits=None) -> torch.Tensor:
    """Launch ``ptt_decode_attention`` (B7) on CUDA tensors. The caches
    may be strided views (a layer of the dense ``(L, B, S, HK, D)``
    cache) whose rows are contiguous and 16-byte aligned. The kernel
    reads the lengths on the device: a ``(B,)`` int32 tensor there is
    used as it is, an int becomes one without a host sync (a caller
    that decodes through many layers builds the tensor once).
    ``splits`` (one of :data:`DECODE_SPLITS`, bf16 queries only) forces
    the key split that the kernel otherwise chooses from the shape, to
    time the choice against the others. Validates every input and
    raises on what the kernel does not take; never falls back."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: the kernel needs CUDA tensors, "
                         f"got {dev}")
    _check_pair(k_rows, v_rows, "decode_attention")
    if q.dim() != 3 or q.dtype not in _DTYPES:
        raise ValueError(f"decode_attention: q must be (B, H, D) float32 or "
                         f"bfloat16, got {tuple(q.shape)} {q.dtype}")
    B, H, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("decode_attention: k/v caches must share one "
                         "(B, S, HK, D) shape")
    Bc, S, HK, Dk = k_cache.shape
    if Bc != B or S == 0:
        raise ValueError(f"decode_attention: cache {tuple(k_cache.shape)} "
                         f"does not serve q {tuple(q.shape)}")
    if Dk != D or D not in DECODE_HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} (cache {Dk}); the "
                         f"kernel takes {DECODE_HEAD_DIMS}")
    if H % HK or H // HK > DECODE_MAX_REP:
        raise ValueError(f"decode_attention: H={H} must be a multiple of "
                         f"HK={HK} with at most {DECODE_MAX_REP} query heads "
                         f"per kv head")
    if splits is not None and (splits not in DECODE_SPLITS
                               or q.dtype != torch.bfloat16):
        raise ValueError(f"decode_attention: splits={splits} needs bfloat16 "
                         f"queries and one of {DECODE_SPLITS}")
    quant = k_rows is not None
    kv_dtype = torch.int8 if quant else q.dtype
    for t, nm in ((k_cache, "k_cache"), (v_cache, "v_cache")):
        if t.dtype != kv_dtype or t.device != dev:
            raise ValueError(f"decode_attention: {nm} must be {kv_dtype} on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if t.stride(3) != 1 or not _aligned(t, (0, 1, 2)):
            raise ValueError(f"decode_attention: {nm} rows must be "
                             f"contiguous and 16-byte aligned")
    if k_cache.stride() != v_cache.stride():
        raise ValueError("decode_attention: k/v caches must share strides")
    sc_strides = (0, 0, 0)
    if quant:
        for t, nm in ((k_rows, "k_rows"), (v_rows, "v_rows")):
            if (t.shape != (B, S, HK) or t.dtype != torch.float32
                    or t.device != dev):
                raise ValueError(f"decode_attention: {nm} must be float32 "
                                 f"(B, S, HK) on {dev}")
        if k_rows.stride() != v_rows.stride():
            raise ValueError("decode_attention: k/v row scales must share "
                             "strides")
        sc_strides = k_rows.stride()
    q = q.contiguous()
    if not _aligned(q):
        raise ValueError("decode_attention: q must be 16-byte aligned")
    if isinstance(cache_len, int):
        lens = torch.full((B,), cache_len, dtype=torch.int32, device=dev)
    else:
        lens = torch.as_tensor(cache_len, device=dev).to(
            torch.int32).broadcast_to((B,)).contiguous()
    out = torch.empty_like(q)
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    lib = _build.load("decode_attention", DECODE_SIGNATURES)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (ptr(q), ptr(k_cache), ptr(v_cache), ptr(k_rows), ptr(v_rows),
            ptr(lens), ptr(out), B, H, HK, D, S, *k_cache.stride()[:3],
            *sc_strides, float(s), _DTYPES[q.dtype], int(quant))
    if splits is None:
        rc = lib.ptt_decode_attention(*args, _build.stream_handle(dev))
    else:
        rc = lib.ptt_decode_attention_splits(*args, splits,
                                             _build.stream_handle(dev))
    _build.check(lib, rc, "decode_attention")
    return out


def decode_attention(q, k_cache, v_cache, cache_len, *, scale=None,
                     k_rows=None, v_rows=None):
    """B7 decode attention (shapes: :func:`decode_attention_plain`): the
    plain version for CPU tensors, the kernel for CUDA tensors (or an
    error)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      scale=scale, k_rows=k_rows,
                                      v_rows=v_rows)
    out = launch_decode(q, k_cache, v_cache, cache_len, scale=scale,
                        k_rows=k_rows, v_rows=v_rows)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


# ---------------- B6: fused RoPE ----------------
def rope_plain(x, cos, sin, sign: float = 1.0):
    """Plain B6, op for op ``_rope_kernel``: in f32, ``o1 = x1 * c - x2 *
    s`` and ``o2 = x2 * c + x1 * s`` with ``s = sin * sign``, cast once
    to x's dtype. x: (B, S, H, D); cos/sin: (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = _f32(x[..., :half]), _f32(x[..., half:])
    c = _f32(cos)[None, :, None, :]
    s = _f32(sin)[None, :, None, :] * sign
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def launch_rope(x, cos, sin, sign: float = 1.0) -> torch.Tensor:
    """Launch ``ptt_rope`` (B6) on a CUDA x (B, S, H, D), read through
    its strides (a view of a fused qkv tensor needs no copy; only a last
    dim that is not contiguous is copied), into a new contiguous tensor.
    Validates every input and raises on what the kernel does not take;
    never falls back."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rope: the kernel needs CUDA tensors, got {dev}")
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise ValueError(f"rope: x must be (B, S, H, D) float32 or bfloat16, "
                         f"got {tuple(x.shape)} {x.dtype}")
    B, S, H, D = x.shape
    half = D // 2
    if D % 2 or x.numel() == 0:
        raise ValueError(f"rope: needs a non-empty x with an even head dim, "
                         f"got {tuple(x.shape)}")
    tables = []
    for t, nm in ((cos, "cos"), (sin, "sin")):
        if tuple(t.shape) != (S, half) or t.device != dev:
            raise ValueError(f"rope: {nm} must be ({S}, {half}) on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
        t = t.to(torch.float32).contiguous()
        tables.append(t if t.data_ptr() % 16 == 0 else t.clone())
    if x.stride(3) != 1:
        x = x.contiguous()
    strides = x.stride()[:3]
    esz = x.element_size()
    vec = 16 // esz
    while vec > 1 and (half % vec or any(st % vec for st in strides)
                       or x.data_ptr() % (vec * esz)):
        vec //= 2
    out = torch.empty((B, S, H, D), dtype=x.dtype, device=dev)
    lib = _build.load("rope", ROPE_SIGNATURES)
    rc = lib.ptt_rope(x.data_ptr(), tables[0].data_ptr(),
                      tables[1].data_ptr(), out.data_ptr(), B, S, H, half,
                      *strides, float(sign), _DTYPES[x.dtype], vec,
                      _build.stream_handle(dev))
    _build.check(lib, rc, "rope")
    return out


def rope_apply(x, cos, sin, sign: float = 1.0):
    """B6 (shapes: :func:`rope_plain`): the plain version for CPU
    tensors, the kernel for CUDA tensors (or an error)."""
    if x.device.type == "cpu":
        return rope_plain(x, cos, sin, sign)
    out = launch_rope(x, cos, sin, sign)
    rope_apply.launches += 1
    return out


rope_apply.launches = 0


class _RopeQK(torch.autograd.Function):
    """B6 on q and on k, one launch each; the VJP is the rotation by
    -theta (``sign`` -1), as ``_rope_qk_bwd``, and the tables get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, cos, sin):
        ctx.save_for_backward(cos, sin)
        return rope_apply(q, cos, sin, 1.0), rope_apply(k, cos, sin, 1.0)

    @staticmethod
    def backward(ctx, dq, dk):
        cos, sin = ctx.saved_tensors
        return (rope_apply(dq, cos, sin, -1.0), rope_apply(dk, cos, sin, -1.0),
                None, None)


def rope_qk(q, k, cos, sin):
    """Fused neox RoPE on q (B, S, H, D) and k (B, S, HK, D), the JAX
    package's ``rope_qk``: cos/sin are (S, D/2) half tables or (S, D)
    repeated-half ones (cut to their first half), used in float32."""
    half = q.shape[-1] // 2
    if cos.shape[-1] == 2 * half:    # repeated-half layout: halves equal
        cos, sin = cos[:, :half], sin[:, :half]
    return _RopeQK.apply(q, k, cos.float().contiguous(),
                         sin.float().contiguous())


# ---------------- B8: decode attention over a head-major page pool --------
def _dequant_rows(sc, B: int):
    """(HK,) or (B, HK) dequant scales as (B, HK) f32, the TPU wrapper's
    per-grid-row scalars (``_rows``)."""
    sc = sc.float()
    return sc.expand(B, -1) if sc.dim() == 1 else sc


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables,
                                 cache_len, *, scale=None,
                                 k_dequant_scale=None,
                                 v_dequant_scale=None):
    """Plain B8, op for op the JAX package's ``paged_decode_attention``
    with ``_decode_softmax_step``: page by page of the block table (-1
    entries clamped to page 0), int8 pages dequantized as ``(k.float() *
    s).to(q.dtype)``, V rows at or past ``cache_len`` zeroed, f32 scores
    times ``scale`` (default ``1/sqrt(D)``) masked with the TPU mask
    value, an online softmax with p cast to V's dtype before the
    product, and ``acc / l`` (a row of length 0 gives zeros).

    q:            (B, H, D) current queries
    k/v_pages:    (P, HK, page, D) head-major page pool
    block_tables: (B, ppseq) int page ids
    cache_len:    int or (B,) valid lengths, current token included
    k/v_dequant_scale: (HK,) or (B, HK) f32 scales of int8 pages
    returns (B, H, D) in q's dtype."""
    _check_pair(k_dequant_scale, v_dequant_scale, "paged_decode_attention")
    B, H, D = q.shape
    HK, page = k_pages.shape[1], k_pages.shape[2]
    rep = H // HK
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    bt = torch.clamp(torch.as_tensor(block_tables, device=dev).long(), min=0)
    lens = torch.as_tensor(cache_len, dtype=torch.int32,
                           device=dev).broadcast_to((B,))[:, None, None, None]
    quant = k_dequant_scale is not None
    if quant:
        ks = _dequant_rows(k_dequant_scale, B)[:, :, None, None]
        vs = _dequant_rows(v_dequant_scale, B)[:, :, None, None]
    qt = _f32(q.reshape(B, HK, rep, D))
    acc = torch.zeros((B, HK, rep, D), dtype=qt.dtype, device=dev)
    m = torch.full((B, HK, rep, 1), -math.inf, dtype=qt.dtype, device=dev)
    l = torch.zeros_like(m)
    mask_value = -0.7 * torch.finfo(torch.float32).max
    for j in range(bt.shape[1]):
        kk, vv = k_pages[bt[:, j]], v_pages[bt[:, j]]      # (B, HK, page, D)
        if quant:
            kk = (kk.float() * ks).to(q.dtype)
            vv = (vv.float() * vs).to(q.dtype)
        pos = j * page + torch.arange(page, device=dev)
        live = pos[None, None, None, :] < lens               # (B, 1, 1, page)
        vv = torch.where(live.transpose(-1, -2), vv, torch.zeros_like(vv))
        sc = torch.matmul(qt, _f32(kk).transpose(-1, -2)) * s
        sc = torch.where(live, sc, mask_value)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(live, torch.exp(sc - m_new), 0.0)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(_f32(p.to(vv.dtype)), _f32(vv))
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.to(q.dtype).reshape(B, H, D)


def launch_paged_decode_hm(q, k_pages, v_pages, block_tables, cache_len, *,
                           scale=None, k_dequant_scale=None,
                           v_dequant_scale=None,
                           splits=None) -> torch.Tensor:
    """Launch ``ptt_paged_decode_hm`` (B8) on CUDA tensors. The pools may
    be strided views whose rows are contiguous and 16-byte aligned.
    ``splits`` (one of :data:`DECODE_SPLITS`, bf16 queries only) forces
    the key split that the kernel otherwise chooses from the shape, to
    time the choice against the others. Validates every input and raises
    on what the kernel does not take; never falls back."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention: the kernel needs CUDA "
                         f"tensors, got {dev}")
    _check_pair(k_dequant_scale, v_dequant_scale, "paged_decode_attention")
    if q.dim() != 3 or q.dtype not in _DTYPES:
        raise ValueError(f"paged_decode_attention: q must be (B, H, D) "
                         f"float32 or bfloat16, got {tuple(q.shape)} "
                         f"{q.dtype}")
    B, H, D = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("paged_decode_attention: k/v pools must share one "
                         "(P, HK, page, D) shape")
    P, HK, page, Dk = k_pages.shape
    if Dk != D or D not in DECODE_HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head dim {D} (pool {Dk}); "
                         f"the kernel takes {DECODE_HEAD_DIMS}")
    if H % HK or H // HK > DECODE_MAX_REP:
        raise ValueError(f"paged_decode_attention: H={H} must be a multiple "
                         f"of HK={HK} with at most {DECODE_MAX_REP} query "
                         f"heads per kv head")
    if splits is not None and (splits not in DECODE_SPLITS
                               or q.dtype != torch.bfloat16):
        raise ValueError(f"paged_decode_attention: splits={splits} needs "
                         f"bfloat16 queries and one of {DECODE_SPLITS}")
    quant = k_dequant_scale is not None
    kv_dtype = torch.int8 if quant else q.dtype
    for t, nm in ((k_pages, "k_pages"), (v_pages, "v_pages")):
        if t.dtype != kv_dtype or t.device != dev:
            raise ValueError(f"paged_decode_attention: {nm} must be "
                             f"{kv_dtype} on {dev}, got {t.dtype} on "
                             f"{t.device}")
        if t.stride(3) != 1 or not _aligned(t, (0, 1, 2)):
            raise ValueError(f"paged_decode_attention: {nm} rows must be "
                             f"contiguous and 16-byte aligned")
    if k_pages.stride() != v_pages.stride():
        raise ValueError("paged_decode_attention: k/v pools must share "
                         "strides")
    ks = vs = None
    sc_strides = (0, 0)
    if quant:
        ks, vs = (_dequant_rows(t.to(dev), B).contiguous()
                  for t in (k_dequant_scale, v_dequant_scale))
        if ks.shape != (B, HK) or vs.shape != (B, HK):
            raise ValueError(f"paged_decode_attention: dequant scales must "
                             f"be ({HK},) or ({B}, {HK})")
        sc_strides = ks.stride()
    q = q.contiguous()
    if not _aligned(q):
        raise ValueError("paged_decode_attention: q must be 16-byte aligned")
    bt = torch.as_tensor(block_tables, device=dev).to(torch.int32)
    if bt.dim() != 2 or bt.shape[0] != B or bt.shape[1] == 0:
        raise ValueError("paged_decode_attention: block_tables must be "
                         "(B, ppseq)")
    lens = torch.as_tensor(cache_len, device=dev).to(
        torch.int32).broadcast_to((B,)).contiguous()
    out = torch.empty_like(q)
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    lib = _build.load("decode_attention", DECODE_SIGNATURES)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (ptr(q), ptr(k_pages), ptr(v_pages), ptr(ks), ptr(vs),
            ptr(bt.contiguous()), ptr(lens), ptr(out), B, H, HK, D, page,
            bt.shape[1], *k_pages.stride()[:3], *sc_strides, float(s),
            _DTYPES[q.dtype], int(quant))
    if splits is None:
        rc = lib.ptt_paged_decode_hm(*args, _build.stream_handle(dev))
    else:
        rc = lib.ptt_paged_decode_hm_splits(*args, splits,
                                            _build.stream_handle(dev))
    _build.check(lib, rc, "paged_decode_attention")
    return out


def paged_decode_attention(q, k_pages, v_pages, block_tables, cache_len, *,
                           scale=None, k_dequant_scale=None,
                           v_dequant_scale=None):
    """B8 decode attention over a head-major page pool (shapes:
    :func:`paged_decode_attention_plain`): the plain version for CPU
    tensors, the kernel for CUDA tensors (or an error)."""
    kw = dict(scale=scale, k_dequant_scale=k_dequant_scale,
              v_dequant_scale=v_dequant_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages,
                                            block_tables, cache_len, **kw)
    out = launch_paged_decode_hm(q, k_pages, v_pages, block_tables,
                                 cache_len, **kw)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
