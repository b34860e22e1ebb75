"""B4-B5 fused RMSNorm and SwiGLU for the training model, and B7 decode
attention against a contiguous KV cache for dense ``generate``.

Counterpart of the RMSNorm, SwiGLU and decode-attention parts of
``paddle_tpu/ops/pallas/fused.py``:

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
  ``_decode_kernel`` / ``_decode_kernel_qrow``).
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
multiples of 8 (16-byte loads); RMSNorm rows up to ``MAX_WIDTH``. B7
takes float32 and bfloat16 queries, caches of q's dtype or int8, head
dims 64 and 128 and at most 8 query heads per kv head.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .paged_attention import _aligned, _check_pair

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
        _P, _I, _P,                     # lengths (or NULL), len_all, out
        _I, _I, _I, _I, _I,             # B, H, HK, D, S
        _L, _L, _L, _L, _L, _L,         # cache strides, scale strides
        ctypes.c_float, _I, _I, _P),    # scale, q dtype, kv int8, stream
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
    out = _RMSNorm.apply(x.reshape(-1, shape[-1]), w, float(eps))
    return out.reshape(shape)


def swiglu(g, u):
    """Fused ``silu(g) * u`` (B5a forward, B5b backward) on any leading
    shape."""
    shape = g.shape
    out = _SwiGLU.apply(g.reshape(-1, shape[-1]), u.reshape(-1, shape[-1]))
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
                  k_rows=None, v_rows=None) -> torch.Tensor:
    """Launch ``ptt_decode_attention`` (B7) on CUDA tensors. The caches
    may be strided views (a layer of the dense ``(L, B, S, HK, D)``
    cache) whose rows are contiguous and 16-byte aligned. ``cache_len``
    as an int reaches the kernel as an argument; as a tensor it is used
    on the device, with no host sync. Validates every input and raises
    on what the kernel does not take; never falls back."""
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
    lens, len_all = None, 0
    if isinstance(cache_len, int):
        len_all = cache_len
    else:
        lens = torch.as_tensor(cache_len, device=dev).to(
            torch.int32).broadcast_to((B,)).contiguous()
    out = torch.empty_like(q)
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    lib = _build.load("decode_attention", DECODE_SIGNATURES)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.ptt_decode_attention(
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(k_rows), ptr(v_rows),
        ptr(lens), int(len_all), ptr(out), B, H, HK, D, S,
        *k_cache.stride()[:3], *sc_strides, float(s), _DTYPES[q.dtype],
        int(quant), _build.stream_handle(dev))
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
