"""B4-B5 fused RMSNorm and SwiGLU for the training model.

Counterpart of the RMSNorm and SwiGLU half of
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
multiples of 8 (16-byte loads); RMSNorm rows up to ``MAX_WIDTH``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

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
