"""Llama-family config, parameters and model for the port.

Counterpart of ``paddle_tpu/models/llama.py`` on one device: the config
and its presets, the parameter tree (same leaf names, same stacked
``(L, in, out)`` layout, same init law), the building blocks
(``rms_norm``, ``rope_tables``, ``apply_rope``, ``_attention``,
``_block``), the trunk with its ``remat`` policies, ``forward`` and the
next-token ``loss_fn`` with ``seq_chunk``. Parameters are a plain dict
of tensors, as the JAX package keeps a pytree; random numbers come from
a ``torch.Generator`` and so differ from ``jax.random``'s for the same
seed (``convert.params_from_jax`` carries JAX's own values across).
``moe=`` an :class:`~.moe.MoEConfig` replaces every layer's SwiGLU MLP
by routed experts (``models/moe.py``), whose load-balance and z losses
the trunk sums over the layers and ``loss_fn`` adds. Meshes
(``mesh_axes``, ``param_specs``, expert parallelism) and context
parallelism are not ported: see ROADMAP.md, queue A.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import DeviceLike, resolve_device
from ..ops.kernels import flash_attention as _fa
from ..ops.kernels import fused as _fk
from .moe import MoEConfig, moe_ffn

#: "nothing" recomputes the whole layer in backward (least memory);
#: "attn" keeps the attention output (backward still recomputes the
#: flash forward, whose own outputs are not kept);
#: "dots" keeps every matrix product's output (most memory, least work)
REMAT_POLICIES = ("nothing", "attn", "dots")
FUSED_KERNELS = ("xla", "auto", "pallas")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    remat: bool = True
    remat_policy: str = "nothing"
    # "xla" = RMSNorm and SwiGLU in plain torch, the JAX package's
    # default; "auto" and "pallas" both select the fused functions of
    # ops/kernels/fused.py (B4, B5), whose wrappers launch the kernels
    # for CUDA tensors and run the plain versions for CPU tensors: the
    # JAX package's "Pallas on a TPU, interpret mode elsewhere" with "on
    # a TPU" read as "on CUDA tensors". The serving forwards ignore it,
    # as the JAX package's do.
    fused_kernels: str = "xla"
    moe: Optional[MoEConfig] = None     # experts replace the dense MLP

    def __post_init__(self):
        if self.fused_kernels not in FUSED_KERNELS:
            raise ValueError(f"fused_kernels={self.fused_kernels!r}: one "
                             f"of {FUSED_KERNELS}")
        if self.moe is not None and not isinstance(self.moe, MoEConfig):
            raise NotImplementedError(
                f"moe={self.moe!r}: the port takes a models.moe.MoEConfig "
                f"on one device; other MoE forms are not ported — see "
                f"ROADMAP.md, queue A step 8 (MoE EP training)")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy={self.remat_policy!r}: one of "
                             f"{REMAT_POLICIES}")

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    # ---- presets (sizes follow the public Llama-2 family) ----
    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_13b(**kw) -> "LlamaConfig":
        return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                           num_layers=40, num_heads=40, num_kv_heads=40, **kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Small config for tests / dry runs."""
        d = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                 num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
                 dtype=torch.float32, remat=False)
        d.update(kw)
        return LlamaConfig(**d)

    def num_params(self) -> int:
        h, i, v, L = (self.hidden_size, self.intermediate_size,
                      self.vocab_size, self.num_layers)
        hd, nh, nkv = self.hd, self.num_heads, self.num_kv_heads
        if self.moe is None:
            mlp = 3 * h * i
        else:
            mlp = self.moe.num_experts * 3 * h * i + h * self.moe.num_experts
        per_layer = (h * nh * hd + 2 * h * nkv * hd + nh * hd * h  # attn
                     + mlp + 2 * h)                        # mlp, 2 rmsnorm
        emb = v * h * (1 if self.tie_embeddings else 2)
        return L * per_layer + emb + h

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs/token (fwd+bwd ~ 6*N_matmul + attention term).

        The input-embedding table is a gather, not a matmul, so it is
        excluded from N (the lm_head matmul is real compute and stays).
        """
        n = self.num_params() - self.vocab_size * self.hidden_size * (
            0 if self.tie_embeddings else 1)
        attn = 12 * self.num_layers * self.num_heads * self.hd * seq_len
        return 6.0 * n + attn


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict:
    """Random parameters with the JAX package's leaf names, stacked
    layout and init law: projections ``N(0, 1/fan_in)``, embedding
    ``N(0, 0.02^2)``, norms ones, each drawn in float32 and cast to
    ``cfg.dtype``. Stacked leaves are drawn one layer at a time, so the
    float32 draw never holds a whole stack at once. ``generator`` must
    live on ``device``. An MoE config takes the JAX package's expert
    leaves in place of ``wg``/``wu``/``wd``: ``moe_gate`` (L, h, E),
    kept in float32, and the expert stacks ``moe_wg`` / ``moe_wu`` (L,
    E, h, i) and ``moe_wd`` (L, E, i, h)."""
    dev = resolve_device(device)
    h, i, v, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_layers)
    hd, nh, nkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads

    def norm(shape, fan_in=None, dtype=cfg.dtype):
        s = 0.02 if fan_in is None else 1.0 / math.sqrt(fan_in)
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * s).to(dtype)

    def stacked(shape, fan_in, dtype=cfg.dtype):
        out = torch.empty((L,) + shape, dtype=dtype, device=dev)
        for l in range(L):
            out[l] = norm(shape, fan_in, dtype)
        return out

    layers = {
        "wq": stacked((h, nh * hd), h),
        "wk": stacked((h, nkv * hd), h),
        "wv": stacked((h, nkv * hd), h),
        "wo": stacked((nh * hd, h), nh * hd),
        "attn_norm": torch.ones((L, h), dtype=cfg.dtype, device=dev),
        "mlp_norm": torch.ones((L, h), dtype=cfg.dtype, device=dev),
    }
    if cfg.moe is None:
        layers.update({
            "wg": stacked((h, i), h),
            "wu": stacked((h, i), h),
            "wd": stacked((i, h), i),
        })
    else:
        E = cfg.moe.num_experts
        layers.update({
            "moe_gate": stacked((h, E), h, torch.float32),
            "moe_wg": stacked((E, h, i), h),
            "moe_wu": stacked((E, h, i), h),
            "moe_wd": stacked((E, i, h), i),
        })
    params = {
        "embed": norm((v, h)),
        "final_norm": torch.ones((h,), dtype=cfg.dtype, device=dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = norm((h, v), fan_in=h)
    return params


def layer_params(params: Dict, l: int) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s slice of the stacked layer leaves (views, no copy)
    — the port's stand-in for the JAX package's ``lax.scan`` over the
    stacked layer axis."""
    return {name: w[l] for name, w in params["layers"].items()}


def _pallas_fused(cfg: LlamaConfig, x: torch.Tensor) -> bool:
    """Whether the training model takes the fused RMSNorm and SwiGLU on
    ``x``: always under "pallas", under "auto" only for CUDA tensors —
    the JAX package's rule (``_fa.available()``) with "where the kernels
    run" read as "on the card". On the CPU "auto" is the "xla"
    composition, bit for bit."""
    if cfg.fused_kernels == "pallas":
        return True
    return cfg.fused_kernels == "auto" and x.device.type == "cuda"


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             fused: bool = False) -> torch.Tensor:
    """Normalise in float32, cast back to ``x.dtype``, then scale by
    ``w`` — the JAX package's cast order. ``fused`` takes the fused op
    (kernels B4a/B4b), which scales in float32 before its one cast."""
    if fused:
        return _fk.rms_norm(x, w, eps)
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_tables(seq_len: int, hd: int, theta: float,
                device: DeviceLike = None,
                dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(seq_len, hd/2) cos and sin tables of the rotate-half RoPE."""
    dev = resolve_device(device)
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=dev) / hd))
    t = torch.arange(seq_len, dtype=torch.float32, device=dev)
    freqs = torch.outer(t, inv)                    # (S, hd/2)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin (S, hd/2); rotate-half formulation in
    the promoted (float32) type, cast back to ``x.dtype``."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def _w(lp: Dict, name: str, dtype: torch.dtype) -> torch.Tensor:
    """Weight fetch, dequantized on the fly where ``quantize_weights``
    (``generate.py``) left a ``name + "_scale"`` leaf beside it:
    per-channel int8 (scale ``(out,)``) or per-group int4 (scale ``(G,
    out)``, int4 values held in int8). The JAX package's ``_w`` op for
    op: cast to ``dtype``, then multiply by the scale cast to ``dtype``.
    An unquantized weight comes back as it is."""
    w = lp[name]
    s = lp.get(name + "_scale")
    if s is None:
        return w
    if s.dim() == w.dim():                # per-group: (G, out) vs (in, out)
        gct = s.shape[-2]
        wf = w.to(dtype).reshape(w.shape[:-2] + (gct, w.shape[-2] // gct,
                                                 w.shape[-1]))
        return (wf * s[..., :, None, :].to(dtype)).reshape(w.shape)
    return w.to(dtype) * s[None, :].to(dtype)


def _mlp(x, lp, cfg: LlamaConfig, fused: bool = False):
    """Residual SwiGLU MLP: SiLU of the gate in f32, cast back to the
    model dtype before the product with the up projection; ``fused``
    takes the fused RMSNorm and SwiGLU (B4, B5) instead, one cast each.
    The serving forwards call it unfused whatever the config says, on
    weights that may be quantized (:func:`_w`)."""
    h2 = rms_norm(x, lp["mlp_norm"], cfg.rms_eps, fused=fused)
    g = h2 @ _w(lp, "wg", x.dtype)
    u = h2 @ _w(lp, "wu", x.dtype)
    if fused:
        return x + _fk.swiglu(g, u) @ _w(lp, "wd", x.dtype)
    return x + (F.silu(g.float()).to(x.dtype) * u) @ _w(lp, "wd", x.dtype)


def _attention(q, k, v, causal: bool = True):
    """(B, S, H, hd) attention, k/v with HK heads (GQA).

    The JAX package's dispatch rule, with "on a TPU" read as "on CUDA
    tensors": CUDA tensors with ``S % 128 == 0`` and ``hd >= 64`` go to
    :func:`flash_attention` (kernels B1-B3; a head dim other than 64 or
    128 raises there); everything else takes the einsum path below, op
    for op the JAX package's (f32 scores, ``-1e30`` mask, softmax cast to
    the model dtype before the product with v). This is the reference's
    own split of shapes, not a fallback: a CPU tensor never reaches a
    kernel, a CUDA tensor of a flash shape never reaches the einsum."""
    if q.device.type == "cuda" and q.shape[1] % 128 == 0 \
            and q.shape[-1] >= 64:
        return _fa.flash_attention(q, k, v, causal=causal)
    b, sq, h, hd = q.shape
    hk = k.shape[2]
    if hk != h:
        k = torch.repeat_interleave(k, h // hk, dim=2)
        v = torch.repeat_interleave(v, h // hk, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (1.0 / math.sqrt(hd))
    if causal:
        mask = torch.ones((sq, sq), dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _attn_out(x, lp, cos, sin, cfg: LlamaConfig):
    """The layer up to the attention output (B, S, nh * hd), the tensor
    the JAX package names ``attn_out``: RMSNorm, q/k/v projections,
    RoPE, attention."""
    B, S, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    h1 = rms_norm(x, lp["attn_norm"], cfg.rms_eps,
                  fused=_pallas_fused(cfg, x))
    q = (h1 @ lp["wq"]).reshape(B, S, nh, hd)
    k = (h1 @ lp["wk"]).reshape(B, S, nkv, hd)
    v = (h1 @ lp["wv"]).reshape(B, S, nkv, hd)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return _attention(q, k, v, causal=True).flatten(2)


def _post_attention(x, o, lp, cfg: LlamaConfig):
    """The layer after attention: o-projection, residual, MLP. Returns
    (x, aux): aux is the MoE layer's load-balance plus z loss, None for
    a dense layer. The experts take the fused RMSNorm where the config
    asks for it, and no fused SwiGLU: the JAX ``moe_ffn`` has none."""
    fused = _pallas_fused(cfg, x)
    x = x + o @ lp["wo"]
    if cfg.moe is None:
        return _mlp(x, lp, cfg, fused=fused), None
    h2 = rms_norm(x, lp["mlp_norm"], cfg.rms_eps, fused=fused)
    ff, losses = moe_ffn(h2, {"w_gate": lp["moe_gate"], "wg": lp["moe_wg"],
                              "wu": lp["moe_wu"], "wd": lp["moe_wd"]},
                         cfg.moe)
    return x + ff, losses["aux_loss"] + losses["z_loss"]


def _block(x, lp, cos, sin, cfg: LlamaConfig):
    """One decoder layer on one device. lp = the layer's params. Returns
    (x, aux), as :func:`_post_attention`."""
    return _post_attention(x, _attn_out(x, lp, cos, sin, cfg), lp, cfg)


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"`` (JAX's
    ``dots_with_no_batch_dims_saveable``): keep the output of every
    un-batched matrix product, recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_remat = functools.partial(checkpoint, use_reentrant=False,
                           preserve_rng_state=False)


def _layer(x, lp, cos, sin, cfg: LlamaConfig):
    """``_block`` under the config's remat policy. "nothing" checkpoints
    the layer whole, so backward runs its forward again (flash B1
    included). "attn" (JAX's ``save_only_these_names("attn_out")``)
    keeps only the layer input and the attention output: the half up to
    the attention output and the half after it are checkpointed apart,
    so backward recomputes the second from the kept output and the first,
    B1 included, from the input. "dots" checkpoints the layer with a
    selective policy that keeps the matrix products' outputs."""
    if not cfg.remat:
        return _block(x, lp, cos, sin, cfg)
    if cfg.remat_policy == "nothing":
        return _remat(_block, x, lp, cos, sin, cfg)
    if cfg.remat_policy == "attn":
        o = _remat(_attn_out, x, lp, cos, sin, cfg)
        return _remat(_post_attention, x, o, lp, cfg)
    return _remat(_block, x, lp, cos, sin, cfg, context_fn=functools.partial(
        create_selective_checkpoint_contexts, _save_matmuls))


def _trunk(params, tokens, cfg: LlamaConfig):
    """-> (final-norm hidden states (B, S, H), the layers' summed MoE aux
    loss, a f32 scalar, or None for a dense model). The JAX package's
    ``lax.scan`` over the stacked layer axis is a loop over the layers'
    slices; ``unbind`` takes them all at once so that backward stacks
    the layers' gradients in one op. Each layer's aux comes out of its
    checkpointed block with its output."""
    x = params["embed"][tokens.long()].to(cfg.dtype)
    cos, sin = rope_tables(tokens.shape[1], cfg.hd, cfg.rope_theta,
                           device=x.device)
    stacks = {name: w.unbind(0) for name, w in params["layers"].items()}
    aux = None
    for l in range(cfg.num_layers):
        lp = {name: ws[l] for name, ws in stacks.items()}
        x, a = _layer(x, lp, cos, sin, cfg)
        if a is not None:
            aux = a if aux is None else aux + a
    return rms_norm(x, params["final_norm"], cfg.rms_eps,
                    fused=_pallas_fused(cfg, x)), aux


def _lm_head(params, cfg: LlamaConfig, dtype) -> torch.Tensor:
    """The output projection in ``dtype``: the tied embedding's
    transpose, or ``lm_head`` (dequantized when quantized)."""
    head = (params["embed"].T if cfg.tie_embeddings
            else _w(params, "lm_head", dtype))
    return head.to(dtype)


def forward(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
            return_hidden: bool = False) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, V) float32 (or the final-norm
    hidden states (B, S, H) when ``return_hidden``)."""
    x, _ = _trunk(params, tokens, cfg)
    if return_hidden:
        return x
    return (x @ _lm_head(params, cfg, x.dtype)).float()


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position cross-entropy, f32 logits."""
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - ll


def _chunk_ce_sum(h, head, labels, mask):
    return (_ce((h @ head).float(), labels) * mask).sum()


def next_token_loss(h: torch.Tensor, head: torch.Tensor,
                    tokens: torch.Tensor,
                    seq_chunk: Optional[int] = None) -> torch.Tensor:
    """Next-token cross-entropy of hidden states ``h`` (B, S, H) through
    ``head`` (H, V), mean over B*(S-1): labels roll by one and the last
    position is masked out. ``seq_chunk`` computes the (B, chunk, V) f32
    logits one chunk at a time and recomputes each chunk's logits in
    backward, so the (B, S, V) logits are never held whole; it must
    divide S. Shared by the Llama and GPT losses, whose JAX bodies are
    the same."""
    B, S, _ = h.shape
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).long()
    mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    mask[:, -1] = 0.0
    denom = float(B * (S - 1))
    if seq_chunk is not None and S % seq_chunk != 0:
        raise ValueError(
            f"seq_chunk={seq_chunk} must divide seq_len={S}; a silent dense "
            f"fallback would materialize the full f32 logits")
    if seq_chunk is None:
        return _chunk_ce_sum(h, head, labels, mask) / denom
    total = 0.0
    for c in range(0, S, seq_chunk):
        sl = slice(c, c + seq_chunk)
        total = total + _remat(_chunk_ce_sum, h[:, sl], head,
                               labels[:, sl], mask[:, sl])
    return total / denom


def loss_fn(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
            seq_chunk: Optional[int] = None) -> torch.Tensor:
    """Next-token cross-entropy (mean over B*(S-1)), as the JAX package's:
    the forward runs on the full sequence and the last position is
    masked out of the loss (:func:`next_token_loss`). An MoE model adds
    its layers' summed load-balance and z losses (:func:`_trunk`)."""
    h, aux = _trunk(params, tokens, cfg)
    loss = next_token_loss(h, _lm_head(params, cfg, h.dtype), tokens,
                           seq_chunk)
    return loss if aux is None else loss + aux
