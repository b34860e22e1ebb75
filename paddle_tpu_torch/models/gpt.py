"""GPT-2 family: config, parameters and model for the port.

Counterpart of ``paddle_tpu/models/gpt.py`` on one device: the config
and its presets, the parameter tree (same leaf names, same stacked
``(L, in, out)`` layout, same init law), pre-LayerNorm blocks with a
fused qkv projection and a tanh-GELU MLP, learned positions, the trunk
under remat, ``forward`` and the next-token ``loss_fn`` through the
embedding tied as the head. The attention is the Llama model's
(``llama._attention``), as the JAX file imports it: CUDA tensors at
``S % 128 == 0`` take the flash kernels B1-B3 (head dim 64 in every
preset). ``param_specs`` and the mesh are not ported: see ROADMAP.md,
queue A step 8.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .llama import _attention, _remat, next_token_loss


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304            # 50257 padded to a multiple of 128
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    ln_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def gpt2_124m(**kw) -> "GPTConfig":
        return GPTConfig(**kw)

    @staticmethod
    def gpt2_medium(**kw) -> "GPTConfig":
        return GPTConfig(hidden_size=1024, intermediate_size=4096,
                         num_layers=24, num_heads=16, **kw)

    @staticmethod
    def gpt2_large(**kw) -> "GPTConfig":
        return GPTConfig(hidden_size=1280, intermediate_size=5120,
                         num_layers=36, num_heads=20, **kw)

    @staticmethod
    def tiny(**kw) -> "GPTConfig":
        d = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                 num_layers=2, num_heads=4, max_seq_len=128,
                 dtype=torch.float32, remat=False)
        d.update(kw)
        return GPTConfig(**d)

    def num_params(self) -> int:
        h, i, L = self.hidden_size, self.intermediate_size, self.num_layers
        per_layer = (3 * h * h + 3 * h          # qkv + bias
                     + h * h + h                # proj + bias
                     + 2 * h * i + i + h        # mlp + biases
                     + 4 * h)                   # 2 LN scale+bias
        return (L * per_layer + self.vocab_size * h
                + self.max_seq_len * h + 2 * h)

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs a token: 6 x the matmul parameters (the tied
        head counted once, the position table not at all) plus the
        attention term."""
        n = self.num_params() - self.vocab_size * self.hidden_size \
            - self.max_seq_len * self.hidden_size
        n += self.vocab_size * self.hidden_size
        attn = 12 * self.num_layers * self.num_heads * self.hd * seq_len
        return 6.0 * n + attn


def init_params(cfg: GPTConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict:
    """Random parameters with the JAX package's leaf names, layout and
    law: every matrix ``N(0, 0.02^2)`` drawn in float32 and cast to
    ``cfg.dtype``, ``wo`` and ``w2`` then divided by ``sqrt(2L)`` in
    that dtype; biases zero, LayerNorm gains one. Stacked leaves are
    drawn a layer at a time. ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    h, i, L, v = (cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
                  cfg.vocab_size)

    def norm(shape):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * 0.02).to(cfg.dtype)

    def stacked(shape):
        out = torch.empty((L,) + shape, dtype=cfg.dtype, device=dev)
        for l in range(L):
            out[l] = norm(shape)
        return out

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    return {
        "wte": norm((v, h)),
        "wpe": norm((cfg.max_seq_len, h)),
        "final_ln_g": ones(h),
        "final_ln_b": zeros(h),
        "layers": {
            "wqkv": stacked((h, 3 * h)),
            "bqkv": zeros(L, 3 * h),
            "wo": stacked((h, h)) / math.sqrt(2 * L),
            "bo": zeros(L, h),
            "w1": stacked((h, i)),
            "b1": zeros(L, i),
            "w2": stacked((i, h)) / math.sqrt(2 * L),
            "b2": zeros(L, h),
            "ln1_g": ones(L, h),
            "ln1_b": zeros(L, h),
            "ln2_g": ones(L, h),
            "ln2_b": zeros(L, h),
        },
    }


def _ln(x, g, b, eps: float):
    """LayerNorm as the JAX package's: normalise in float32, cast back to
    ``x.dtype``, then apply ``g`` and ``b`` in that dtype (``F.layer_norm``
    with bf16 weights would apply them before the cast)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


def _block(x, lp, cfg: GPTConfig):
    """One pre-LN decoder layer: causal attention over the fused qkv
    projection, then the MLP with ``jax.nn.gelu``'s default (tanh) form
    in float32."""
    B, S, H = x.shape
    nh, hd = cfg.num_heads, cfg.hd
    h1 = _ln(x, lp["ln1_g"], lp["ln1_b"], cfg.ln_eps)
    qkv = h1 @ lp["wqkv"] + lp["bqkv"]
    q, k, v = (t.reshape(B, S, nh, hd) for t in qkv.split(H, dim=-1))
    o = _attention(q, k, v, causal=True).reshape(B, S, H)
    x = x + (o @ lp["wo"] + lp["bo"])
    h2 = _ln(x, lp["ln2_g"], lp["ln2_b"], cfg.ln_eps)
    f = F.gelu((h2 @ lp["w1"] + lp["b1"]).float(), approximate="tanh")
    return x + (f.to(x.dtype) @ lp["w2"] + lp["b2"])


def _trunk(params, tokens, cfg: GPTConfig):
    """-> final-LN hidden states (B, S, H). Token and position embeddings
    summed and cast to the model dtype, then the layers, each
    checkpointed whole under ``remat`` (JAX's ``nothing_saveable``: its
    backward runs the layer's forward again, B1 included)."""
    S = tokens.shape[1]
    x = (params["wte"][tokens.long()] + params["wpe"][None, :S]).to(
        cfg.dtype)
    stacks = {name: w.unbind(0) for name, w in params["layers"].items()}
    for l in range(cfg.num_layers):
        lp = {name: ws[l] for name, ws in stacks.items()}
        x = (_remat(_block, x, lp, cfg) if cfg.remat
             else _block(x, lp, cfg))
    return _ln(x, params["final_ln_g"], params["final_ln_b"], cfg.ln_eps)


def forward(params: Dict, tokens: torch.Tensor, cfg: GPTConfig,
            return_hidden: bool = False) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, V) float32 through the tied
    head (or the final-LN hidden states when ``return_hidden``)."""
    x = _trunk(params, tokens, cfg)
    if return_hidden:
        return x
    return (x @ params["wte"].T.to(x.dtype)).float()


def loss_fn(params: Dict, tokens: torch.Tensor, cfg: GPTConfig,
            seq_chunk: Optional[int] = None) -> torch.Tensor:
    """Next-token cross-entropy through the tied head, mean over
    B*(S-1), chunked over positions by ``seq_chunk``
    (``llama.next_token_loss``)."""
    h = _trunk(params, tokens, cfg)
    return next_token_loss(h, params["wte"].T.to(h.dtype), tokens,
                           seq_chunk)
