"""ERNIE/BERT-style bidirectional encoder with MLM pretraining, for the
port.

Counterpart of ``paddle_tpu/models/ernie.py`` on one device: the config,
the parameter tree (same leaf names, stacked ``(L, in, out)`` layer
leaves, fan-in init, a float32 ``mlm_bias``), post-LN encoder blocks,
learned position and segment embeddings, the pooler and NSP head, the
stateless MLM mask and the masked-LM loss through the tied word
embedding. It trains on the shared step
(``train.make_train_step(cfg, model=ernie)``).

The attention stays what the JAX package computes, einsums in float32
with a ``-1e30`` pad bias, and reaches no kernel there or here. The MLM
mask folds the batch's token sum into ``cfg.mlm_seed``'s key and draws
threefry uniforms (``_core/random.py``), so it equals the JAX package's
bit for bit and the loss stays a pure function of (params, tokens).
``param_specs`` and the mesh are not ported: see ROADMAP.md, queue A
step 8.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .._core import random as prng
from ..device import DeviceLike, resolve_device
from .gpt import _ln
from .llama import _ce, _remat


@dataclasses.dataclass(frozen=True)
class ErnieConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 512
    type_vocab_size: int = 2
    ln_eps: float = 1e-12
    dtype: torch.dtype = torch.float32
    remat: bool = False
    # MLM objective: the mask derives from a fixed key and the token
    # values, so the loss is a pure function of (params, tokens)
    mlm_prob: float = 0.15
    mlm_seed: int = 0

    @property
    def hd(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mask_token_id(self) -> int:
        return self.vocab_size - 1      # the JAX package's convention

    @staticmethod
    def tiny(**kw) -> "ErnieConfig":
        kw.setdefault("vocab_size", 312)
        kw.setdefault("hidden_size", 32)
        kw.setdefault("intermediate_size", 64)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("max_seq_len", 64)
        return ErnieConfig(**kw)

    def num_params(self) -> int:
        h, i, L = self.hidden_size, self.intermediate_size, self.num_layers
        per_layer = (4 * h * h + 4 * h) + (2 * h * i + i + h) + 4 * h
        emb = (self.vocab_size + self.max_seq_len
               + self.type_vocab_size) * h + 2 * h
        heads = (h * h + h + 2 * h + self.vocab_size) + (h * h + h) \
            + (2 * h + 2)
        return L * per_layer + emb + heads

    def flops_per_token(self, seq_len: int) -> float:
        n = self.num_params()
        attn = 12 * self.num_layers * self.num_heads * self.hd * seq_len
        return 6.0 * n + attn


def init_params(cfg: ErnieConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict:
    """Random parameters with the JAX package's leaf names, layout and
    law: projections ``N(0, 1/fan_in)``, embeddings ``N(0, 0.02^2)``,
    each drawn in float32 and cast to ``cfg.dtype``; biases zero, gains
    one, ``mlm_bias`` zero in float32. ``generator`` must live on
    ``device``."""
    dev = resolve_device(device)
    h, i, v, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_layers)

    def norm(shape, fan_in=None):
        s = 0.02 if fan_in is None else 1.0 / math.sqrt(fan_in)
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * s).to(cfg.dtype)

    def stacked(shape, fan_in):
        out = torch.empty((L,) + shape, dtype=cfg.dtype, device=dev)
        for l in range(L):
            out[l] = norm(shape, fan_in)
        return out

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    layers = {
        "wq": stacked((h, h), h), "bq": zeros(L, h),
        "wk": stacked((h, h), h), "bk": zeros(L, h),
        "wv": stacked((h, h), h), "bv": zeros(L, h),
        "wo": stacked((h, h), h), "bo": zeros(L, h),
        "attn_ln_g": ones(L, h), "attn_ln_b": zeros(L, h),
        "w1": stacked((h, i), h), "b1": zeros(L, i),
        "w2": stacked((i, h), i), "b2": zeros(L, h),
        "ffn_ln_g": ones(L, h), "ffn_ln_b": zeros(L, h),
    }
    return {
        "word_embed": norm((v, h)),
        "pos_embed": norm((cfg.max_seq_len, h)),
        "seg_embed": norm((cfg.type_vocab_size, h)),
        "emb_ln_g": ones(h), "emb_ln_b": zeros(h),
        "layers": layers,
        "mlm_w": norm((h, h), fan_in=h), "mlm_b": zeros(h),
        "mlm_ln_g": ones(h), "mlm_ln_b": zeros(h),
        "mlm_bias": torch.zeros((v,), dtype=torch.float32, device=dev),
        "pool_w": norm((h, h), fan_in=h), "pool_b": zeros(h),
        "nsp_w": norm((h, 2), fan_in=h), "nsp_b": zeros(2),
    }


def _block(x, lp, attn_bias, cfg: ErnieConfig):
    """One post-LN encoder layer: float32 scores over all positions plus
    the pad bias, the softmax cast to v's dtype before its product, then
    the residual LayerNorms around the attention and the exact-GELU
    MLP."""
    B, S, H = x.shape
    nh, hd = cfg.num_heads, cfg.hd
    q = (x @ lp["wq"] + lp["bq"]).reshape(B, S, nh, hd)
    k = (x @ lp["wk"] + lp["bk"]).reshape(B, S, nh, hd)
    v = (x @ lp["wv"] + lp["bv"]).reshape(B, S, nh, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    if attn_bias is not None:
        s = s + attn_bias                   # (B, 1, 1, S): -1e30 at pads
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, H)
    x = _ln(x + (o @ lp["wo"] + lp["bo"]), lp["attn_ln_g"],
            lp["attn_ln_b"], cfg.ln_eps)
    f = F.gelu((x @ lp["w1"] + lp["b1"]).float()).to(x.dtype)
    return _ln(x + (f @ lp["w2"] + lp["b2"]), lp["ffn_ln_g"],
               lp["ffn_ln_b"], cfg.ln_eps)


def forward(params: Dict, tokens: torch.Tensor, cfg: ErnieConfig,
            segment_ids: Optional[torch.Tensor] = None,
            attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-> (B, S, H) encoder output (bidirectional).

    ``attention_mask``: optional (B, S), 1 = real token, 0 = padding
    (pads are masked out of every attention; outputs at real positions
    then match the unpadded encode). Each layer is checkpointed whole
    under ``cfg.remat``."""
    B, S = tokens.shape
    x = params["word_embed"][tokens.long()] + params["pos_embed"][:S][None]
    if segment_ids is not None:
        x = x + params["seg_embed"][segment_ids.long()]
    else:
        x = x + params["seg_embed"][0]
    x = _ln(x.to(cfg.dtype), params["emb_ln_g"], params["emb_ln_b"],
            cfg.ln_eps)
    bias = None
    if attention_mask is not None:
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                           -1e30).to(torch.float32)
    stacks = {name: w.unbind(0) for name, w in params["layers"].items()}
    for l in range(cfg.num_layers):
        lp = {name: ws[l] for name, ws in stacks.items()}
        x = (_remat(_block, x, lp, bias, cfg) if cfg.remat
             else _block(x, lp, bias, cfg))
    return x


def pooled_output(params: Dict, h: torch.Tensor,
                  cfg: ErnieConfig) -> torch.Tensor:
    """[CLS] pooler: tanh(W h_0 + b) in float32 (reference BertPooler)."""
    return torch.tanh((h[:, 0] @ params["pool_w"] + params["pool_b"])
                      .float())


def nsp_logits(params: Dict, pooled: torch.Tensor) -> torch.Tensor:
    """Next-sentence-prediction head over the pooled [CLS] output
    (reference BertPretrainingHeads)."""
    return (pooled @ params["nsp_w"].to(pooled.dtype)
            + params["nsp_b"].to(pooled.dtype))


def _mlm_mask(tokens: torch.Tensor, cfg: ErnieConfig) -> torch.Tensor:
    """Pseudo-random MLM positions, stateless: ``cfg.mlm_seed``'s key
    folds in the batch's token sum (wrapping mod 2^32, as JAX's uint32
    sum), and a position is masked where its threefry uniform is under
    ``mlm_prob``. The key stays on the tokens' device: no host read."""
    k = prng.fold_in(prng.key(cfg.mlm_seed), tokens.to(torch.int64).sum())
    return prng.bernoulli(k, cfg.mlm_prob, tokens.shape)


def _mlm_ce_sum(t, head, bias, labels, w):
    logits = (t @ head).float() + bias
    return (_ce(logits, labels) * w).sum()


def loss_fn(params: Dict, tokens: torch.Tensor, cfg: ErnieConfig,
            seq_chunk: Optional[int] = None) -> torch.Tensor:
    """Masked-LM cross-entropy over the masked positions (mean).

    Masked inputs are replaced with ``cfg.mask_token_id``; the decoder is
    tied to the word embedding (+ the float32 output bias).
    ``seq_chunk`` computes the float32 logits one chunk of positions at
    a time, recomputing each in backward; it must divide S."""
    S = tokens.shape[1]
    mask = _mlm_mask(tokens, cfg)
    inp = torch.where(mask, cfg.mask_token_id, tokens.long())
    h = forward(params, inp, cfg)
    t = _ln(h @ params["mlm_w"] + params["mlm_b"], params["mlm_ln_g"],
            params["mlm_ln_b"], cfg.ln_eps)
    head = params["word_embed"].T.to(t.dtype)
    labels = tokens.long()
    w = mask.float()
    denom = torch.clamp(w.sum(), min=1.0)
    if seq_chunk is None:
        return _mlm_ce_sum(t, head, params["mlm_bias"], labels, w) / denom
    if S % seq_chunk != 0:
        raise ValueError(f"seq_chunk={seq_chunk} must divide seq={S}")
    total = 0.0
    for c in range(0, S, seq_chunk):
        sl = slice(c, c + seq_chunk)
        total = total + _remat(_mlm_ce_sum, t[:, sl], head,
                               params["mlm_bias"], labels[:, sl], w[:, sl])
    return total / denom
