"""Mixture-of-Experts feed-forward on one device (GShard formulation).

Counterpart of ``paddle_tpu/models/moe.py`` with no mesh: the config
with its capacity rule, the training router (f32 logits, ``top_k``
sequential argmax passes, positions in each expert's buffer in token
order, capacity drops, combine weights renormalised over the selected
experts, the Switch load-balance loss and the router z-loss), the
expert SwiGLU FFN and the parameter init law.

The JAX package routes through dense ``(T, E, C)`` one-hot dispatch and
combine tensors and einsums. The port computes the same function by
index: each routed item knows its expert and its slot in that expert's
buffer, the ``(E, C, H)`` buffer is one gather of the token rows, and
the combine is one gather of the expert outputs, weighted in slot order.
At 4 x 4096 tokens, 16 experts and capacity 2560 the f32 combine tensor
alone would be 2.7 GB a layer; the index form holds ``(T, k)`` ints.
:func:`router` still returns the dense forms, for callers and tests that
want them. Expert parallelism (``_expert_constraint``, the ``ep`` axis)
is ROADMAP.md queue A step 8.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    min_capacity: int = 4
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3

    def capacity(self, tokens_per_batch: int) -> int:
        c = int(tokens_per_batch * self.capacity_factor * self.top_k /
                self.num_experts)
        return max(c, self.min_capacity)


class Routes(NamedTuple):
    """The router's decision in index form, ``k`` = ``top_k`` passes:
    ``expert`` (T, k) the expert of each pass, ``slot`` (T, k) the
    position in that expert's buffer (clipped to ``C - 1`` where
    dropped), ``keep`` (T, k) whether it fit, ``weight`` (T, k) f32 the
    renormalised combine weight (0 where dropped), ``capacity`` C,
    ``logits`` (T, E) f32 and ``losses`` {"aux_loss", "z_loss"}."""
    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    weight: torch.Tensor
    capacity: int
    logits: torch.Tensor
    losses: Dict[str, torch.Tensor]


def route(x: torch.Tensor, w_gate: torch.Tensor, cfg: MoEConfig) -> Routes:
    """x (T, H) -> :class:`Routes`, the JAX ``router`` op for op in
    index form. Each pass takes the first maximum of the probabilities
    not yet taken (``torch.argmax`` and ``jnp.argmax`` both take the
    lowest index on a tie); a token's position in its expert's buffer
    counts the tokens before it in token order that chose the same
    expert in this pass, after the rows earlier passes kept
    (``base_fill``); positions at or past the capacity drop. Gradients
    reach ``w_gate`` and ``x`` through the combine weights (the
    probabilities and their renormalising sum), the load-balance loss's
    mean probabilities and the z-loss's logsumexp; the selections and
    the top-1 counts carry none."""
    T = x.shape[0]
    E, K, C = cfg.num_experts, cfg.top_k, cfg.capacity(T)
    logits = x.float() @ w_gate.float()                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    remaining = probs
    base_fill = torch.zeros((E,), dtype=torch.long, device=x.device)
    total = torch.zeros((T,), dtype=torch.float32, device=x.device)
    experts, slots, keeps, ws = [], [], [], []
    top1 = None
    for _ in range(K):
        idx = torch.argmax(remaining, dim=-1)                  # (T,)
        onehot = F.one_hot(idx, E)                             # (T, E)
        if top1 is None:
            top1 = onehot
        before = torch.cumsum(onehot, dim=0).gather(1, idx[:, None])[:, 0]
        pos = before - 1 + base_fill[idx]
        keep = pos < C
        w = probs.gather(1, idx[:, None])[:, 0] * keep
        total = total + w
        base_fill = base_fill + (onehot * keep[:, None]).sum(0)
        remaining = remaining * (1.0 - onehot.to(remaining.dtype))
        experts.append(idx)
        slots.append(torch.clamp(pos, 0, C - 1))
        keeps.append(keep)
        ws.append(w)
    denom = torch.where(total == 0.0, torch.ones_like(total), total)
    weight = torch.stack(ws, dim=1) / denom[:, None]
    me = probs.mean(0)
    ce = top1.float().mean(0)
    aux = cfg.aux_loss_weight * E * torch.sum(me * ce)
    z = cfg.z_loss_weight * torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return Routes(torch.stack(experts, 1), torch.stack(slots, 1),
                  torch.stack(keeps, 1), weight, C, logits,
                  {"aux_loss": aux, "z_loss": z})


def router(x: torch.Tensor, w_gate: torch.Tensor, cfg: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                      Dict[str, torch.Tensor]]:
    """x (T, H) -> (dispatch (T, E, C) in ``x.dtype``, combine (T, E, C)
    f32, logits (T, E) f32, losses): the JAX ``router``'s dense one-hot
    forms, built from :func:`route`."""
    r = route(x, w_gate, cfg)
    T, K = r.expert.shape
    E, C = cfg.num_experts, r.capacity
    tok = torch.arange(T, device=x.device)[:, None].expand(T, K)
    sel = (tok[r.keep], r.expert[r.keep], r.slot[r.keep])
    dispatch = torch.zeros((T, E, C), dtype=x.dtype, device=x.device)
    dispatch = dispatch.index_put(sel, torch.ones_like(sel[0], dtype=x.dtype))
    combine = torch.zeros((T, E, C), dtype=torch.float32, device=x.device)
    combine = combine.index_put(sel, r.weight[r.keep], accumulate=True)
    return dispatch, combine, r.logits, r.losses


def moe_ffn(x: torch.Tensor, params: Dict[str, torch.Tensor],
            cfg: MoEConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SwiGLU expert FFN. x (B, S, H); params ``w_gate`` (H, E) f32,
    ``wg`` / ``wu`` (E, H, I), ``wd`` (E, I, H). Returns (out (B, S, H),
    losses), the JAX ``moe_ffn`` on one device.

    The ``(E, C, H)`` expert buffers are one gather of the token rows
    (each slot holds the one token routed there, an empty slot a zero
    row, whose FFN is zero); the combine gathers each pass's expert
    output row, weights it by the combine weight cast to the model
    dtype and sums the passes in f32 before the one cast back, the
    einsum's accumulation. Dropped passes weigh zero."""
    B, S, H = x.shape
    xt = x.reshape(B * S, H)
    r = route(xt, params["w_gate"], cfg)
    T, K = r.expert.shape
    E, C = cfg.num_experts, r.capacity
    flat = r.expert * C + r.slot                               # (T, k)
    tok = torch.arange(T, device=x.device)[:, None].expand(T, K)
    # slot -> its token, T (a zero row) where no token was kept there;
    # dropped passes write to a spare slot E * C (no mask, no host sync)
    src = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
    src.scatter_(0, torch.where(r.keep, flat, E * C).reshape(-1),
                 tok.reshape(-1))
    xpad = torch.cat([xt, xt.new_zeros((1, H))])
    buf = xpad[src[:E * C]].reshape(E, C, H)
    # the experts' SwiGLU, SiLU of the gate in f32 and cast back first
    g = F.silu(torch.bmm(buf, params["wg"]).float()).to(x.dtype)
    out = torch.bmm(g * torch.bmm(buf, params["wu"]),
                    params["wd"]).reshape(E * C, H)
    w = r.weight.to(x.dtype).float()                           # (T, k)
    y = (out[flat].float() * w[..., None]).sum(1).to(x.dtype)
    return y.reshape(B, S, H), r.losses


def init_moe_params(hidden: int, intermediate: int, cfg: MoEConfig,
                    generator: torch.Generator, dtype=torch.bfloat16,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The JAX ``init_moe_params``'s shapes and law: every leaf
    ``N(0, 1/fan_in)``, drawn in f32; the router ``w_gate`` stays f32,
    the experts are cast to ``dtype`` (the router is rounded to ``dtype``
    first, as the JAX package's). Draws come from ``generator`` and
    differ from ``jax.random``'s (``convert.params_from_jax`` carries
    JAX's values across)."""
    dev = resolve_device(device)
    E = cfg.num_experts

    def norm(shape, fan_in):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) / math.sqrt(fan_in)

    return {
        # drawn, cast to dtype and back, as the JAX package's
        "w_gate": norm((hidden, E), hidden).to(dtype).float(),
        "wg": norm((E, hidden, intermediate), hidden).to(dtype),
        "wu": norm((E, hidden, intermediate), hidden).to(dtype),
        "wd": norm((E, intermediate, hidden), intermediate).to(dtype),
    }
