"""Single-device training step for the flagship LM.

Counterpart of ``paddle_tpu/models/train.py`` with ``mesh=None``: the
state (model-dtype params, f32 master weights and Adam moments), AdamW on
the master weights, global-norm gradient clipping and the cast back to
the model dtype. The mesh path (dp x fsdp x tp, ZeRO-sharded optimizer
state) is not ported: see ROADMAP.md, queue A step 8.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from ..device import DeviceLike, resolve_device
from . import llama


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict          # model dtype (bf16) working copy
    master: Dict          # f32 master weights
    m: Dict               # Adam first moment (f32)
    v: Dict               # Adam second moment (f32)


def _leaves(tree: Dict) -> List[torch.Tensor]:
    """The tensors of a nested dict, in a fixed order (sorted keys)."""
    out = []
    for name in sorted(tree):
        value = tree[name]
        out += _leaves(value) if isinstance(value, dict) else [value]
    return out


def _map(fn: Callable, tree: Dict) -> Dict:
    return {name: _map(fn, v) if isinstance(v, dict) else fn(v)
            for name, v in tree.items()}


def init_train_state(cfg: llama.LlamaConfig, generator: torch.Generator,
                     device: DeviceLike = None) -> TrainState:
    """Random params (``llama.init_params``) with f32 master copies (own
    storage, also when the model dtype is f32) and zero moments."""
    params = llama.init_params(cfg, generator, resolve_device(device))
    master = _map(lambda p: p.float().clone(), params)
    return TrainState(0, params, master,
                      _map(torch.zeros_like, master),
                      _map(torch.zeros_like, master))


def _adamw(g, p32, m, v, step: int, lr, b1, b2, eps, wd):
    """The JAX package's AdamW update (``train.py`` ``_adamw``), in place
    on the f32 ``p32``, ``m`` and ``v``."""
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    t = step + 1.0
    mhat = m / (1 - b1 ** t)
    vhat = v / (1 - b2 ** t)
    p32.sub_(lr * (mhat / (torch.sqrt(vhat) + eps) + wd * p32))


def make_train_step(cfg: llama.LlamaConfig, mesh=None, *, lr: float = 3e-4,
                    b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                    weight_decay: float = 0.1, grad_clip: float = 1.0,
                    seq_chunk: Optional[int] = None):
    """Returns ``step(state, tokens) -> (state, {"loss", "grad_norm"})``:
    gradients of ``llama.loss_fn`` cast to f32, their global norm, a clip
    to ``grad_clip`` (with ``+1e-6``), AdamW on the master weights, and
    the params cast back to their dtype. The step updates ``state`` in
    place and returns it (the JAX step donates its state); the metrics
    stay on the device, so a step never waits for the card."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step: meshes (dp x fsdp x tp) are not ported yet — "
            "see ROADMAP.md, queue A step 8; pass mesh=None")

    def step(state: TrainState, tokens: torch.Tensor):
        params = _leaves(state.params)
        for p in params:
            p.requires_grad_(True)
        try:
            loss = llama.loss_fn(state.params, tokens, cfg,
                                 seq_chunk=seq_chunk)
            grads = torch.autograd.grad(loss, params)
        finally:
            for p in params:
                p.requires_grad_(False)
        with torch.no_grad():
            grads = [g.float() for g in grads]
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(grad_clip / (gnorm + 1e-6), max=1.0)
            for p, g, p32, m, v in zip(params, grads, _leaves(state.master),
                                       _leaves(state.m), _leaves(state.v)):
                _adamw(g * scale, p32, m, v, state.step, lr, b1, b2, eps,
                       weight_decay)
                p.copy_(p32)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step
