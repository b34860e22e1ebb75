"""Single-device training step, shared by the model families.

Counterpart of ``paddle_tpu/models/train.py`` with ``mesh=None``: the
state (model-dtype params, f32 master weights and Adam moments), AdamW on
the master weights, global-norm gradient clipping and the cast back to
the model dtype. ``model=`` names the model module whose
``init_params`` and ``loss_fn`` the state and step use (``llama`` by
default; ``gpt`` and ``ernie`` as in the JAX package). An MoE config
trains on the same step: its f32 router leaves (``moe_gate``) sit among
the model-dtype leaves, and the loss carries the experts' load-balance
and z losses; ERNIE's f32 ``mlm_bias`` sits there the same way. The mesh
path (dp x fsdp x tp, ZeRO-sharded optimizer state, expert-parallel
MoE) is not ported for any model: see ROADMAP.md, queue A step 8.
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


def init_train_state(cfg, generator: torch.Generator,
                     device: DeviceLike = None, model=None) -> TrainState:
    """Random params (``model.init_params``, default ``llama``) with f32
    master copies (own storage, also when the model dtype is f32) and
    zero moments."""
    params = (model or llama).init_params(cfg, generator,
                                          resolve_device(device))
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


def clip_and_update(state: TrainState, params: List[torch.Tensor],
                    grads: List[torch.Tensor], *, lr: float, b1: float,
                    b2: float, eps: float, weight_decay: float,
                    grad_clip: float) -> torch.Tensor:
    """The step after the f32 gradients: their global norm, a clip to
    ``grad_clip`` (with ``+1e-6``), AdamW on the master weights and the
    cast back into ``params`` (``_leaves(state.params)``), all in place.
    Returns the global norm."""
    with torch.no_grad():
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(grad_clip / (gnorm + 1e-6), max=1.0)
        for p, g, p32, m, v in zip(params, grads, _leaves(state.master),
                                   _leaves(state.m), _leaves(state.v)):
            _adamw(g * scale, p32, m, v, state.step, lr, b1, b2, eps,
                   weight_decay)
            p.copy_(p32)
    return gnorm


def make_train_step(cfg, mesh=None, *, lr: float = 3e-4,
                    b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                    weight_decay: float = 0.1, grad_clip: float = 1.0,
                    seq_chunk: Optional[int] = None, model=None):
    """Returns ``step(state, tokens) -> (state, {"loss", "grad_norm"})``:
    gradients of ``model.loss_fn`` (default ``llama``) cast to f32, then
    :func:`clip_and_update`. The step updates ``state`` in place and
    returns it (the JAX step donates its state); the metrics stay on the
    device, so a step never waits for the card."""
    if mesh is not None:
        what = ("expert-parallel MoE training is"
                if getattr(cfg, "moe", None) is not None
                else "meshes (dp x fsdp x tp) are")
        raise NotImplementedError(
            f"make_train_step: {what} not ported yet — see ROADMAP.md, "
            f"queue A step 8; pass mesh=None")

    mdl = model or llama

    def step(state: TrainState, tokens: torch.Tensor):
        params = _leaves(state.params)
        for p in params:
            p.requires_grad_(True)
        try:
            loss = mdl.loss_fn(state.params, tokens, cfg,
                               seq_chunk=seq_chunk)
            # a leaf the loss does not reach (ERNIE's pooler and NSP
            # head under the MLM loss) gets zeros, as under jax.grad
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
        finally:
            for p in params:
                p.requires_grad_(False)
        # rebinding drops the model-dtype gradients before the update
        grads = [g.float() for g in grads]
        gnorm = clip_and_update(state, params, grads, lr=lr, b1=b1, b2=b2,
                                eps=eps, weight_decay=weight_decay,
                                grad_clip=grad_clip)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step
