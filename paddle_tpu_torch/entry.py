"""Entry point of the port: the counterpart of ``__graft_entry__.entry()``.

``entry()`` returns ``(fn, args)``: the Llama forward on the tiny
two-layer config with seeded parameters and the same numpy-seeded
``(2, 128)`` tokens as the JAX entry point. ``fn(*args)`` gives the
logits ``(2, 128, vocab)`` in float32. The parameters come from a
``torch.Generator`` seeded 0, so they differ from ``jax.random.key(0)``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models import llama


def entry(device: DeviceLike = None):
    """(fn, example_args) on ``device`` (default the card)."""
    dev = resolve_device(device)
    cfg = llama.LlamaConfig.tiny(num_layers=2)
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128)),
        dtype=torch.int32, device=dev)

    def fn(params, tokens):
        return llama.forward(params, tokens, cfg)

    return fn, (params, tokens)
