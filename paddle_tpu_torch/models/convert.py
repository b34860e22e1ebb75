"""Weight bridge: the JAX package's parameter tree and training state
into the port's.

The two packages share leaf names and layouts, so the bridge moves bytes
and never transposes. It takes the trees as numpy arrays
(``jax.tree.map(np.asarray, params)``) and imports nothing of JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def _leaf(a) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # writable, owned by torch
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: np.asarray of a bf16 jax.Array is an
        # ml_dtypes.bfloat16 array. Move its bits, never through float32.
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: Mapping, device: DeviceLike = None) -> Dict:
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device`` (default the card), bit for bit."""
    dev = resolve_device(device)
    out = {}
    for name, value in tree.items():
        if isinstance(value, Mapping):
            out[name] = params_from_jax(value, dev)
        else:
            out[name] = _leaf(value).to(dev)
    return out


def train_state_from_jax(state, device: DeviceLike = None):
    """A JAX ``TrainState`` of numpy arrays (``jax.tree.map(np.asarray,
    state)``: step, params, master, m, v) -> the port's
    :class:`~paddle_tpu_torch.models.train.TrainState` on ``device``,
    every leaf bit for bit."""
    from .train import TrainState
    dev = resolve_device(device)
    return TrainState(int(np.asarray(state.step)),
                      *(params_from_jax(tree, dev) for tree in
                        (state.params, state.master, state.m, state.v)))
