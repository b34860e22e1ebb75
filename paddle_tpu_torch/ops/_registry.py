"""Op helpers and the ``Tensor`` methods built on them.

Counterpart of ``paddle_tpu/ops/_registry.py``: the reference's
``as_tensor`` / ``raw`` conversions, and ops attached as ``Tensor``
methods. Only the methods that the ported ``incubate`` path
and its tests call are here (``sum``, ``mean``, ``reshape``); the rest
of ``paddle_tpu/ops`` waits for ROADMAP.md queue A step 9b.
"""
from __future__ import annotations

import torch

from .._core import dtype as dtypes
from .._core.autograd import apply
from .._core.tensor import Tensor


def register(name: str):
    """Attach the op ``fn`` as the ``Tensor`` method ``name``."""
    def deco(fn):
        setattr(Tensor, name, fn)
        return fn
    return deco


def as_tensor(x, dtype=None, place=None) -> Tensor:
    """``x`` itself when it is a ``Tensor``, else a new one (a
    ``torch.Tensor`` is wrapped as it is, other data goes to ``place``,
    the card by default)."""
    if isinstance(x, Tensor):
        return x
    return Tensor(x, dtype=dtype, place=place)


def raw(x):
    return x._value if isinstance(x, Tensor) else x


def _axes(axis):
    return None if axis is None else (
        tuple(axis) if isinstance(axis, (list, tuple)) else (axis,))


@register("sum")
def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax, d = _axes(axis), dtypes.convert_dtype(dtype)

    def f(v):
        return (torch.sum(v, dtype=d) if ax is None
                else torch.sum(v, dim=ax, keepdim=keepdim, dtype=d))
    return apply(f, as_tensor(x), name="sum")


@register("mean")
def mean(x, axis=None, keepdim=False, name=None):
    ax = _axes(axis)
    return apply(lambda v: torch.mean(v) if ax is None
                 else torch.mean(v, dim=ax, keepdim=keepdim),
                 as_tensor(x), name="mean")


@register("reshape")
def reshape(x, shape, name=None):
    return apply(lambda v: v.reshape([int(s) for s in shape]), as_tensor(x),
                 name="reshape")
