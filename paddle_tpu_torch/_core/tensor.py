"""Tensor: the Paddle eager tensor over a ``torch.Tensor``.

Counterpart of ``paddle_tpu/_core/tensor.py``. A ``Tensor`` owns a
``torch.Tensor`` in ``_value``; ``stop_gradient`` is the inverse of its
``requires_grad``, ``.grad`` is its ``.grad``, and ``backward`` is torch
autograd's (``_core/autograd.py``), so the reference's tape nodes,
input references and version counters have no counterpart here. The
in-place ops and the AMP and static-program hooks are not ported yet
(ROADMAP.md, queue A step 9b).

New tensors go to the card unless the caller passes ``place="cpu"``:
:func:`to_tensor` and the ops resolve ``place=None`` to ``"cuda"``,
which raises on a machine without one (``device.resolve_device``).
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from . import autograd
from . import dtype as dtypes

_names = itertools.count(1)


def place_device(place) -> torch.device:
    """A Paddle place (``None``, ``"cpu"``, ``"gpu"``, ``"gpu:0"``, a
    ``torch.device`` or a ``Tensor``'s place) as a ``torch.device``;
    ``None`` is the card."""
    if isinstance(place, str) and place.startswith("gpu"):
        place = "cuda" + place[3:]
    return resolve_device(place)


def _to_torch(data, dtype=None, place=None) -> torch.Tensor:
    """``data`` as a new torch tensor on ``place`` (a ``Tensor`` or
    ``torch.Tensor`` keeps its device when ``place`` is None). numpy
    float64 data takes the default float dtype and int64 data int32, as
    in the reference."""
    d = dtypes.convert_dtype(dtype)
    if isinstance(data, Tensor):
        data = data._value
    if isinstance(data, torch.Tensor):
        dev = data.device if place is None else place_device(place)
        return data.to(device=dev, dtype=d or data.dtype)
    arr = np.asarray(data)
    if d is None:
        d = (dtypes.get_default_dtype() if arr.dtype == np.float64
             else dtypes.convert_dtype(arr.dtype))
    return torch.tensor(arr, dtype=d, device=place_device(place))


class Tensor:
    __slots__ = ("_value", "name", "__weakref__")

    def __init__(self, data=None, dtype=None, place=None,
                 stop_gradient: bool = True, name: Optional[str] = None,
                 _internal: bool = False):
        """``_internal`` wraps the torch tensor ``data`` as it is, graph
        and all (the ops' results)."""
        self._value = data if _internal else _to_torch(data, dtype, place)
        if not stop_gradient:
            self.stop_gradient = False
        self.name = name or f"generated_tensor_{next(_names)}"

    # ---- basic properties ----
    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def ndim(self) -> int:
        return self._value.dim()

    @property
    def dtype(self) -> torch.dtype:
        return self._value.dtype

    @property
    def place(self) -> torch.device:
        return self._value.device

    @property
    def stop_gradient(self) -> bool:
        return not self._value.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, v):
        v = bool(v)
        if v == self.stop_gradient:
            return
        if not v:
            self._value.requires_grad_(True)
        elif self._value.grad_fn is None:
            self._value.requires_grad_(False)
        else:                          # an op's result: cut it off the graph
            self._value = self._value.detach()

    @property
    def grad(self):
        g = self._value.grad
        return None if g is None else Tensor(g, _internal=True)

    # ---- conversion ----
    def numpy(self) -> np.ndarray:
        """A host copy; bfloat16 comes back as float32 (numpy has no
        bfloat16)."""
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()

    def astype(self, dtype):
        d = dtypes.convert_dtype(dtype)
        return autograd.apply(lambda x: x.to(d), self, name="cast")

    # ---- autograd surface ----
    def backward(self, grad_tensor=None, retain_graph: bool = False):
        autograd.backward([self], None if grad_tensor is None
                          else [grad_tensor], retain_graph=retain_graph)

    def detach(self):
        return Tensor(self._value.detach(), _internal=True)

    def clone(self):
        return autograd.apply(torch.clone, self, name="clone")

    # ---- indexing ----
    def __getitem__(self, idx):
        idx = _index_to_raw(idx)
        return autograd.apply(lambda x: x[idx], self, name="getitem")

    # ---- operators ----
    def _binary(self, other, fn, name, reverse=False):
        if isinstance(other, (list, tuple, np.ndarray)):
            other = _to_torch(other, place=self.place)
        if reverse:
            return autograd.apply(lambda y, x: fn(x, y), self, other,
                                  name=name)
        return autograd.apply(fn, self, other, name=name)

    def __add__(self, o):
        return self._binary(o, torch.add, "add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, torch.sub, "subtract")

    def __rsub__(self, o):
        return self._binary(o, torch.sub, "subtract", reverse=True)

    def __mul__(self, o):
        return self._binary(o, torch.mul, "multiply")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, torch.true_divide, "divide")

    def __rtruediv__(self, o):
        return self._binary(o, torch.true_divide, "divide", reverse=True)

    def __pow__(self, o):
        return self._binary(o, torch.pow, "pow")

    def __rpow__(self, o):
        return self._binary(o, torch.pow, "pow", reverse=True)

    def __matmul__(self, o):
        return self._binary(o, torch.matmul, "matmul")

    def __rmatmul__(self, o):
        return self._binary(o, torch.matmul, "matmul", reverse=True)

    def __neg__(self):
        return autograd.apply(torch.neg, self, name="neg")

    def __repr__(self):
        body = np.array2string(self.numpy(), precision=8, separator=", ")
        return (f"Tensor(shape={self.shape}, "
                f"dtype={dtypes.dtype_name(self.dtype)}, place={self.place}, "
                f"stop_gradient={self.stop_gradient},\n       {body})")


def _index_to_raw(idx):
    if isinstance(idx, Tensor):
        return idx._value
    if isinstance(idx, tuple):
        return tuple(i._value if isinstance(i, Tensor) else i for i in idx)
    return idx


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True):
    """A new ``Tensor`` holding ``data`` (reference:
    ``python/paddle/tensor/creation.py`` ``to_tensor``) on ``place``,
    the card by default: a ``Tensor`` or ``torch.Tensor`` argument is
    detached from its graph and keeps its device unless ``place`` is
    given."""
    if isinstance(data, (Tensor, torch.Tensor)):
        data = autograd._raw(data).detach()
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)
