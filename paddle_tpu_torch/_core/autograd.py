"""The Paddle autograd surface over torch autograd.

Counterpart of ``paddle_tpu/_core/autograd.py``. The reference records a
tape of ``jax.vjp`` closures because JAX has none of its own; torch
autograd *is* a tape, so here an op is a function of raw
``torch.Tensor`` values run under torch's grad mode, and :func:`apply`
only unwraps the ``Tensor`` arguments and wraps the results.
``no_grad``, ``enable_grad``, ``set_grad_enabled``, :func:`backward` and
:func:`grad` are torch's own under the reference's names and argument
conventions.
"""
from __future__ import annotations

from typing import Callable

import torch

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled


def _raw(x):
    from .tensor import Tensor
    return x._value if isinstance(x, Tensor) else x


def apply(fn: Callable, *args, name: str = "", multi_out: bool = False):
    """Run ``fn`` over the raw values of ``args`` (``Tensor``\\ s are
    unwrapped, anything else is passed as it is) and wrap its result: a
    ``Tensor``, or a tuple of them when ``fn`` returns a tuple or list or
    ``multi_out`` is set. Gradients flow through whatever torch records
    inside ``fn``; ``name`` is kept for the reference's signature."""
    from .tensor import Tensor
    out = fn(*(_raw(a) for a in args))
    if isinstance(out, (tuple, list)):
        return tuple(None if o is None else Tensor(o, _internal=True)
                     for o in out)
    t = Tensor(out, _internal=True)
    return (t,) if multi_out else t


def _grads(gs):
    if gs is None:
        return None
    if not isinstance(gs, (list, tuple)):
        gs = [gs]
    return [None if g is None else torch.as_tensor(_raw(g)) for g in gs]


def backward(tensors, grad_tensors=None, retain_graph: bool = False):
    """Accumulate the gradients of ``tensors`` into the ``.grad`` of
    every leaf they depend on (``torch.autograd.backward``)."""
    if not isinstance(tensors, (list, tuple)):
        tensors = [tensors]
    torch.autograd.backward([_raw(t) for t in tensors], _grads(grad_tensors),
                            retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph: bool = False, only_inputs: bool = True,
         allow_unused: bool = False):
    """The gradients of ``outputs`` with respect to ``inputs`` as a list
    of ``Tensor``\\ s (None for an unused input with ``allow_unused``),
    without touching any ``.grad`` (``torch.autograd.grad``)."""
    from .tensor import Tensor
    if not isinstance(outputs, (list, tuple)):
        outputs = [outputs]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    gs = torch.autograd.grad(
        [_raw(o) for o in outputs], [_raw(i) for i in inputs],
        grad_outputs=_grads(grad_outputs), retain_graph=retain_graph,
        create_graph=create_graph, allow_unused=allow_unused)
    return [None if g is None else Tensor(g, _internal=True) for g in gs]
