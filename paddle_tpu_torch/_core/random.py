"""RNG state on a counter-based PRNG: threefry2x32, as the JAX package
draws it.

Counterpart of ``paddle_tpu/_core/random.py``. The JAX package keeps a
global ``Generator`` whose key is split on every draw, and an explicit
*rng scope* in which each random op folds a per-call counter into the
scope's key. Both rest on ``jax.random``'s threefry2x32 with
partitionable counters. The port computes the same function in torch,
so that for the same ``seed`` it draws the same bits: a dropout keep-mask
or ERNIE's MLM mask equals the JAX package's bit for bit.

- A key is a pair of 32-bit words ``(k0, k1)``: two Python ints on the
  host, or two 0-d int64 tensors where a key is folded from data that
  lives on the card (ERNIE folds in the batch's token sum), so that
  drawing the bits never waits for the card.
- :func:`threefry2x32` works on Python ints and on int64 tensors alike,
  each word masked to 32 bits (torch has few ``uint32`` ops).
- :func:`key`, :func:`fold_in`, :func:`split`, :func:`random_bits`,
  :func:`uniform` and :func:`bernoulli` follow ``jax.random`` under
  ``jax_threefry_partitionable`` (JAX's default): ``key(s)`` is ``(0,
  s)``; ``fold_in(k, d)`` hashes the counter ``(0, d)``; ``split(k,
  n)``'s key ``i`` hashes ``(0, i)``; random bits hash ``(i >> 32, i &
  0xFFFFFFFF)`` over the flat index ``i`` and xor the two words; a
  uniform float keeps the top 23 bits as a mantissa in ``[1, 2)`` and
  subtracts 1.

This is host and elementwise code that the JAX package runs outside any
``pallas_call``: plain torch is its port.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_state = threading.local()
MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple  # (k0, k1): two ints, or two 0-d int64 tensors


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as
    ``jax.random``'s: the key ``(k0, k1)`` hashes the counter words
    ``(x0, x1)``. Every argument is a Python int or an int64 tensor
    holding values below 2^32; returns the two output words so."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)``'s key data: ``(0, seed)``, the seed as a
    32-bit word (a negative seed wraps, as JAX's int32 seed does)."""
    return (0, int(seed) & MASK)


def fold_in(k: Key, data) -> Key:
    """``jax.random.fold_in``: the key's hash of the counter ``(0,
    data)``. ``data`` is an int or an integer tensor (taken mod 2^32);
    a tensor gives a key of 0-d tensors on its device."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK
    else:
        data = int(data) & MASK
    return threefry2x32(k[0], k[1], 0, data)


def split(k: Key, num: int = 2) -> Sequence[Key]:
    """``jax.random.split``: key ``i`` is the hash of the counter ``(0,
    i)``."""
    return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def random_bits(k: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as an int64 tensor of
    32-bit values on ``device`` (a key of tensors: their device)."""
    if isinstance(k[0], torch.Tensor):
        device = k[0].device
    n = 1
    for s in shape:
        n *= int(s)
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k[0], k[1], i >> 32, i & MASK)
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(k: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape)``: float32 in ``[0, 1)``."""
    bits = (random_bits(k, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(k: Key, p: float, shape, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)``: ``uniform < p``, compared
    in float32 as JAX's."""
    u = uniform(k, shape, device)
    return u < torch.tensor(p, dtype=torch.float32, device=u.device)


def key_data(k: Key) -> np.ndarray:
    """The key as ``jax.random.key_data`` gives it: uint32 ``(2,)``."""
    return np.array([int(w) for w in k], dtype=np.uint32)


class Generator:
    """Stateful key-splitting generator (reference: phi::Generator): each
    draw splits the key into the next key and the one handed out."""

    def __init__(self, seed: int = 0):
        self._seed = seed
        self._key: Optional[Key] = None
        self._offset = 0

    @property
    def key(self) -> Key:
        if self._key is None:
            self._key = key(self._seed)
        return self._key

    def manual_seed(self, seed: int):
        self._seed = seed
        self._key = None
        self._offset = 0
        return self

    def initial_seed(self) -> int:
        return self._seed

    def get_state(self):
        return (self._seed, self._offset, key_data(self.key))

    def set_state(self, state):
        self._seed, self._offset, kd = state
        kd = np.asarray(kd, dtype=np.uint32)
        self._key = (int(kd[0]), int(kd[1]))

    def next_key(self) -> Key:
        self._key, sub = split(self.key)
        self._offset += 1
        return sub


# Created on first use, as the JAX package's is.
_default_generator: Optional[Generator] = None


def default_generator() -> Generator:
    global _default_generator
    if _default_generator is None:
        _default_generator = Generator(np.random.randint(0, 2**31 - 1))
    return _default_generator


def seed(s: int):
    """reference: python/paddle/framework/random.py ``paddle.seed``."""
    return default_generator().manual_seed(int(s))


def get_rng_state():
    return [default_generator().get_state()]


def set_rng_state(state):
    default_generator().set_state(state[0])


class rng_scope:
    """Bind an explicit key for the random ops in scope: each draws
    ``fold_in(key, counter)``, the counter one more a call."""

    def __init__(self, key: Key):
        self.key = key

    def __enter__(self):
        self._old = getattr(_state, "scope", None)
        _state.scope = [self.key, 0]
        return self

    def __exit__(self, *exc):
        _state.scope = self._old
        return False


def next_rng_key() -> Key:
    """The next key: from the active scope if any, else the global
    generator."""
    scope = getattr(_state, "scope", None)
    if scope is not None:
        k, ctr = scope
        scope[1] = ctr + 1
        return fold_in(k, ctr)
    return default_generator().next_key()


def in_rng_scope() -> bool:
    return getattr(_state, "scope", None) is not None


class use_generator:
    """Temporarily route random draws to ``gen`` (the hook the
    reference's RNGStatesTracker uses to give each model-parallel stream
    its own generator)."""

    def __init__(self, gen: Generator):
        self._gen = gen

    def __enter__(self):
        global _default_generator
        self._old = default_generator()
        _default_generator = self._gen
        return self._gen

    def __exit__(self, *exc):
        global _default_generator
        _default_generator = self._old
        return False
