"""The port's threefry PRNG core (``_core/random.py``) against
``jax.random`` and ``paddle_tpu._core.random``, bit for bit.

Keys are compared as their two 32-bit words (``jax.random.key_data``),
uniform floats by their bits, bernoulli draws element by element: every
comparison is exact.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu._core import random as jr
import paddle_tpu_torch as ptt
from paddle_tpu_torch._core import random as tr

torch.set_num_threads(1)
SEEDS = [0, 1, 42, 2**31 - 1, -5]
SHAPES = [(1,), (7,), (13, 17), (3, 5, 2), (2, 3, 4, 5)]


def _kd(k):
    """The JAX key's words as a tuple of ints."""
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


def _tk(k):
    return tuple(int(w) for w in k)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    k = jax.random.key(seed)
    assert _tk(tr.key(seed)) == _kd(k)
    for d in (0, 7, 2**32 - 1, 123456789):
        assert _tk(tr.fold_in(tr.key(seed), d)) == \
            _kd(jax.random.fold_in(k, d))
    for n in (2, 3, 5):
        for a, b in zip(jax.random.split(k, n), tr.split(tr.key(seed), n)):
            assert _kd(a) == _tk(b)


def test_fold_in_of_a_tensor_equals_fold_in_of_its_value():
    k = tr.key(3)
    t = tr.fold_in(k, torch.tensor(2**33 + 17))
    assert all(isinstance(w, torch.Tensor) for w in t)
    assert _tk(t) == _tk(tr.fold_in(k, 17))
    assert _tk(t) == _kd(jax.random.fold_in(jax.random.key(3), 17))
    np.testing.assert_array_equal(tr.uniform(t, (4, 5)).numpy(),
                                  tr.uniform(tr.fold_in(k, 17), (4, 5),
                                             "cpu").numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_and_bernoulli_bits(seed, shape):
    k = jax.random.fold_in(jax.random.key(seed), 5)
    tk = tr.fold_in(tr.key(seed), 5)
    want = np.asarray(jax.random.uniform(k, shape))
    got = tr.uniform(tk, shape, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert 0.0 <= got.min().item() and got.max().item() < 1.0
    np.testing.assert_array_equal(
        tr.random_bits(tk, shape, "cpu").numpy().astype(np.uint32),
        np.asarray(jax.random.bits(k, shape, jnp.uint32)))
    for p in (0.1, 0.5, 0.9, 0.15):
        np.testing.assert_array_equal(
            tr.bernoulli(tk, p, shape, "cpu").numpy(),
            np.asarray(jax.random.bernoulli(k, p, shape)))


def test_generator_keys_and_state():
    jg, tg = jr.Generator(11), tr.Generator(11)
    assert tg.initial_seed() == jg.initial_seed() == 11
    for _ in range(3):
        assert _tk(tg.next_key()) == _kd(jg.next_key())
    js, ts = jg.get_state(), tg.get_state()
    assert ts[:2] == js[:2] == (11, 3)
    np.testing.assert_array_equal(ts[2], np.asarray(js[2]))
    assert ts[2].dtype == np.uint32
    nxt = _tk(tg.next_key())
    assert nxt == _kd(jg.next_key())
    tg.set_state(ts)
    assert _tk(tg.next_key()) == nxt
    other = tr.Generator(0)
    other.set_state(js)                   # a JAX state restores too
    assert _tk(other.next_key()) == nxt
    tg.manual_seed(11)
    assert _tk(tg.next_key()) == _kd(jr.Generator(11).next_key())


def test_seed_and_rng_state_of_the_default_generator():
    paddle.seed(5)
    ptt.seed(5)
    assert _tk(tr.next_rng_key()) == _kd(jr.next_rng_key())
    state, jstate = ptt.get_rng_state(), paddle.get_rng_state()
    a = [_tk(tr.next_rng_key()) for _ in range(2)]
    assert a == [_kd(jr.next_rng_key()) for _ in range(2)]
    ptt.set_rng_state(state)
    paddle.set_rng_state(jstate)
    assert [_tk(tr.next_rng_key()) for _ in range(2)] == a


def test_rng_scope_counters():
    base_j = jax.random.key(9)
    base_t = tr.key(9)
    assert not tr.in_rng_scope()
    with tr.rng_scope(base_t), jr.rng_scope(base_j):
        assert tr.in_rng_scope()
        for ctr in range(3):
            kt, kj = tr.next_rng_key(), jr.next_rng_key()
            assert _tk(kt) == _kd(kj) == _tk(tr.fold_in(base_t, ctr))
        with tr.rng_scope(tr.key(1)):
            assert _tk(tr.next_rng_key()) == _tk(tr.fold_in(tr.key(1), 0))
        assert _tk(tr.next_rng_key()) == _tk(tr.fold_in(base_t, 3))
    assert not tr.in_rng_scope()


def test_use_generator():
    g = tr.Generator(21)
    ptt.seed(0)
    before = tr.default_generator()
    with tr.use_generator(g) as got:
        assert got is g
        k = tr.next_rng_key()
    assert tr.default_generator() is before
    assert _tk(k) == _kd(jr.Generator(21).next_key())
