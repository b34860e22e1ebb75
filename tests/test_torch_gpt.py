"""The port's GPT-2 model and its training step against the JAX package's.

Parameters and states cross over with ``params_from_jax`` /
``train_state_from_jax``; tokens are seeded numpy. ``GPTConfig.tiny()``
(f32, head dim 16, S = 32): the einsum attention on both sides (the
port's flash kernels run only for CUDA tensors). Tolerances, float32:
logits, loss and every gradient rtol = atol = 1e-4 (XLA-CPU and PyTorch
sum in other orders); three AdamW steps through the shared step
(``model=gpt``) 1e-4 on params and master, 1e-5 on the moments, as
``test_torch_train.py`` holds the Llama step.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.models import gpt as jg
from paddle_tpu.models import train as jt
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.models import train as tt
from paddle_tpu_torch.models import params_from_jax, train_state_from_jax

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 32


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def model():
    """JAX tiny params (numpy), the port's copy, and a token batch."""
    jcfg, tcfg = jg.GPTConfig.tiny(), tg.GPTConfig.tiny()
    jp = jax.tree.map(np.asarray, jg.init_params(jax.random.key(0), jcfg))
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jp, params_from_jax(jp, device="cpu"), tokens


def _torch_loss_grads(tp, tokens, cfg, seq_chunk=None):
    params = {k: ({n: w.clone().requires_grad_(True) for n, w in v.items()}
                  if isinstance(v, dict) else v.clone().requires_grad_(True))
              for k, v in tp.items()}
    loss = tg.loss_fn(params, torch.as_tensor(tokens), cfg,
                      seq_chunk=seq_chunk)
    names, leaves = zip(*_leaves(params))
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), dict(zip(names, grads))


def test_config_and_presets_match_jax():
    for name in ("gpt2_124m", "gpt2_medium", "gpt2_large", "tiny"):
        j, t = getattr(jg.GPTConfig, name)(), getattr(tg.GPTConfig, name)()
        assert t.hd == j.hd and t.num_params() == j.num_params()
        assert t.flops_per_token(1024) == j.flops_per_token(1024)
        for f in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_layers", "num_heads", "max_seq_len", "ln_eps",
                  "remat"):
            assert getattr(t, f) == getattr(j, f), (name, f)
    assert tg.GPTConfig.gpt2_124m().hd == 64
    assert tg.GPTConfig().dtype == torch.bfloat16


def test_num_params_is_the_leaf_count():
    for cfg in (tg.GPTConfig.tiny(), tg.GPTConfig.tiny(num_layers=3,
                                                       max_seq_len=64)):
        p = tg.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        assert sum(w.numel() for _, w in _leaves(p)) == cfg.num_params()


def test_init_law_and_layout_match_jax(model):
    jcfg, _, jp, _, _ = model
    cfg = tg.GPTConfig.tiny(hidden_size=128, intermediate_size=256,
                            num_layers=4)
    tp = tg.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    jshape = jax.eval_shape(lambda k: jg.init_params(k, jg.GPTConfig.tiny(
        hidden_size=128, intermediate_size=256, num_layers=4)),
        jax.random.key(0))
    for (n, t), (_, j) in zip(_leaves(tp), _leaves(jshape)):
        assert tuple(t.shape) == tuple(j.shape), n
        assert t.dtype == torch.float32 and j.dtype == jnp.float32, n
    L = cfg.num_layers
    for n, std in (("wqkv", 0.02), ("w1", 0.02),
                   ("wo", 0.02 / math.sqrt(2 * L)),
                   ("w2", 0.02 / math.sqrt(2 * L))):
        assert abs(tp["layers"][n].std().item() / std - 1) < 0.05, n
    assert (tp["layers"]["ln1_g"] == 1).all()
    assert (tp["layers"]["bqkv"] == 0).all()


def test_forward_matches_jax(model):
    jcfg, tcfg, jp, tp, tokens = model
    want = np.asarray(jg.forward(jp, jnp.asarray(tokens), jcfg))
    got = tg.forward(tp, torch.as_tensor(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    hid = np.asarray(jg.forward(jp, jnp.asarray(tokens), jcfg,
                                return_hidden=True))
    np.testing.assert_allclose(
        tg.forward(tp, torch.as_tensor(tokens), tcfg,
                   return_hidden=True).numpy(), hid, **TOL)


@pytest.mark.parametrize("seq_chunk", [None, 16])
def test_loss_and_grads_match_jax(model, seq_chunk):
    jcfg, tcfg, jp, tp, tokens = model
    lv, g = jax.value_and_grad(
        lambda p: jg.loss_fn(p, jnp.asarray(tokens), jcfg,
                             seq_chunk=seq_chunk))(jp)
    loss, grads = _torch_loss_grads(tp, tokens, tcfg, seq_chunk)
    np.testing.assert_allclose(loss, float(lv), **TOL)
    jg_ = dict(_leaves(jax.tree.map(np.asarray, g)))
    assert set(grads) == set(jg_)
    for n, gt in grads.items():
        np.testing.assert_allclose(gt.numpy(), jg_[n], err_msg=n, **TOL)


def test_remat_equals_no_remat(model):
    _, tcfg, _, tp, tokens = model
    a = _torch_loss_grads(tp, tokens, tcfg)
    b = _torch_loss_grads(tp, tokens, tg.GPTConfig.tiny(remat=True))
    assert a[0] == pytest.approx(b[0], rel=1e-6)
    for n in a[1]:
        torch.testing.assert_close(a[1][n], b[1][n], rtol=1e-5, atol=1e-6)


def test_causal(model):
    _, tcfg, _, tp, tokens = model
    t2 = tokens.copy()
    t2[:, 20:] = (t2[:, 20:] + 1) % tcfg.vocab_size
    a = tg.forward(tp, torch.as_tensor(tokens), tcfg)
    b = tg.forward(tp, torch.as_tensor(t2), tcfg)
    torch.testing.assert_close(a[:, :20], b[:, :20], rtol=0, atol=0)
    assert not torch.allclose(a[:, 20:], b[:, 20:])


def test_train_steps_match_jax(model):
    jcfg, tcfg, _, _, tokens = model
    jstate = jt.init_train_state(jax.random.key(3), jcfg, model=jg)
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    jstep = jt.make_train_step(jcfg, lr=1e-3, seq_chunk=16, model=jg)
    tstep = tt.make_train_step(tcfg, lr=1e-3, seq_chunk=16, model=tg)
    jtok, ttok = jnp.asarray(tokens), torch.as_tensor(tokens)
    for _ in range(3):
        jstate, jm = jstep(jstate, jtok)
        tstate, tm = tstep(tstate, ttok)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), **TOL)
    assert tstate.step == int(jstate.step) == 3
    for part, tol in (("params", TOL), ("master", TOL),
                      ("m", dict(rtol=1e-5, atol=1e-5)),
                      ("v", dict(rtol=1e-5, atol=1e-5))):
        want = dict(_leaves(jax.tree.map(np.asarray, getattr(jstate, part))))
        for n, t in _leaves(getattr(tstate, part)):
            np.testing.assert_allclose(t.numpy(), want[n],
                                       err_msg=f"{part}/{n}", **tol)


def test_loss_falls_on_the_shared_step():
    cfg = tg.GPTConfig.tiny(remat=True)
    state = tt.init_train_state(cfg, torch.Generator().manual_seed(0),
                                device="cpu", model=tg)
    step = tt.make_train_step(cfg, lr=3e-3, model=tg)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32)
    losses = [step(state, tokens)[1]["loss"].item() for _ in range(5)]
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0] - 0.1, losses


def test_mesh_raises_naming_step_8():
    for cfg in (tg.GPTConfig.tiny(), tg.GPTConfig()):
        with pytest.raises(NotImplementedError, match="step 8"):
            tt.make_train_step(cfg, mesh=object(), model=tg)
