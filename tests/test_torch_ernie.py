"""The port's ERNIE encoder, its MLM mask and its training step against
the JAX package's.

Parameters and states cross over with ``params_from_jax`` /
``train_state_from_jax``; tokens are seeded numpy. ``ErnieConfig.tiny()``
(f32, hidden 32, 4 heads, S = 32). The MLM mask is threefry bits on both
sides, so it is held bit for bit; logits, pooled outputs, the loss and
every gradient rtol = atol = 1e-4; three AdamW steps through the shared
step (``model=ernie``) 1e-4 on params and master, 1e-5 on the moments.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.models import ernie as je
from paddle_tpu.models import train as jt
from paddle_tpu_torch.models import ErnieConfig
from paddle_tpu_torch.models import ernie as te
from paddle_tpu_torch.models import train as tt
from paddle_tpu_torch.models import params_from_jax, train_state_from_jax

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 32
#: the key bias adds ``q . bk`` to every score of a query, a shift the
#: softmax cancels: its gradient is rounding noise (~1e-8) on both
#: sides, which AdamW turns into steps of +-lr of random sign. The step
#: test holds its moments (tiny on both sides) but not its values;
#: ``test_key_bias_gradient_is_null`` holds the gradient to zero.
NULL_GRAD = "layers/bk"


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = je.ErnieConfig.tiny(), ErnieConfig.tiny()
    jp = jax.tree.map(np.asarray, je.init_params(jax.random.key(0), jcfg))
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size - 1, (B, S)).astype(np.int32)
    return jcfg, tcfg, jp, params_from_jax(jp, device="cpu"), tokens


def test_config_matches_jax():
    for j, t in ((je.ErnieConfig(), ErnieConfig()),
                 (je.ErnieConfig.tiny(), ErnieConfig.tiny())):
        assert t.num_params() == j.num_params()
        assert t.flops_per_token(512) == j.flops_per_token(512)
        assert t.mask_token_id == j.mask_token_id and t.hd == j.hd
        assert (t.ln_eps, t.mlm_prob, t.mlm_seed, t.remat) == \
            (j.ln_eps, j.mlm_prob, j.mlm_seed, j.remat)
    assert ErnieConfig().dtype == torch.float32


def test_num_params_is_the_leaf_count():
    cfg = ErnieConfig.tiny()
    p = te.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(w.numel() for _, w in _leaves(p)) == cfg.num_params()
    assert p["mlm_bias"].dtype == torch.float32
    bf = te.init_params(ErnieConfig.tiny(dtype=torch.bfloat16),
                        torch.Generator().manual_seed(0), "cpu")
    assert bf["mlm_bias"].dtype == torch.float32
    assert bf["layers"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("shape,seed", [((3, 16), 0), ((2, 64), 1),
                                        ((1, 7), 2), ((4, 33), 3)])
def test_mlm_mask_bit_equal_to_jax(shape, seed):
    cfg = dict(mlm_seed=seed % 2, vocab_size=50000 if seed == 3 else 312)
    tokens = np.random.default_rng(seed).integers(
        0, cfg["vocab_size"], shape).astype(np.int32)
    want = np.asarray(je._mlm_mask(jnp.asarray(tokens),
                                   je.ErnieConfig.tiny(**cfg)))
    got = te._mlm_mask(torch.as_tensor(tokens), ErnieConfig.tiny(**cfg))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    other = te._mlm_mask(torch.as_tensor(tokens),
                         ErnieConfig.tiny(**dict(cfg, mlm_seed=7)))
    assert not torch.equal(other, got)


def test_mlm_mask_token_sum_wraps_mod_2_32():
    """A token sum past 2^32 folds in modulo 2^32, as JAX's uint32 sum."""
    tokens = np.full((2, 4), 2**30 + 3, np.int32)
    want = np.asarray(je._mlm_mask(jnp.asarray(tokens),
                                   je.ErnieConfig.tiny()))
    got = te._mlm_mask(torch.as_tensor(tokens), ErnieConfig.tiny())
    np.testing.assert_array_equal(got.numpy(), want)


def test_forward_with_segments_and_mask_matches_jax(model):
    jcfg, tcfg, jp, tp, tokens = model
    seg = np.zeros((B, S), np.int32)
    seg[:, S // 2:] = 1
    am = np.ones((B, S), np.int32)
    am[1, 20:] = 0
    for kw in ({}, {"segment_ids": seg}, {"segment_ids": seg,
                                         "attention_mask": am}):
        want = np.asarray(je.forward(jp, jnp.asarray(tokens), jcfg, **{
            k: jnp.asarray(v) for k, v in kw.items()}))
        got = te.forward(tp, torch.as_tensor(tokens), tcfg, **{
            k: torch.as_tensor(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), want, err_msg=str(list(kw)),
                                   **TOL)


def test_padded_batch_equals_unpadded_at_real_positions(model):
    _, tcfg, _, tp, tokens = model
    n = 20
    padded = tokens.copy()
    padded[:, n:] = 0
    am = np.zeros((B, S), np.int32)
    am[:, :n] = 1
    got = te.forward(tp, torch.as_tensor(padded), tcfg,
                     attention_mask=torch.as_tensor(am))
    want = te.forward(tp, torch.as_tensor(tokens[:, :n]), tcfg)
    torch.testing.assert_close(got[:, :n], want, rtol=1e-5, atol=1e-5)


def test_pooled_output_and_nsp_logits_match_jax(model):
    jcfg, tcfg, jp, tp, tokens = model
    jh = je.forward(jp, jnp.asarray(tokens), jcfg)
    jpool = je.pooled_output(jp, jh, jcfg)
    th = te.forward(tp, torch.as_tensor(tokens), tcfg)
    tpool = te.pooled_output(tp, th, tcfg)
    assert tpool.dtype == torch.float32 and tuple(tpool.shape) == (B, 32)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), **TOL)
    nsp = te.nsp_logits(tp, tpool)
    assert tuple(nsp.shape) == (B, 2)
    np.testing.assert_allclose(nsp.numpy(),
                               np.asarray(je.nsp_logits(jp, jpool)), **TOL)


@pytest.mark.parametrize("seq_chunk", [None, 8])
def test_loss_and_grads_match_jax(model, seq_chunk):
    jcfg, tcfg, jp, tp, tokens = model
    lv, g = jax.value_and_grad(
        lambda p: je.loss_fn(p, jnp.asarray(tokens), jcfg,
                             seq_chunk=seq_chunk))(jp)
    params = {k: ({n: w.clone().requires_grad_(True) for n, w in v.items()}
                  if isinstance(v, dict) else v.clone().requires_grad_(True))
              for k, v in tp.items()}
    loss = te.loss_fn(params, torch.as_tensor(tokens), tcfg,
                      seq_chunk=seq_chunk)
    names, leaves = zip(*_leaves(params))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(loss.item(), float(lv), **TOL)
    want = dict(_leaves(jax.tree.map(np.asarray, g)))
    for n, gt in zip(names, grads):
        np.testing.assert_allclose(gt.numpy(), want[n], err_msg=n, **TOL)


def test_remat_equals_no_remat(model):
    _, tcfg, _, tp, tokens = model
    a = te.loss_fn(tp, torch.as_tensor(tokens), tcfg)
    b = te.loss_fn(tp, torch.as_tensor(tokens), ErnieConfig.tiny(remat=True))
    assert a.item() == pytest.approx(b.item(), rel=1e-6)


def test_train_steps_match_jax(model):
    jcfg, tcfg, _, _, tokens = model
    jstate = jt.init_train_state(jax.random.key(3), jcfg, model=je)
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    assert tstate.params["mlm_bias"].dtype == torch.float32
    jstep = jt.make_train_step(jcfg, lr=1e-3, seq_chunk=8, model=je)
    tstep = tt.make_train_step(tcfg, lr=1e-3, seq_chunk=8, model=te)
    jtok, ttok = jnp.asarray(tokens), torch.as_tensor(tokens)
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, jtok)
        tstate, tm = tstep(tstate, ttok)
        losses.append(tm["loss"].item())
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), **TOL)
    assert losses[-1] < losses[0]
    for part, tol in (("params", TOL), ("master", TOL),
                      ("m", dict(rtol=1e-5, atol=1e-5)),
                      ("v", dict(rtol=1e-5, atol=1e-5))):
        want = dict(_leaves(jax.tree.map(np.asarray, getattr(jstate, part))))
        for n, t in _leaves(getattr(tstate, part)):
            if n == NULL_GRAD and part in ("params", "master"):
                continue
            np.testing.assert_allclose(t.numpy(), want[n],
                                       err_msg=f"{part}/{n}", **tol)


def test_key_bias_gradient_is_null(model):
    """``bk``'s gradient is zero in exact arithmetic on both sides (see
    NULL_GRAD), so Adam's first steps on it are the signs of rounding
    noise and the step test leaves its values out."""
    jcfg, tcfg, jp, tp, tokens = model
    g = jax.grad(lambda p: je.loss_fn(p, jnp.asarray(tokens), jcfg))(jp)
    assert np.abs(np.asarray(g["layers"]["bk"])).max() < 1e-6
    bk = tp["layers"]["bk"].clone().requires_grad_(True)
    params = dict(tp, layers=dict(tp["layers"], bk=bk))
    (gt,) = torch.autograd.grad(
        te.loss_fn(params, torch.as_tensor(tokens), tcfg), [bk])
    assert gt.abs().max().item() < 1e-6


def test_mesh_raises_naming_step_8():
    with pytest.raises(NotImplementedError, match="step 8"):
        tt.make_train_step(ErnieConfig.tiny(), mesh=object(), model=te)


def test_bridge_carries_bf16_trees_bit_for_bit():
    """``train_state_from_jax`` moves GPT's and ERNIE's bf16 trees (and
    ERNIE's f32 ``mlm_bias``) bit for bit."""
    from paddle_tpu.models import gpt as jg
    for mod, cfg in ((jg, jg.GPTConfig.tiny(dtype=jnp.bfloat16)),
                     (je, je.ErnieConfig.tiny(dtype=jnp.bfloat16))):
        js = jax.tree.map(np.asarray,
                          jt.init_train_state(jax.random.key(1), cfg,
                                              model=mod))
        ts = train_state_from_jax(js, device="cpu")
        for part in ("params", "master", "m", "v"):
            want = dict(_leaves(getattr(js, part)))
            for n, t in _leaves(getattr(ts, part)):
                w = want[n]
                if w.dtype.name == "bfloat16":
                    assert t.dtype == torch.bfloat16, n
                    np.testing.assert_array_equal(
                        t.view(torch.int16).numpy(),
                        w.view(np.int16), err_msg=n)
                else:
                    assert t.dtype == torch.float32, n
                    np.testing.assert_array_equal(t.numpy(), w, err_msg=n)
        if mod is je:
            assert ts.params["mlm_bias"].dtype == torch.float32
            assert ts.params["word_embed"].dtype == torch.bfloat16
