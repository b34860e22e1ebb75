"""The port's Llama model and training step against the JAX package's.

Parameters and states cross over with ``params_from_jax`` /
``train_state_from_jax``; tokens are seeded numpy. Two configs: ``tiny()``
(head dim 16, the einsum attention on both sides) and
``tiny(hidden_size=256, num_heads=4, num_kv_heads=2)`` at S = 128, where
the JAX model takes its Pallas flash kernels (interpret mode) and the
port on the CPU its einsum path; each with ``fused_kernels`` "xla" and
"auto" and "pallas". Under "pallas" the JAX model takes its fused
RMSNorm and SwiGLU Pallas kernels (interpret mode) and the port its
fused ops' plain versions; under "auto" the JAX model takes the same
kernels (interpret mode makes them available) and the port on the CPU
its "xla" composition, the reference's rule that "auto" is fused only
where the kernels run (in f32 the two agree to the last bits).
Tolerances, float32: logits, loss and
gradients rtol = atol = 1e-4 (XLA-CPU and PyTorch sum in other orders);
three AdamW steps 1e-4 on params/master (an update is lr * m/sqrt(v),
which amplifies an O(1e-7) gradient difference where a gradient is
near zero), 1e-5 on the moments.
"""
import importlib.util
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.models import llama as jl
from paddle_tpu.models import train as jt
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import train as tt
from paddle_tpu_torch.models import params_from_jax, train_state_from_jax
from paddle_tpu_torch.models.moe import MoEConfig

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
REPO = pathlib.Path(__file__).resolve().parents[1]

CONFIGS = {"tiny": (dict(), 32),
           "hd64": (dict(hidden_size=256, num_heads=4, num_kv_heads=2), 128)}


@pytest.fixture(autouse=True)
def _interpret():
    jfa.set_interpret(True)
    yield
    jfa.set_interpret(False)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


#: (config, fused_kernels); the "xla" cases keep their config's name
CASES = [(n, f) for f in ("xla", "auto", "pallas") for n in CONFIGS]
CASE_IDS = [n if f == "xla" else f"{n}-{f}" for n, f in CASES]
_JAX = {}


def _jax_once(key, fn):
    """A JAX result that cases share, computed once a module. In
    interpret mode the JAX package's "auto" takes the fused Pallas path
    as "pallas" does (``jl._pallas_fused``), so the two port modes,
    which differ on the CPU, are held to one JAX computation: callers
    key it by that predicate."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _both(name, **kw):
    over, seq = CONFIGS[name]
    jcfg = jl.LlamaConfig.tiny(**over, **kw)
    tcfg = tl.LlamaConfig.tiny(**over, **kw)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, seq))
    return jcfg, tcfg, jp, tp, toks.astype(np.int32)


def _grads(tp, tcfg, toks, **kw):
    """loss_fn and its gradients by leaf path; ``tp`` is left as it was."""
    leaves = dict(_leaves(tp))
    for p in leaves.values():
        p.requires_grad_(True)
    loss = tl.loss_fn(tp, torch.from_numpy(toks), tcfg, **kw)
    loss.backward()
    grads = {n: p.grad for n, p in leaves.items()}
    for p in leaves.values():
        p.requires_grad_(False)
        p.grad = None
    return loss.detach(), grads


@pytest.mark.parametrize("name,fused_kernels", CASES, ids=CASE_IDS)
def test_forward_loss_and_grads_match_jax(name, fused_kernels):
    jcfg, tcfg, jp, tp, toks = _both(name, fused_kernels=fused_kernels)
    jtoks = jnp.asarray(toks)

    def jax_side():
        jlog = jax.jit(lambda p: jl.forward(p, jtoks, jcfg))(jp)
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jl.loss_fn(p, jtoks, jcfg, seq_chunk=16)))(jp)
        return np.asarray(jlog), jloss, jgrads
    jlog, jloss, jgrads = _jax_once(
        ("forward", name, jl._pallas_fused(jcfg)), jax_side)
    np.testing.assert_allclose(
        tl.forward(tp, torch.from_numpy(toks), tcfg).numpy(), jlog, **TOL)
    loss, grads = _grads(tp, tcfg, toks, seq_chunk=16)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    assert grads.keys() == want.keys()
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n], err_msg=n, **TOL)


def test_chunked_loss_equals_dense_and_remat_equals_no_remat():
    """Under "xla" and under "pallas" (the fused ops' plain versions)."""
    for fused_kernels in ("xla", "pallas"):
        _, tcfg, _, tp, toks = _both("tiny", fused_kernels=fused_kernels)
        dense, gd = _grads(tp, tcfg, toks)
        chunked, gc = _grads(tp, tcfg, toks, seq_chunk=8)
        np.testing.assert_allclose(chunked.item(), dense.item(), rtol=1e-6)
        for n in gd:
            np.testing.assert_allclose(gc[n].numpy(), gd[n].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=n)
        for policy in tl.REMAT_POLICIES:
            rcfg = tl.LlamaConfig.tiny(remat=True, remat_policy=policy,
                                       fused_kernels=fused_kernels)
            loss, gr = _grads(tp, rcfg, toks)
            assert loss.item() == dense.item(), (fused_kernels, policy)
            for n in gd:
                torch.testing.assert_close(
                    gr[n], gd[n], rtol=0, atol=0,
                    msg=f"{fused_kernels} {policy} {n}")


def test_causality_and_num_params():
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    t1 = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 12))
    t2 = t1.copy()
    t2[0, -1] = (t2[0, -1] + 1) % cfg.vocab_size
    l1, l2 = (tl.forward(params, torch.from_numpy(t), cfg).numpy()
              for t in (t1, t2))
    np.testing.assert_allclose(l1[:, :-1], l2[:, :-1], rtol=1e-5, atol=1e-6)
    assert not np.allclose(l1[:, -1], l2[:, -1])
    n = sum(p.numel() for _, p in _leaves(params))
    assert n == cfg.num_params()
    big = dict(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
               num_layers=20, num_heads=12, num_kv_heads=12)
    jbig, tbig = jl.LlamaConfig(**big), tl.LlamaConfig(**big)
    assert tbig.num_params() == jbig.num_params()
    assert tbig.flops_per_token(4096) == jbig.flops_per_token(4096)


def test_options_the_port_does_not_take_raise():
    with pytest.raises(ValueError, match="fused_kernels"):
        tl.LlamaConfig.tiny(fused_kernels="triton")
    # a moe that is not the port's MoEConfig (the JAX package's among
    # them), and MoE training over a mesh, still raise with their step
    with pytest.raises(NotImplementedError, match="ROADMAP.*step 8"):
        tl.LlamaConfig.tiny(moe=object())
    with pytest.raises(ValueError, match="remat_policy"):
        tl.LlamaConfig.tiny(remat_policy="everything")
    with pytest.raises(NotImplementedError, match="ROADMAP.*step 8"):
        tt.make_train_step(tl.LlamaConfig.tiny(), mesh=object())
    moe_cfg = tl.LlamaConfig.tiny(moe=MoEConfig(num_experts=4, top_k=2))
    with pytest.raises(NotImplementedError,
                       match="expert-parallel MoE.*ROADMAP.*step 8"):
        tt.make_train_step(moe_cfg, mesh=object())
    _, tcfg, _, tp, toks = _both("tiny")
    with pytest.raises(ValueError, match="divide"):
        tl.loss_fn(tp, torch.from_numpy(toks), tcfg, seq_chunk=5)


@pytest.mark.parametrize("name,fused_kernels", CASES, ids=CASE_IDS)
def test_train_steps_match_jax(name, fused_kernels):
    """Three steps from the JAX state carried over bit for bit: loss,
    grad_norm and every params, master, m and v leaf."""
    over, seq = CONFIGS[name]
    jcfg = jl.LlamaConfig.tiny(**over, fused_kernels=fused_kernels)
    tcfg = tl.LlamaConfig.tiny(**over, fused_kernels=fused_kernels)
    kw = dict(lr=1e-3, seq_chunk=16)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (2, seq)).astype(np.int32)

    def jax_side():
        jstep = jt.make_train_step(jcfg, **kw)
        jstate = jt.init_train_state(jax.random.key(1), jcfg)
        start, metrics = jax.tree.map(np.asarray, jstate), []
        for _ in range(3):
            jstate, jm = jstep(jstate, jnp.asarray(toks))
            metrics.append({k: float(jm[k]) for k in ("loss", "grad_norm")})
        return start, metrics, jax.tree.map(np.asarray, jstate)
    start, metrics, js = _jax_once(
        ("train", name, jl._pallas_fused(jcfg)), jax_side)
    tstep = tt.make_train_step(tcfg, **kw)
    tstate = train_state_from_jax(start, device="cpu")
    for (n, a), (_, b) in zip(_leaves(tstate.master),
                              _leaves(start.master)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=n)
    for jm in metrics:
        tstate, tm = tstep(tstate, torch.from_numpy(toks))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[k].item(), jm[k], **TOL)
    assert tstate.step == int(js.step) == 3
    for field, tol in (("params", TOL), ("master", TOL),
                       ("m", dict(rtol=1e-5, atol=1e-5)),
                       ("v", dict(rtol=1e-5, atol=1e-5))):
        want = dict(_leaves(getattr(js, field)))
        for n, a in _leaves(getattr(tstate, field)):
            np.testing.assert_allclose(a.numpy(), want[n],
                                       err_msg=f"{field}/{n}", **tol)


def test_loss_decreases():
    cfg = tl.LlamaConfig.tiny()
    step = tt.make_train_step(cfg, lr=1e-2)
    state = tt.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)))
    losses = []
    for _ in range(8):
        state, m = step(state, toks)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] * 0.7, losses
    assert state.step == 8


def test_entry_matches_the_jax_entry():
    """``entry()`` builds the same config and tokens as
    ``__graft_entry__.entry()``; on the JAX entry's own parameters the
    port's forward gives its logits."""
    from paddle_tpu_torch.entry import entry
    spec = importlib.util.spec_from_file_location(
        "graft_entry", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jfn, (jp, jtoks) = mod.entry()
    fn, (params, toks) = entry(device="cpu")
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert fn(params, toks).shape == (2, 128, 256)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    np.testing.assert_allclose(fn(tp, toks).numpy(),
                               np.asarray(jfn(jp, jtoks)), **TOL)
