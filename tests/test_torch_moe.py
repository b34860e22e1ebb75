"""The port's Mixture-of-Experts Llama against the JAX package's, on CPU.

One device (no mesh). Inputs are seeded numpy; the JAX parameter tree
crosses over with ``params_from_jax``, the training state with
``train_state_from_jax``. The model is
``LlamaConfig.tiny(num_layers=2, max_seq_len=64, moe=MoEConfig(
num_experts=4, top_k=2))`` on ``jax.random.key(1)``, the reference's own
single-device MoE engine model (``tests/test_tp2d_serving.py``).

- router: dispatch bit for bit, combine, logits, aux and z loss within
  1e-6, at top-1 and top-2, on the capacity-drop case of
  ``tests/test_moe.py::test_capacity_drops_tokens`` (one expert takes
  every token, capacity 4) and on crafted ties (equal logits: the lower
  expert wins, in the training router and in the serving top-k);
- ``moe_ffn``: output within 1e-5, gradients of x, ``w_gate``, ``wg``,
  ``wu`` and ``wd`` within 1e-4 of ``jax.grad``, with capacity drops;
  ``init_moe_params``: the JAX leaves, shapes, dtypes and init law;
- the model: ``forward`` and ``loss_fn`` (aux included) within 1e-4,
  three train steps under "xla" and "auto" (remat on: the aux leaves the
  checkpointed block) with loss, grad_norm and every state leaf within
  1e-4 (moments 1e-5), ``num_params`` equal to the leaf count;
- serving: ``_moe_ffn`` at a prefill chunk within 1e-5; greedy engine
  tokens identical to the JAX engine's, KV f32 and int8, plain and
  n-gram speculation, and with the draft model and the adapter pool on
  the expert leaves; dense ``generate`` and ``beam_search`` tokens
  identical; ``quantize_weights`` leaves the expert stacks alone and its
  engine gives the JAX engine's tokens;
- ``paged_prefill_insert``: last-token logits within 1e-5 and the page
  bytes of the request's pages, f32 and int8 KV, with and without a
  left-padded ``prompt_len``, dense and MoE;
- the serving expert apply allocates no per-item copy of the expert
  matrices (bytes of every op output under a dispatch mode).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import generate as jg
from paddle_tpu.models import llama as jl
from paddle_tpu.models import moe as jm
from paddle_tpu.models import train as jt
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import generate as tg
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import moe as tm
from paddle_tpu_torch.models import params_from_jax, train_state_from_jax
from paddle_tpu_torch.models import train as tt
from paddle_tpu_torch.serving import AdapterRegistry, init_lora

import test_torch_scheduler as ts

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
ENG = dict(max_batch=2, page_size=8, max_len=32, prefill_chunk=8)
_MOE = dict(num_experts=4, top_k=2)
JCFG = jl.LlamaConfig.tiny(num_layers=2, max_seq_len=64,
                           moe=jm.MoEConfig(**_MOE))
TCFG = tl.LlamaConfig.tiny(num_layers=2, max_seq_len=64,
                           moe=tm.MoEConfig(**_MOE))
_CACHE = {}


def _once(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


def _params():
    """(JAX params, port params) of the MoE model, made once."""
    def make():
        jp = jl.init_params(jax.random.key(1), JCFG)
        return jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return _once("params", make)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _prompts(lens, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(3, JCFG.vocab_size, (n,)).astype(np.int32)
            for n in lens]


# ------------------------------------------------------------ the router
def _router_case(case, rng):
    """(x (T, H), w_gate (H, E), E, capacity_factor)."""
    if case == "drop":
        # tests/test_moe.py::test_capacity_drops_tokens: every token to
        # expert 0, capacity 4 of 16
        T, H, E = 16, 8, 4
        w_gate = np.zeros((H, E), np.float32)
        w_gate[:, 0] = 10.0
        x = np.abs(rng.standard_normal((T, H))).astype(np.float32)
        return x, w_gate, E, 1.0
    if case == "tie":
        # experts 1 and 3 share a column (equal logits on every token),
        # expert 2 the largest one on half the tokens
        T, H, E = 24, 8, 4
        w_gate = rng.standard_normal((H, E)).astype(np.float32)
        w_gate[:, 3] = w_gate[:, 1]
        x = rng.standard_normal((T, H)).astype(np.float32)
        x[::2] = np.abs(x[::2])
        w_gate[:, 2] = np.abs(w_gate[:, 2]) * 0.5
        return x, w_gate, E, 2.0
    T, H, E = 40, 16, 4
    return (rng.standard_normal((T, H)).astype(np.float32),
            rng.standard_normal((H, E)).astype(np.float32), E, 0.5)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("case", ["drop", "tie", "random"])
def test_router_matches_jax(case, top_k):
    x, w_gate, E, cf = _router_case(case, np.random.default_rng(5))
    kw = dict(num_experts=E, top_k=top_k, capacity_factor=cf,
              min_capacity=4)
    jd, jc, jlog, jlosses = jm.router(jnp.asarray(x), jnp.asarray(w_gate),
                                      jm.MoEConfig(**kw))
    td, tc, tlog, tlosses = tm.router(torch.from_numpy(x),
                                      torch.from_numpy(w_gate),
                                      tm.MoEConfig(**kw))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-6,
                               atol=1e-6)
    for n in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(tlosses[n].item(), float(jlosses[n]),
                                   rtol=1e-6, atol=1e-7)
    kept = td.numpy().sum(axis=(1, 2))
    if case == "drop":
        # the first C tokens fit expert 0's C slots (4 at top-1, 8 at
        # top-2), later ones drop; top-2's second pass sends every token
        # to expert 1, the lowest of three tied experts, and drops the
        # same way
        C = tm.MoEConfig(**kw).capacity(x.shape[0])
        assert C == 4 * top_k
        first_c = [1] * C + [0] * (16 - C)
        assert (td.numpy()[:, 0].sum(-1) == first_c).all()
        if top_k == 2:
            assert (td.numpy()[:, 1].sum(-1) == first_c).all()
        assert kept.sum() == top_k * C
    if case == "tie":
        # equal logits: the lower expert (1) is taken first, 3 never
        # before it
        r = tm.route(torch.from_numpy(x), torch.from_numpy(w_gate),
                     tm.MoEConfig(**kw))
        first = r.expert[:, 0].numpy()
        assert 3 not in first and (first == 1).any()
        if top_k == 2:
            assert ((r.expert[:, 1].numpy() == 3)
                    == (first == 1)).all()


def test_serving_top_k_breaks_ties_to_the_lower_expert():
    """The serving router's top-k against JAX's ``lax.top_k`` on exact
    ties (two equal columns, and an all-equal row): the same experts
    in the same slots, so the same outputs."""
    jp, tp = _params()
    rng = np.random.default_rng(9)
    lp = {k: v[0] for k, v in jp["layers"].items()}
    tlp = {k: v[0] for k, v in tp["layers"].items()}
    gate = np.asarray(lp["moe_gate"]).copy()
    gate[:, 2] = gate[:, 0]
    lp = dict(lp, moe_gate=jnp.asarray(gate))
    tlp = dict(tlp, moe_gate=torch.from_numpy(gate))
    h = rng.standard_normal((2, 5, JCFG.hidden_size)).astype(np.float32)
    h[0, 0] = 0.0                           # every logit 0: experts 0, 1
    want = np.asarray(jg._moe_ffn(jnp.asarray(h), lp, JCFG))
    got = tg._moe_ffn(torch.from_numpy(h), tlp, TCFG).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ moe_ffn
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_values_and_grads_match_jax(top_k):
    rng = np.random.default_rng(top_k)
    B, S, H, I, E = 2, 20, 16, 24, 4
    kw = dict(num_experts=E, top_k=top_k, capacity_factor=0.75)
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    p = {"w_gate": rng.standard_normal((H, E)).astype(np.float32),
         "wg": 0.3 * rng.standard_normal((E, H, I)).astype(np.float32),
         "wu": 0.3 * rng.standard_normal((E, H, I)).astype(np.float32),
         "wd": 0.3 * rng.standard_normal((E, I, H)).astype(np.float32)}
    names = ("w_gate", "wg", "wu", "wd")

    def jloss(x, p):
        y, losses = jm.moe_ffn(x, p, jm.MoEConfig(**kw))
        return jnp.sum(y * y) + losses["aux_loss"] + losses["z_loss"], y
    (jv, jy), (jgx, jgp) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()})
    tx = torch.from_numpy(x).requires_grad_()
    tp = {n: torch.from_numpy(v).requires_grad_() for n, v in p.items()}
    ty, losses = tm.moe_ffn(tx, tp, tm.MoEConfig(**kw))
    tv = (ty * ty).sum() + losses["aux_loss"] + losses["z_loss"]
    grads = torch.autograd.grad(tv, [tx] + [tp[n] for n in names])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.item(), float(jv), **TOL)
    for n, g, want in zip(("x",) + names, grads,
                          [jgx] + [jgp[n] for n in names]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), err_msg=n,
                                   **TOL)
    # some tokens dropped: the capacity binds
    r = tm.route(torch.from_numpy(x).reshape(B * S, H),
                 torch.from_numpy(p["w_gate"]), tm.MoEConfig(**kw))
    assert not r.keep.all()


def test_init_moe_params_shapes_dtypes_and_law():
    """The JAX ``init_moe_params``'s leaves, shapes and dtypes; every
    leaf N(0, 1/fan_in) (std within 5% over its draws); the f32 router
    holds values rounded to the model dtype, as the JAX package's."""
    H, I = 256, 96                  # the router's 2048 draws: SE 1.6%
    kw = dict(num_experts=8, top_k=2)
    want = jm.init_moe_params(jax.random.key(0), H, I, jm.MoEConfig(**kw))
    got = tm.init_moe_params(H, I, tm.MoEConfig(**kw),
                             torch.Generator().manual_seed(0),
                             device="cpu")
    assert got.keys() == want.keys()
    for n, w in got.items():
        assert tuple(w.shape) == want[n].shape, n
        assert str(w.dtype).split(".")[-1] == want[n].dtype.name, n
        fan_in = I if n == "wd" else H
        std = w.float().std().item() * fan_in ** 0.5
        assert abs(std - 1.0) < 0.05, (n, std)
    g = got["w_gate"]
    torch.testing.assert_close(g.to(torch.bfloat16).float(), g, rtol=0,
                               atol=0)


# ------------------------------------------------------------ the model
def test_forward_loss_and_num_params_match_jax():
    jp, tp = _params()
    toks = np.random.default_rng(3).integers(
        0, JCFG.vocab_size, (2, 32)).astype(np.int32)
    jlog = jl.forward(jp, jnp.asarray(toks), JCFG)
    np.testing.assert_allclose(
        tl.forward(tp, torch.from_numpy(toks), TCFG).numpy(),
        np.asarray(jlog), **TOL)
    for chunk in (None, 16):
        jloss = jl.loss_fn(jp, jnp.asarray(toks), JCFG, seq_chunk=chunk)
        tloss = tl.loss_fn(tp, torch.from_numpy(toks), TCFG,
                           seq_chunk=chunk)
        np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    # the aux is in the loss: without it the loss differs
    _, aux = tl._trunk(tp, torch.from_numpy(toks), TCFG)
    assert aux.item() > 0
    assert sum(v.numel() for _, v in _leaves(tp)) == TCFG.num_params() \
        == JCFG.num_params()
    assert tp["layers"]["moe_gate"].dtype == torch.float32
    own = tl.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")
    assert {n: (tuple(v.shape), v.dtype) for n, v in _leaves(own)} == {
        n: (tuple(v.shape), v.dtype) for n, v in _leaves(tp)}


@pytest.mark.parametrize("fused_kernels", ["xla", "auto"])
def test_train_steps_match_jax(fused_kernels):
    """Three steps from the JAX state, remat on (policy "nothing" under
    "xla", "attn" under "auto"): loss (aux included), grad_norm and
    every params, master, m and v leaf."""
    policy = "nothing" if fused_kernels == "xla" else "attn"
    over = dict(num_layers=2, max_seq_len=64, remat=True,
                remat_policy=policy, fused_kernels=fused_kernels)
    jcfg = jl.LlamaConfig.tiny(moe=jm.MoEConfig(**_MOE), **over)
    tcfg = tl.LlamaConfig.tiny(moe=tm.MoEConfig(**_MOE), **over)
    kw = dict(lr=1e-3, seq_chunk=16)
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    jstep = jt.make_train_step(jcfg, **kw)
    jstate = jt.init_train_state(jax.random.key(2), jcfg)
    start = jax.tree.map(np.asarray, jstate)
    tstate = train_state_from_jax(start, device="cpu")
    tstep = tt.make_train_step(tcfg, **kw)
    for _ in range(3):
        jstate, jmet = jstep(jstate, jnp.asarray(toks))
        tstate, tmet = tstep(tstate, torch.from_numpy(toks))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), **TOL)
    js = jax.tree.map(np.asarray, jstate)
    assert tstate.step == int(js.step) == 3
    for field, tol in (("params", TOL), ("master", TOL),
                       ("m", dict(rtol=1e-5, atol=1e-5)),
                       ("v", dict(rtol=1e-5, atol=1e-5))):
        want = dict(_leaves(getattr(js, field)))
        got = dict(_leaves(getattr(tstate, field)))
        assert got.keys() == want.keys()
        for n, a in got.items():
            np.testing.assert_allclose(a.numpy(), want[n],
                                       err_msg=f"{field}/{n}", **tol)
    assert tstate.params["layers"]["moe_gate"].dtype == torch.float32


# ------------------------------------------------------------ serving
def test_serving_moe_ffn_matches_jax_at_a_prefill_chunk():
    jp, tp = _params()
    h = np.random.default_rng(8).standard_normal(
        (1, 64, JCFG.hidden_size)).astype(np.float32)
    for l in range(JCFG.num_layers):
        lp = {k: v[l] for k, v in jp["layers"].items()}
        tlp = {k: v[l] for k, v in tp["layers"].items()}
        np.testing.assert_allclose(
            tg._moe_ffn(torch.from_numpy(h), tlp, TCFG).numpy(),
            np.asarray(jg._moe_ffn(jnp.asarray(h), lp, JCFG)),
            rtol=1e-5, atol=1e-5)


class _Bytes(TorchDispatchMode):
    """Bytes of every tensor an op returns, and the largest one."""

    def __init__(self):
        super().__init__()
        self.total = self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                n = t.numel() * t.element_size()
                self.total += n
                self.largest = max(self.largest, n)
        return out


def test_serving_expert_apply_gathers_no_matrix():
    """At a 256-token chunk (512 routed items) a per-item copy of one
    projection's expert matrices is 512 x H x i x 4 B = 16.8 MB; the
    grouped apply allocates less than one such copy in all, and no
    tensor larger than the items' (512, i) activations."""
    _, tp = _params()
    tlp = {k: v[0] for k, v in tp["layers"].items()}
    H, i = TCFG.hidden_size, TCFG.intermediate_size
    n = 256 * TCFG.moe.top_k
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 256, H)).astype(np.float32))
    with _Bytes() as b:
        tg._moe_ffn(x, tlp, TCFG)
    per_item = n * H * i * 4
    assert b.total < per_item, (b.total, per_item)
    assert b.largest <= n * max(H, i) * 4, b.largest


def _jax_engine(params, cfg, **kw):
    eng = JaxEngine(params, cfg, **kw)
    ts._share_programs(eng)
    return eng


def _repetitive(lens, seed, motif=4):
    rs = np.random.RandomState(seed)
    out = []
    for n in lens:
        m = rs.randint(3, JCFG.vocab_size, (motif,)).astype(np.int32)
        out.append(np.concatenate([m[:1], np.tile(m, -(-n // motif))])[:n])
    return out


ENGINE_CASES = {
    "plain": dict(),
    "plain-int8": dict(kv_cache_dtype="int8"),
    "ngram": dict(spec_k=3),
    "ngram-int8": dict(spec_k=3, kv_cache_dtype="int8"),
    "draft-tree": dict(draft_layers=1, spec_tree=(2, 2)),
    "int8-weights": dict(weight_bits=8),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_greedy_tokens_match_jax_engine(case):
    jp, tp = _params()
    kw = ENGINE_CASES[case]
    ps = (_repetitive([13, 9, 11], 2) if "spec_k" in kw
          else _prompts([5, 11, 3, 9], 3))
    want = _once(("engine", case), lambda: [
        np.asarray(o) for o in _jax_engine(jp, JCFG, **ENG, **kw).generate(
            ps, max_new_tokens=8)])
    eng = ContinuousBatchingEngine(tp, TCFG, device="cpu", **ENG, **kw)
    got = eng.generate(ps, max_new_tokens=8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    st = eng.stats()
    if "spec_k" in kw or "spec_tree" in kw:
        assert st["spec_verify_steps"] > 0
    if "draft_layers" in kw:
        assert st["forwards"]["draft_decode"] > 0
        assert eng.draft_cache.allocator.num_used == 0
    eng.cache.prefix.drop_all(eng.cache.allocator)
    assert eng.cache.allocator.num_used == 0


def test_engine_mesh_with_moe_raises_naming_its_step():
    _, tp = _params()
    with pytest.raises(NotImplementedError,
                       match="expert-parallel MoE.*ROADMAP.*step 7"):
        ContinuousBatchingEngine(tp, TCFG, mesh=object(), device="cpu")


def test_adapter_pool_on_the_expert_model():
    """The q/o LoRA pool on an MoE model: a base row is the engine
    without a pool, an adapter row the plain engine on the merged
    weights (the pool never touches the expert leaves)."""
    from paddle_tpu_torch.serving import merge_lora
    _, tp = _params()
    reg = AdapterRegistry(TCFG)
    reg.register(1, init_lora(TCFG, 4, seed=41))
    ps = _prompts([6, 9], 5)
    eng = ContinuousBatchingEngine(tp, TCFG, device="cpu",
                                   adapters=dict(slots=2, rank=4,
                                                 registry=reg), **ENG)
    base, lora = (eng.submit(ps[0], max_new_tokens=6),
                  eng.submit(ps[1], max_new_tokens=6, adapter_id=1))
    eng.run()
    plain = ContinuousBatchingEngine(tp, TCFG, device="cpu", **ENG)
    merged = ContinuousBatchingEngine(merge_lora(tp, TCFG, reg.get(1)),
                                      TCFG, device="cpu", **ENG)
    assert list(base.tokens) == list(plain.generate(
        [ps[0]], max_new_tokens=6)[0][len(ps[0]):])
    assert list(lora.tokens) == list(merged.generate(
        [ps[1]], max_new_tokens=6)[0][len(ps[1]):])


def test_quantize_weights_leaves_the_experts_alone():
    """``test_tp2d_serving.py::TestMoeEpDecode::
    test_moe_weights_stay_unquantized`` on the port, bit for bit
    against the JAX package's quantized tree."""
    jp, tp = _params()
    qp = tg.quantize_weights(tp, TCFG, bits=8)
    layers = qp["layers"]
    assert not any(n.startswith("moe_") and n.endswith("_scale")
                   for n in layers)
    for n in ("moe_gate", "moe_wg", "moe_wu", "moe_wd"):
        assert layers[n] is tp["layers"][n]
    assert layers["wq"].dtype == torch.int8
    jq = jax.tree.map(np.asarray, jg.quantize_weights(jp, JCFG, bits=8))
    want = dict(_leaves(jq))
    got = dict(_leaves(qp))
    assert got.keys() == want.keys()
    for n, a in got.items():
        np.testing.assert_array_equal(a.numpy(), want[n], err_msg=n)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_dense_generate_matches_jax(kv):
    jp, tp = _params()
    prompt = np.stack(_prompts([7, 7], 12))
    want = np.asarray(jg.generate(jp, jnp.asarray(prompt), JCFG,
                                  max_new_tokens=8, kv_cache_dtype=kv))
    got = tg.generate(tp, prompt, TCFG, max_new_tokens=8,
                      kv_cache_dtype=kv).numpy()
    np.testing.assert_array_equal(got, want)


def test_beam_search_matches_jax():
    jp, tp = _params()
    prompt = np.stack(_prompts([6, 6], 13))
    kw = dict(num_beams=3, max_new_tokens=6)
    want = np.asarray(jg.beam_search(jp, jnp.asarray(prompt), JCFG, **kw))
    got = tg.beam_search(tp, prompt, TCFG, **kw).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------- paged_prefill_insert
def _dense_params():
    def make():
        cfg = jl.LlamaConfig.tiny(num_layers=2, max_seq_len=64)
        jp = jl.init_params(jax.random.key(0), cfg)
        return (cfg, jp, tl.LlamaConfig.tiny(num_layers=2, max_seq_len=64),
                params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    return _once("dense", make)


@pytest.mark.parametrize("model", ["dense", "moe"])
@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("padded", [False, True], ids=["exact", "left-pad"])
def test_paged_prefill_insert_matches_jax(model, kv, padded):
    if model == "moe":
        jcfg, tcfg = JCFG, TCFG
        jp, tp = _params()
    else:
        jcfg, jp, tcfg, tp = _dense_params()
    page, pages = 8, 10
    S = 16 if padded else 13
    n = 11 if padded else S                  # the real prompt length
    prompt = np.zeros((1, S), np.int32)
    prompt[0, S - n:] = _prompts([n], 21)[0]
    table = np.array([7, 2, 9, 4], np.int32)   # 32-token extent
    kwj = dict(prompt_len=jnp.int32(n)) if padded else {}
    kwt = dict(prompt_len=n) if padded else {}
    jpaged = jg.init_paged_cache(jcfg, pages, page, kv_dtype=kv)
    jlog, jpaged = jg.paged_prefill_insert(jp, jnp.asarray(prompt), jpaged,
                                           jnp.asarray(table), jcfg, **kwj)
    tpaged = tg.init_paged_cache(tcfg, pages, page, kv_dtype=kv,
                                 device="cpu")
    tlog, out = tg.paged_prefill_insert(tp, torch.from_numpy(prompt),
                                        tpaged, torch.from_numpy(table),
                                        tcfg, **kwt)
    assert out is tpaged                       # written in place
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5)
    used = table[:-(-S // page)]
    for name, pool in tpaged.items():
        got = pool.numpy()[:, used]
        want = np.asarray(jpaged[name])[:, used]
        if pool.dtype == torch.int8:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        untouched = np.setdiff1d(np.arange(pages), used)
        assert not pool.numpy()[:, untouched].any(), name
    # the left-padded insert is the unpadded one: same logits
    if padded:
        ref, _ = tg.paged_prefill_insert(
            tp, torch.from_numpy(prompt[:, S - n:]),
            tg.init_paged_cache(tcfg, pages, page, kv_dtype=kv,
                                device="cpu"),
            torch.from_numpy(table), tcfg)
        np.testing.assert_allclose(tlog.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)
