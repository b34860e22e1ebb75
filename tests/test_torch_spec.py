"""The port's speculative decoding against the JAX package's, on the CPU.

Same numpy-seeded inputs through both packages, ``LlamaConfig.tiny(
num_layers=2)`` in float32:

1. every function of ``serving/speculative.py`` (n-gram proposer,
   speculator EMA and probe, greedy and sampled linear acceptance, token
   trees, ancestor matrices, tree acceptance) gives the JAX module's
   outputs exactly; the samplers under the same ``np.random.default_rng``
   seed draw the same tokens;
2. the chunk attention in tree mode: the plain version against the JAX
   reference and against the Pallas tree kernel in interpret mode
   (1e-5; int8 rows rtol 1e-4, their dequantized values reach ~100), a
   chain tree bit-equal to the linear path, T = 33 refused;
3. ``paged_verify_forward`` linear and tree for KV {fp, int8} x fused
   {off, on}: logits within 1e-5, and the pools (linear) or un-placed
   rows (tree) as the JAX function leaves them (fp to 1e-5; int8 rows
   within one quantization step, scales to 1e-6); ``paged_tree_commit``
   places the same rows; ``make_draft_params`` shares the target's
   storage;
4. the engine: n-gram, draft-linear and draft-tree speculation give the
   JAX engine's greedy tokens and spec counters, and the port's plain
   engine's tokens, on post-draft layers damped by 1e-3 (``_aligned``,
   the JAX package's own recipe) so that acceptance is real (> 0.3 for
   the draft model); both pools drain balanced. Sampled speculation
   runs to ``max_new_tokens``; the constructor's errors are JAX's.

One JAX engine run per configuration, shared through a module fixture,
with host arrays copied before they reach JAX (``_CopyingJnp``: the JAX
engine's draft-linear counters otherwise vary run to run).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference import predictor as jpred
from paddle_tpu.models import generate as jgen
from paddle_tpu.models import llama as jl
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import serving_fused as jsf
from paddle_tpu.serving import speculative as jspec
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import generate as tgen
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import params_from_jax
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import serving_fused as tsf
from paddle_tpu_torch.serving import speculative as tspec

import test_torch_scheduler as ts

torch.set_num_threads(1)
ENG = dict(max_batch=3, page_size=8, max_len=32)
TOL = dict(rtol=1e-5, atol=1e-5)
_JAX = {}


def _jax_once(key, fn):
    """A JAX result that cases share (``fused`` is the port's flag alone),
    computed once a module."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]
SPEC_KEYS = ("spec_drafted_total", "spec_accepted_total",
             "spec_verify_steps")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- helpers
def _softmax_rows(rs, n, v, sharp=3.0):
    z = rs.randn(n, v) * sharp
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def _case_rejection(m, kind):
    rs = np.random.RandomState(3)
    V, j = 12, 3
    logits = (rs.randn(j + 1, V) * 2).astype(np.float32)
    drafts = rs.randint(0, V, (j,))
    q = _softmax_rows(rs, j, V) if kind == "real_q" else None
    temp = 0.0 if kind == "greedy" else 0.8
    out = []
    for seed in range(40):
        out.append(m.rejection_sample_tokens(
            logits, drafts, temp, np.random.default_rng(seed), q=q))
    return out


def _case_prefix(m, _):
    return [m.longest_accepted_prefix(np.asarray(d), np.asarray(t))
            for d, t in (([], [4]), ([4, 5, 6], [4, 5, 6, 7]),
                         ([4, 5, 6], [4, 9, 6, 7]), ([1], [2, 3]))]


def _case_ngram(m, _):
    rs = np.random.RandomState(5)
    hist = np.concatenate([rs.randint(0, 6, 40), [1, 2, 3, 1, 2]])
    out = []
    for lo, hi in ((1, 1), (1, 3), (2, 4)):
        p = m.NgramProposer(ngram_max=hi, ngram_min=lo)
        out += [p.propose(hist[:n], k).tolist()
                for n in (1, 2, 9, 30, hist.size) for k in (0, 1, 4)]
    return out


def _case_speculator(m, _):
    rs = np.random.RandomState(6)
    sp = m.Speculator(4, ngram_max=3, probe_every=3)
    hist = np.tile(np.asarray([7, 8, 9, 10], np.int32), 6)
    out = []
    for step in range(30):
        slot, rid = step % 2, step // 10
        d = sp.propose(slot, rid, hist[:10 + step % 13],
                       cap=int(rs.randint(1, 5)))
        out.append((d.tolist(), sp.k_for(slot, rid)))
        if d.size:
            sp.observe(slot, rid, d.size, int(rs.randint(0, d.size + 1))
                       if step % 4 else 0)
    return out, sp.stats(), sp.acceptance_rate


def _case_trees(m, _):
    t = m.build_comb_tree(5, [10, 11, 12], [[20, 30], [21], [22]])
    parts = [t.tokens.tolist(), t.parents.tolist(), t.size, len(t),
             t.depths().tolist(), repr(t)]
    for k in (0, 2, 4, 99):
        s = t[:k]
        parts.append((s.tokens.tolist(), s.parents.tolist()))
    par = [-1, 0, 0, 1, 2, 3, 1]
    parts += [m.tree_depths(np.asarray(par)).tolist(),
              m.tree_ancestor_matrix(np.asarray(par)).tolist()]
    return parts


def _case_tree_accept(m, kind):
    rs = np.random.RandomState(8)
    t = m.build_comb_tree(5, [3, 4, 6], [[7], [8], [2]])
    V = 10
    logits = (rs.randn(t.tokens.size, V) * 2).astype(np.float32)
    logits[0, 3] += 6.0            # the chain is likely to accept
    logits[1, 4] += 6.0
    if kind == "greedy":
        return [m.longest_accepted_path(t.tokens, t.parents,
                                        np.argmax(lg, axis=-1))
                for lg in (logits, -logits)]
    return [m.tree_rejection_sample(t.tokens, t.parents, logits, temp,
                                    np.random.default_rng(seed))
            for temp in (0.0, 0.7) for seed in range(30)]


HELPERS = {
    "rejection_greedy": (_case_rejection, "greedy"),
    "rejection_point_mass": (_case_rejection, "point_mass"),
    "rejection_real_q": (_case_rejection, "real_q"),
    "longest_accepted_prefix": (_case_prefix, None),
    "ngram_proposer": (_case_ngram, None),
    "speculator": (_case_speculator, None),
    "trees": (_case_trees, None),
    "tree_greedy_path": (_case_tree_accept, "greedy"),
    "tree_rejection_sample": (_case_tree_accept, "sampled"),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_speculative_helpers_match_jax(name):
    fn, kind = HELPERS[name]
    assert fn(tspec, kind) == fn(jspec, kind)


def test_tree_draft_refuses_what_jax_refuses():
    for m in (jspec, tspec):
        with pytest.raises(ValueError, match="topological"):
            m.TreeDraft([5, 6, 7], [-1, 0, 2])
        with pytest.raises(ValueError, match="non-empty"):
            m.TreeDraft([], [])
        with pytest.raises(TypeError, match="leading"):
            m.build_comb_tree(5, [10, 11])[1:3]
        with pytest.raises(ValueError, match="max_k"):
            m.Speculator(0)


# ------------------------------------------------- chunk attention, tree
def _tree_case(quant, seed=0):
    """B = 2 rows, a 5-node comb tree (chain 2, one sibling a depth)
    in the last T = 5 columns of a W = 32 temp cache, ragged kstart."""
    rs = np.random.RandomState(seed)
    B, T, H, HK, D, W = 2, 5, 4, 2, 8, 32
    x = dict(q=rs.randn(B, T, H, D).astype(np.float32), W=W,
             kstart=np.asarray([3, 17], np.int32))
    if quant:
        x["ck"] = rs.randint(-90, 90, (B, W, HK, D)).astype(np.int8)
        x["cv"] = rs.randint(-90, 90, (B, W, HK, D)).astype(np.int8)
        x["rows"] = dict(k_rows=(rs.rand(B, W, HK) + 0.5).astype(
            np.float32), v_rows=(rs.rand(B, W, HK) + 0.5).astype(
            np.float32))
    else:
        x["ck"] = rs.randn(B, W, HK, D).astype(np.float32)
        x["cv"] = rs.randn(B, W, HK, D).astype(np.float32)
        x["rows"] = {}
    t = tspec.build_comb_tree(5, [1, 2], [[3], [4]])
    x["tm"] = np.ascontiguousarray(np.broadcast_to(
        tspec.tree_ancestor_matrix(t.parents), (B, T, T)))
    return x


def _interpret(fn, *a, **k):
    jfa.set_interpret(True)
    try:
        return np.asarray(fn(*a, **k))
    finally:
        jfa.set_interpret(False)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8rows"])
def test_tree_chunk_attention_matches_jax(quant):
    x = _tree_case(quant)
    jargs = (jnp.asarray(x["q"]), jnp.asarray(x["ck"]),
             jnp.asarray(x["cv"]), x["W"], jnp.asarray(x["kstart"]))
    jkw = {k: jnp.asarray(v) for k, v in x["rows"].items()}
    tm = x["tm"]
    ref = np.asarray(jsf.flash_chunk_attention_reference(
        *jargs, tree_mask=jnp.asarray(tm), **jkw))
    ker = _interpret(jsf.flash_chunk_attention_kernel, *jargs, block_k=8,
                     tree_mask=tm, **jkw)
    targs = (_t(x["q"]), _t(x["ck"]), _t(x["cv"]), x["W"],
             _t(x["kstart"]))
    tkw = {k: _t(v) for k, v in x["rows"].items()}
    kernels.reset_launch_counts()
    plain = tsf.flash_chunk_attention_plain(*targs, tree_mask=_t(tm),
                                            **tkw).numpy()
    wrapped = tsf.flash_chunk_attention(*targs, tree_mask=_t(tm),
                                        **tkw).numpy()
    tol = dict(atol=1e-5, rtol=1e-4 if quant else 1e-5)
    np.testing.assert_allclose(plain, ref, **tol)
    np.testing.assert_allclose(plain, ker, **tol)
    np.testing.assert_array_equal(wrapped, plain)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)
    # the tree mask changes what the tree's nodes see: the linear path
    # gives another answer for the sibling nodes
    linear = tsf.flash_chunk_attention_plain(*targs, **tkw).numpy()
    assert not np.allclose(linear[:, 3:], plain[:, 3:])


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8rows"])
def test_chain_tree_equals_linear_bit_for_bit(quant):
    x = _tree_case(quant, seed=1)
    B, T = x["q"].shape[:2]
    chain = np.broadcast_to(np.tril(np.ones((T, T), bool)), (B, T, T))
    args = (_t(x["q"]), _t(x["ck"]), _t(x["cv"]), x["W"], _t(x["kstart"]))
    kw = {k: _t(v) for k, v in x["rows"].items()}
    np.testing.assert_array_equal(
        tsf.flash_chunk_attention(*args, tree_mask=_t(chain), **kw).numpy(),
        tsf.flash_chunk_attention(*args, **kw).numpy())


def test_tree_chunk_attention_refuses_33_nodes():
    rs = np.random.RandomState(0)
    B, T, D, W = 1, 33, 8, 64
    q = _t(rs.randn(B, T, 2, D).astype(np.float32))
    ck = _t(rs.randn(B, W, 2, D).astype(np.float32))
    tm = _t(np.broadcast_to(np.tril(np.ones((T, T), bool)), (B, T, T)))
    with pytest.raises(ValueError, match="32"):
        tsf.flash_chunk_attention(q, ck, ck, W, torch.zeros(B), tree_mask=tm)
    with pytest.raises(ValueError, match="tree_mask must be"):
        tsf.flash_chunk_attention(q[:, :4], ck, ck, W, torch.zeros(B),
                                  tree_mask=tm[:, :3, :3])
    # the packing puts node 31 in the sign bit, as the Pallas wrapper does
    bits = tsf.tree_bits(tm[:, :32, :32])
    assert bits.dtype == torch.int32 and int(bits[0, 31]) == -1
    assert int(bits[0, 2]) == 0b111


# --------------------------------------------------------- verify forwards
@pytest.fixture(scope="module")
def model():
    jcfg = jl.LlamaConfig.tiny(num_layers=2, max_seq_len=64)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tl.LlamaConfig.tiny(num_layers=2, max_seq_len=64), tp


def _pool_case(jcfg, tcfg, kv, seed):
    """A 12-page pool of random committed rows (int8 rows quantized as
    the model writes them), B = 3 rows of lengths (5, 13, 0) over
    4-page tables, the last row inactive."""
    rs = np.random.RandomState(seed)
    P, page = 12, 8
    shape = (jcfg.num_layers, P, page, jcfg.num_kv_heads, jcfg.hd)
    jpool = jgen.init_paged_cache(jcfg, P, page, kv_dtype=kv)
    pool = {}
    for n in ("k", "v"):
        rows = rs.randn(*shape).astype(np.float32)
        if kv:
            sc = np.maximum(np.abs(rows).max(-1) / 127.0, 1e-8)
            pool[n] = np.clip(np.round(rows / sc[..., None]), -127,
                              127).astype(np.int8)
            pool[n + "s"] = sc.astype(np.float32)
        else:
            pool[n] = rows
    jpool = {n: jnp.asarray(pool[n]) for n in jpool}
    tpool = {n: _t(pool[n]) for n in jpool}
    tables = np.asarray([[3, 5, 1, 7], [2, 4, 6, 8], [0, 0, 0, 0]],
                        np.int32)
    lengths = np.asarray([5, 13, 0], np.int32)
    active = np.asarray([True, True, False])
    return jpool, tpool, tables, lengths, active


def _check_kv(j, t):
    """fp rows to 1e-5 (the projections sum in another order); int8
    rows within one quantization step of each other's dequantized value
    (XLA and PyTorch round a value within an ulp of a step boundary to
    neighbouring steps), scales to 1e-6."""
    if "ks" not in j:
        for n in ("k", "v"):
            np.testing.assert_allclose(t[n].numpy(), np.asarray(j[n]),
                                       **TOL)
        return
    for n, s in (("k", "ks"), ("v", "vs")):
        js, ts = np.asarray(j[s]), t[s].numpy()
        np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-9)
        jq = np.asarray(j[n]).astype(np.float32) * js[..., None]
        tq = t[n].numpy().astype(np.float32) * ts[..., None]
        assert np.all(np.abs(jq - tq) <= np.maximum(js, ts)[..., None]
                      * (1 + 1e-5))


def _tree_inputs(B, T):
    t = tspec.build_comb_tree(9, [11, 12], [[13], [14]])
    depths = np.zeros((B, T), np.int32)
    anc = np.zeros((B, T, T), bool)
    tokens = np.zeros((B, T), np.int32)
    rs = np.random.RandomState(2)
    for b in range(B):
        tokens[b] = rs.randint(3, 200, T)
        depths[b] = tspec.tree_depths(t.parents)
        anc[b] = tspec.tree_ancestor_matrix(t.parents)
    return tokens, depths, anc


@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_paged_verify_forward_matches_jax(model, kv, fused):
    """Linear: T = 4 drafts for every row, then the tree verify of a
    5-node comb and its commit of one root path per row. The JAX side
    does not see ``fused`` and runs once a KV dtype."""
    jcfg, jp, tcfg, tp = model
    jpool, tpool, tables, lengths, active = _pool_case(jcfg, tcfg, kv, 4)
    ctx_cap = 16
    rs = np.random.RandomState(9)
    chunk = rs.randint(3, jcfg.vocab_size, (3, 4)).astype(np.int32)
    jlog, jpool2 = _jax_once(("linear", kv), lambda: jgen.paged_verify_forward(
        jp, jnp.asarray(chunk), dict(jpool), jnp.asarray(tables),
        jnp.asarray(lengths), jcfg, ctx_cap=ctx_cap,
        active=jnp.asarray(active)))
    kernels.reset_launch_counts()
    tlog, tpool2 = tgen.paged_verify_forward(
        tp, _t(chunk), {n: v.clone() for n, v in tpool.items()},
        _t(tables), _t(lengths), tcfg, ctx_cap=ctx_cap,
        active=_t(active), fused=fused)
    assert tlog.shape == (3, 4, jcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy()[:2], np.asarray(jlog)[:2], **TOL)
    _check_kv(jpool2, tpool2)
    # tree mode: no placement, the per-node rows come back
    T = 5
    tokens, depths, anc = _tree_inputs(3, T)
    jlog, jrows = _jax_once(("tree", kv), lambda: jgen.paged_verify_forward(
        jp, jnp.asarray(tokens), dict(jpool), jnp.asarray(tables),
        jnp.asarray(lengths), jcfg, ctx_cap=ctx_cap,
        active=jnp.asarray(active), tree_depth=jnp.asarray(depths),
        tree_mask=jnp.asarray(anc)))
    before = {n: v.clone() for n, v in tpool.items()}
    tlog, trows = tgen.paged_verify_forward(
        tp, _t(tokens), tpool, _t(tables), _t(lengths), tcfg,
        ctx_cap=ctx_cap, active=_t(active), fused=fused,
        tree_depth=_t(depths), tree_mask=_t(anc))
    np.testing.assert_allclose(tlog.numpy()[:2], np.asarray(jlog)[:2], **TOL)
    for n in tpool:
        assert torch.equal(tpool[n], before[n]), n
    _check_kv({n: np.asarray(v)[:, :2] for n, v in jrows.items()},
              {n: v[:, :2] for n, v in trows.items()})
    # the commit of one root path per row: node 0 -> 3 (sibling) for
    # row 0, the chain 0 -> 1 -> 2 for row 1, nothing for row 2
    path = np.asarray([[0, 3, 0, 0, 0], [0, 1, 2, 0, 0], [0] * 5], np.int32)
    plen = np.asarray([2, 3, 0], np.int32)
    jpool3 = _jax_once(("commit", kv), lambda: jgen.paged_tree_commit(
        dict(jpool), jrows, jnp.asarray(tables), jnp.asarray(lengths),
        jnp.asarray(path), jnp.asarray(plen)))
    tpool3 = tgen.paged_tree_commit(
        tpool, trows, _t(tables), _t(lengths), _t(path), _t(plen))
    _check_kv(jpool3, tpool3)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


def test_tree_commit_equals_linear_verify_of_the_path(model):
    """A chain tree's verify + commit of its whole path writes what the
    linear verify of the same tokens writes, bit for bit."""
    jcfg, _, tcfg, tp = model
    _, tpool, tables, lengths, active = _pool_case(jcfg, tcfg, None, 6)
    T = 4
    chunk = np.random.RandomState(3).randint(3, 200, (3, T)).astype(
        np.int32)
    chain = np.broadcast_to(np.tril(np.ones((T, T), bool)), (3, T, T))
    depth = np.broadcast_to(np.arange(T, dtype=np.int32), (3, T))
    lin_logits, lin = tgen.paged_verify_forward(
        tp, _t(chunk), {n: v.clone() for n, v in tpool.items()},
        _t(tables), _t(lengths), tcfg, ctx_cap=16, active=_t(active))
    tree_logits, rows = tgen.paged_verify_forward(
        tp, _t(chunk), tpool, _t(tables), _t(lengths), tcfg, ctx_cap=16,
        active=_t(active), tree_depth=_t(depth), tree_mask=_t(chain))
    assert torch.equal(lin_logits, tree_logits)
    path = np.broadcast_to(np.arange(T, dtype=np.int32), (3, T))
    tgen.paged_tree_commit(tpool, rows, _t(tables), _t(lengths), _t(path),
                           _t(np.asarray([T, T, 0], np.int32)))
    for n in tpool:
        # row 2 is inactive: the linear verify wrote its rows to the
        # trash page 0, the commit placed nothing
        assert torch.equal(tpool[n][:, 1:], lin[n][:, 1:]), n


def test_make_draft_params_shares_the_targets_storage(model):
    _, _, tcfg, tp = model
    draft, dcfg = tgen.make_draft_params(tp, tcfg, 1)
    assert dcfg.num_layers == 1 and dcfg.hidden_size == tcfg.hidden_size
    for n, w in tp["layers"].items():
        assert draft["layers"][n].shape[0] == 1
        assert draft["layers"][n].data_ptr() == w.data_ptr(), n
    for n in ("embed", "final_norm", "lm_head"):
        assert draft[n] is tp[n]
    with pytest.raises(ValueError, match="strict truncation"):
        tgen.make_draft_params(tp, tcfg, 2)


# ------------------------------------------------------------- the engine
def _aligned(params, draft_layers=1, damp=1e-3):
    """Damp the post-draft layers' residual writes (wo, wd) so that the
    truncated draft tracks the target (the JAX package's recipe)."""
    layers = dict(params["layers"])
    for n in ("wo", "wd"):
        layers[n] = layers[n].at[draft_layers:].multiply(damp)
    return dict(params, layers=layers)


def _prompts(vocab, lens, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(3, vocab, (n,)).astype(np.int32) for n in lens]


def _repetitive(vocab, lens, seed, motif=4):
    """Tiled-motif prompts: in-context repetition for the n-gram
    proposer."""
    rs = np.random.RandomState(seed)
    out = []
    for n in lens:
        m = rs.randint(3, vocab, (motif,)).astype(np.int32)
        head = rs.randint(3, vocab, (1,)).astype(np.int32)
        out.append(np.concatenate([head, np.tile(m, -(-n // motif))])[:n])
    return out


SPEC_CASES = {
    "ngram-fp": dict(spec_k=3),
    "draft-int8": dict(spec_k=3, draft_layers=1, kv_cache_dtype="int8"),
    "tree-fp": dict(draft_layers=1, spec_tree=(2, 3)),
    "tree-int8-fused": dict(draft_layers=1, spec_tree=(2, 3),
                            kv_cache_dtype="int8", fused=True),
}


class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy array first. On the
    CPU backend ``jnp.asarray`` of a host array may alias it, and the
    JAX engine mutates ``draft_cache.lengths`` right after dispatching
    a draft catch-up forward that reads it, so its draft-linear spec
    counters vary from run to run (tokens do not). Handed copies, it is
    deterministic; the package itself is left as it is."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kw):
        if isinstance(a, np.ndarray):
            a = a.copy()
        return jnp.asarray(a, *args, **kw)


@pytest.fixture(scope="module")
def engines():
    jcfg = jl.LlamaConfig.tiny(num_layers=2, max_seq_len=64)
    jp = _aligned(jl.init_params(jax.random.key(0), jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tcfg = tl.LlamaConfig.tiny(num_layers=2, max_seq_len=64)
    v = jcfg.vocab_size
    prompts = {"ngram-fp": _repetitive(v, [13, 9], 2) + _prompts(v, [7], 3)}
    ref = {}

    def jax_run(case):
        if case not in ref:
            kw = SPEC_CASES[case]
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jpred, "jnp", _CopyingJnp())
                eng = JaxEngine(jp, jcfg, **ENG, **kw)
                ts._share_programs(eng)
                out = eng.generate(prompts.get(case, _prompts(v, [5, 9, 7],
                                                              7)),
                                   max_new_tokens=10)
            ref[case] = (out, {k: eng.stats()[k] for k in SPEC_KEYS})
        return ref[case]

    return tcfg, tp, prompts, jax_run


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_engine_matches_jax_engine_and_plain_decode(engines, case):
    tcfg, tp, prompts, jax_run = engines
    kw = SPEC_CASES[case]
    ps = prompts.get(case, _prompts(tcfg.vocab_size, [5, 9, 7], 7))
    want, want_stats = jax_run(case)
    eng = ContinuousBatchingEngine(tp, tcfg, device="cpu", **ENG, **kw)
    kernels.reset_launch_counts()
    got = eng.generate(ps, max_new_tokens=10)
    plain = ContinuousBatchingEngine(
        tp, tcfg, device="cpu", kv_cache_dtype=kw.get("kv_cache_dtype"),
        **ENG).generate(ps, max_new_tokens=10)
    for a, b, c in zip(got, want, plain):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    st = eng.stats()
    assert {k: st[k] for k in SPEC_KEYS} == want_stats
    assert st["spec_verify_steps"] > 0 and st["spec_accepted_total"] > 0
    fw = st["forwards"]
    assert fw["verify" if "spec_tree" not in kw else "tree"] > 0
    if "draft_layers" in kw:
        assert eng.spec.acceptance_rate > 0.3
        assert fw["draft_decode"] > 0 and fw["draft_catchup"] > 0
        assert eng.draft_cache.allocator.num_used == 0
        assert not eng.draft_cache.active.any()
    eng.cache.prefix.drop_all(eng.cache.allocator)
    assert eng.cache.allocator.num_used == 0
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


@pytest.mark.parametrize("kw", [dict(spec_k=3),
                                dict(spec_k=2, draft_layers=1),
                                dict(draft_layers=1, spec_tree=(2, 3))],
                         ids=["ngram", "draft", "tree"])
def test_sampled_spec_runs_to_max_new_tokens(engines, kw):
    tcfg, tp, _, _ = engines
    eng = ContinuousBatchingEngine(
        tp, tcfg, device="cpu", temperature=0.8,
        generator=torch.Generator().manual_seed(11), **ENG, **kw)
    ps = _repetitive(tcfg.vocab_size, [5, 9, 7], 7)
    hs = [eng.submit(p, max_new_tokens=10) for p in ps]
    eng.run()
    for h in hs:
        assert h.done and len(h.tokens) == 10
        assert all(0 <= t < tcfg.vocab_size for t in h.tokens)
    assert eng.spec.verify_steps > 0
    eng.cache.prefix.drop_all(eng.cache.allocator)
    assert eng.cache.allocator.num_used == 0
    if eng.draft_cache is not None:
        assert eng.draft_cache.allocator.num_used == 0


@pytest.mark.parametrize("kw", [dict(spec_tree=(2, 2)),
                                dict(draft_layers=1, spec_tree=(8, 4)),
                                dict(draft_layers=1, spec_k=5,
                                     spec_tree=(2, 2)),
                                dict(draft_layers=1),
                                dict(spec_k=2, constraints=True)],
                         ids=["tree-needs-draft", "node-cap",
                              "depth-conflict", "draft-needs-k",
                              "spec-with-constraints"])
def test_constructor_errors_match_jax(model, kw):
    jcfg, jp, tcfg, tp = model
    with pytest.raises(ValueError) as want:
        JaxEngine(jp, jcfg, **ENG, **kw)
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(tp, tcfg, device="cpu", **ENG, **kw)
    assert str(got.value) == str(want.value)


def test_options_the_port_leaves_out_raise(model):
    _, _, tcfg, tp = model
    for kw in (dict(mesh=object()), dict(adapters=dict(mesh=object()))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ContinuousBatchingEngine(tp, tcfg, device="cpu", **ENG, **kw)
    eng = ContinuousBatchingEngine(tp, tcfg, device="cpu", spec_k=2, **ENG)
    # ported with the SLO scheduler: no seated request, no width
    assert eng.spec_plan_widths(np.ones(3, bool)) == {}
    st = eng.stats()
    assert st["spec_verify_steps"] == 0 and "draft_layers" not in st
