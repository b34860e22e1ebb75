"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False (as on a CPU-only test machine) and runs on an H100 with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` keeps the JAX-side test harness out of the process).
Shapes are small but cover every template instantiation the wrappers
dispatch to: head dim 64 and 128, float32 and bfloat16 queries, native
and int8 KV, GQA rep 1 and 2; the flash kernels B1-B3 also causal and
full, at ragged lengths (Sq = Sk = 200; Sq = 72 against Sk = 136) and,
at GQA rep 2, Sq = 320 against Sk = 192 (uneven across B1's and B3's
128-row query tiles) and lengths that are not multiples of 8 (77; 45
against 83: the TMA zero fill past S), and B2's edges (Sq = 45 against
Sk = 300: 64-key tiles that no query sees; query tails inside its
64-row tiles), each beside a planted fault (the plain backward without
the last 16 keys some query sees); the fused RMSNorm and SwiGLU kernels B4a-B5b at widths that give one
and two chunks a thread, ragged row counts included; B11-tree at verify
shapes (B = 8, T = 5, 9, 32 nodes of random trees, ragged kstart); B11
on both sides of its regime boundary (M = T * rep packed rows 60 to 68),
at the engine's prefill chunk and at key-split boundaries, a chain tree
bit-equal to the linear form in both regimes; B7
(decode attention against a contiguous cache) at GQA rep 1, 2, 4 and 8
on strided layer views of a padded cache whose tail past each row's
length is NaN, in bf16 at capacities that give its split kernel 1, 2, 4
and 8 splits and with each split count forced, beside a planted fault
(the last live keys of one row dropped from the plain version) that the
row check must reject;
dense ``generate`` and ``beam_search`` with their B7 launch counts; B6
(fused RoPE) on strided q/k views of a fused qkv tensor at ragged
shapes, head dims 6, 64 and 128 (every vector width), forward and VJP,
beside a planted fault (the sign of sin flipped); B8 (decode attention
over a head-major page pool) at GQA rep 1, 2 and 8 with NaN past each
row's length and in page 0, lengths that end mid-page, and in bf16 at
table capacities that give its split kernel 1, 2, 4 and 8 splits,
beside a planted fault (one row's last 16 live keys dropped); and
``block_multihead_attention``'s B8 branch
against its per-row branch on the same CUDA inputs; and the serving
control plane: an overlapped engine's decode, verify and prefill
dispatches under ``torch.cuda.set_sync_debug_mode("error")`` (a planted
pageable copy must raise there), uploads queued behind a busy stream
from a host array that changes between them, overlapped against
synchronous scheduling without a budget, and a preempted slot's pages
refilled by the next tenant while the victim's decode is still queued;
grammar-constrained decoding: a mixed batch of JSON, regex, menu and
free requests under the overlapped scheduler with every dispatch (the
mask upload included) under the sync debug mode, each constrained
request's tokens walking its DFA (``chip_smoke.walk``), the same tokens
as the synchronous run; supervised recovery: a fault at an engine site
recovers token-identically on the card, a watchdog's step thread
launches on the caller's stream, and with the observability hooks on
every dispatch still runs under the sync debug mode; the host KV tier:
a swap round trip through pinned host memory byte-equal for bf16 and
int8 pools, a non-blocking swap-out queued behind a busy stream without
a synchronization and fenced before its payload is read, and page moves
across two pools (the direct handoff) and within one (``defrag``)
byte-equal; the adapter pool: installs queued behind a busy stream
without a synchronization, landing each adapter's bf16 factors and
scale exactly, and on an engine base rows token-identical to the engine
without a pool and an overlapped run with adapter rows free of a
synchronization in every dispatch.
Tolerances: float32 1e-5 (same math, another summation order; 1e-4
for the flash gradients, sums of up to 320 products, against autograd
through the plain forward). bfloat16, ``chip_smoke.py``'s row check:
every row (one D-vector) within 2e-2 * |plain row| + 1e-4 * the rms of
the plain rows (the kernels round their outputs, and p and ds, to bf16,
2^-9 relative; the floor admits rows that cancel to zero); the flash
gradients against the plain B2 and B3 in float32 on B1's own lse and
delta, as the autograd op hands them over. B4a-B5b round one f32 result
once, as their plain versions do, so their bf16 rows are held within
2^-7 * |plain row| (at most one bf16 ulp an element) + 1e-4 * rms.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the synthetic table and the DFA walk)
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import generate as gen
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import train as tt
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import fused as fk
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.ops.kernels import serving_fused as sf

pytestmark = pytest.mark.cuda
NONE = dict.fromkeys(kernels.WRAPPERS, 0)   # no launches of any kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype, rtol=2e-2):
    g, w = got.float().cpu(), want.float().cpu()
    if dtype == torch.float32:
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    else:
        ref = w.norm(dim=-1)
        lim = rtol * ref + 1e-4 * ref.square().mean().sqrt()
        assert ((g - w).norm(dim=-1) <= lim).all()


CASES = [(d, dt, q8, rep) for d in (64, 128)
         for dt in (torch.float32, torch.bfloat16)
         for q8 in (False, True) for rep in (1, 2)]


def _ids(c):
    return f"D{c[0]}-{str(c[1])[6:]}-{'int8' if c[2] else 'fp'}-rep{c[3]}"


def _pools(g, dev, P, page, HK, D, dtype, q8):
    shape = (P, page, HK, D)
    if q8:
        k = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        ks = torch.rand(shape[:3], generator=g) * 0.05 + 0.01
        vs = torch.rand(shape[:3], generator=g) * 0.05 + 0.01
        return k.to(dev), v.to(dev), ks.to(dev), vs.to(dev)
    k = torch.randn(shape, generator=g).to(dtype)
    v = torch.randn(shape, generator=g).to(dtype)
    return k.to(dev), v.to(dev), None, None


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_paged_decode_kernels_match_plain(cuda, case):
    D, dtype, q8, rep = case
    g = torch.Generator().manual_seed(0)
    B, HK, page, pp, P = 5, 2, 16, 6, 40
    H = HK * rep
    k, v, ks, vs = _pools(g, cuda, P, page, HK, D, dtype, q8)
    lens = torch.tensor([1, 96, 37, 16, 70], dtype=torch.int32)
    bt = torch.randperm(P - 1, generator=g)[:B * pp].reshape(B, pp) + 1
    bt[0, 1:] = -1                          # -1 entries past the live pages
    bt = bt.to(torch.int32).to(cuda)
    lens = lens.to(cuda)
    q = torch.randn((B, H, D), generator=g).to(dtype).to(cuda)
    pos = (lens - 1).long()
    cos, sin = tl.rope_tables(128, D, 10000.0, device=cuda)
    kernels.reset_launch_counts()
    out = pa.paged_attention(q, k, v, bt, lens, ks_pages=ks, vs_pages=vs)
    _close(out, pa.paged_attention_plain(q, k, v, bt, lens, ks_pages=ks,
                                         vs_pages=vs), dtype)
    out = sf.fused_paged_decode_attention(q, cos[pos], sin[pos], k, v, bt,
                                          lens, ks_pages=ks, vs_pages=vs)
    _close(out, sf.fused_paged_decode_plain(
        q, cos[pos], sin[pos], k, v, bt, lens, ks_pages=ks, vs_pages=vs),
        dtype)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {**NONE, "B9": 1, "B10": 1}


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_flash_chunk_kernel_matches_plain(cuda, case):
    D, dtype, q8, rep = case
    g = torch.Generator().manual_seed(1)
    B, T, HK, W = 2, 72, 2, 160
    H = HK * rep
    q = torch.randn((B, T, H, D), generator=g).to(dtype).to(cuda)
    k, v, kr, vr = _pools(g, cuda, B, W, HK, D, dtype, q8)
    kstart = torch.tensor([5, 64], dtype=torch.int32, device=cuda)
    kernels.reset_launch_counts()
    out = sf.flash_chunk_attention(q, k, v, W, kstart, k_rows=kr, v_rows=vr)
    _close(out, sf.flash_chunk_attention_plain(q, k, v, W, kstart,
                                               k_rows=kr, v_rows=vr), dtype)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {**NONE, "B11": 1}


def _random_trees(g, B, T):
    """(B, T, T) ancestor-or-self matrices of random topological trees
    (node i hangs off a node before it), one per row."""
    from paddle_tpu_torch.serving import tree_ancestor_matrix
    anc = []
    for _ in range(B):
        par = [-1] + [int(torch.randint(0, i, (1,), generator=g))
                      for i in range(1, T)]
        anc.append(torch.from_numpy(tree_ancestor_matrix(np.asarray(par))))
    return torch.stack(anc)


TREE_CASES = [(d, dt, q8, t) for d in (64, 128)
              for dt in (torch.float32, torch.bfloat16)
              for q8 in (False, True) for t in (5, 9, 32)]


@pytest.mark.parametrize("case", TREE_CASES,
                         ids=[f"D{c[0]}-{str(c[1])[6:]}-"
                              f"{'int8' if c[2] else 'fp'}-T{c[3]}"
                              for c in TREE_CASES])
def test_flash_chunk_tree_kernel_matches_plain(cuda, case):
    """B11-tree at verify shapes: B = 8 rows with ragged kstart, T
    tree nodes of random topology at the end of a W = 256 + T temp
    cache, GQA rep 2; then a chain tree, which must give the linear
    kernel's bits."""
    D, dtype, q8, T = case
    g = torch.Generator().manual_seed(T)
    B, HK, W = 8, 2, 256 + T
    H = 2 * HK
    q = torch.randn((B, T, H, D), generator=g).to(dtype).to(cuda)
    k, v, kr, vr = _pools(g, cuda, B, W, HK, D, dtype, q8)
    kstart = torch.tensor([0, 7, 64, 100, 255, 3, 128, 200],
                          dtype=torch.int32, device=cuda)
    tm = _random_trees(g, B, T).to(cuda)
    kw = dict(k_rows=kr, v_rows=vr)
    kernels.reset_launch_counts()
    out = sf.flash_chunk_attention(q, k, v, W, kstart, tree_mask=tm, **kw)
    _close(out, sf.flash_chunk_attention_plain(q, k, v, W, kstart,
                                               tree_mask=tm, **kw), dtype)
    chain = torch.tril(torch.ones((T, T), dtype=torch.bool, device=cuda))
    tree = sf.flash_chunk_attention(q, k, v, W, kstart,
                                    tree_mask=chain.expand(B, T, T), **kw)
    linear = sf.flash_chunk_attention(q, k, v, W, kstart, **kw)
    torch.cuda.synchronize()
    assert torch.equal(tree, linear)
    assert kernels.launch_counts() == {**NONE, "B11": 1, "B11-tree": 2}


# (B, T, H, HK, D, W, kstart) in bfloat16: both sides of the boundary
# between the prefill (wgmma) and verify (key-split) kernels at M = T * rep
# packed rows 63 / 64 / 65 (rep 1) and 60 / 64 / 68 (rep 4); the engine's
# prefill chunk (B = 1, T = 256 against 1000 context columns); a verify
# chunk whose rows start on and beside the key-split boundaries (W = 1029:
# 4 splits of 320 columns; the last row sees one column). Every row sees
# at least one column.
REGIME_CASES = [
    (2, 63, 2, 2, 128, 200, (0, 100)),
    (2, 64, 2, 2, 128, 200, (5, 136)),
    (2, 65, 2, 2, 64, 200, (64, 0)),
    (2, 15, 8, 2, 64, 150, (3, 90)),
    (2, 16, 8, 2, 128, 150, (3, 90)),
    (2, 17, 8, 2, 128, 150, (0, 133)),
    (1, 256, 32, 32, 128, 1280, (24,)),
    (4, 5, 4, 2, 128, 1029, (319, 320, 960, 1024)),
]


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", REGIME_CASES, ids=[
    f"B{c[0]}-T{c[1]}-M{c[1] * c[2] // c[3]}-D{c[4]}-W{c[5]}"
    for c in REGIME_CASES])
def test_flash_chunk_regimes_match_plain(cuda, case, q8):
    """B11 on both sides of its regime boundary, held row by row against
    the plain version; where T <= 32, a chain tree through B11-tree must
    give B11-linear's bits in either regime."""
    B, T, H, HK, D, W, ks = case
    g = torch.Generator().manual_seed(T * 7 + W)
    q = torch.randn((B, T, H, D), generator=g).bfloat16().to(cuda)
    k, v, kr, vr = _pools(g, cuda, B, W, HK, D, torch.bfloat16, q8)
    kstart = torch.tensor(ks, dtype=torch.int32, device=cuda)
    kw = dict(k_rows=kr, v_rows=vr)
    kernels.reset_launch_counts()
    out = sf.flash_chunk_attention(q, k, v, W, kstart, **kw)
    _close(out, sf.flash_chunk_attention_plain(q, k, v, W, kstart, **kw),
           torch.bfloat16)
    want = {**NONE, "B11": 1}
    if T <= sf.TREE_MAX_NODES:
        chain = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                      device=cuda)).expand(B, T, T)
        tree = sf.flash_chunk_attention(q, k, v, W, kstart, tree_mask=chain,
                                        **kw)
        assert torch.equal(tree, out)
        want["B11-tree"] = 1
    torch.cuda.synchronize()
    assert kernels.launch_counts() == want


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((2, 4, 16), device=cuda)            # head dim 16
    k = torch.zeros((4, 8, 2, 16), device=cuda)
    bt = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_attention(q, k, k, bt, lens)
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    c = torch.zeros((1, 16, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="length"):
        sf.flash_chunk_attention(q, c, c, 12, torch.zeros(1, device=cuda))
    q = torch.zeros((1, 33, 2, 64), device=cuda)
    c = torch.zeros((1, 64, 2, 64), device=cuda)
    tm = torch.ones((1, 33, 33), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="32"):
        sf.flash_chunk_attention(q, c, c, 64, torch.zeros(1, device=cuda),
                                 tree_mask=tm)


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_engine_on_the_card_matches_cpu(cuda, kv, fused):
    """A float32 engine with head dim 64 on the card and on the CPU from
    the same parameters: every request finishes, the card run goes
    through the attention kernels and, though the config asks for the
    fused RMSNorm and SwiGLU, launches none of B4-B5 (the serving
    forwards stay unfused), and the first decode logits agree within 1e-3
    (the card's matmuls and kernels sum in other orders) — 1e-2 for
    int8 KV, where a value within an ulp of a rounding boundary may land
    on the neighbouring int8 step and move the logits by ~1e-3."""
    cfg = tl.LlamaConfig.tiny(hidden_size=128, num_heads=2, num_kv_heads=1,
                              intermediate_size=256, num_layers=2,
                              max_seq_len=64, fused_kernels="auto")
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    rs = np.random.RandomState(0)
    prompts = [rs.randint(3, 256, (n,)).astype(np.int32) for n in (5, 19, 9)]
    kw = dict(max_batch=2, page_size=8, max_len=48, kv_cache_dtype=kv,
              prefill_chunk=8, fused=fused)
    kernels.reset_launch_counts()
    on_card = ContinuousBatchingEngine(params, cfg, device=cuda, **kw)
    outs = on_card.generate(prompts, max_new_tokens=6)
    counts = kernels.launch_counts()
    assert all(len(o) == len(p) + 6 for o, p in zip(outs, prompts))
    L, st = cfg.num_layers, on_card.stats()
    assert counts == {**NONE, "B9": 0 if fused else st["steps"] * L,
                      "B10": st["steps"] * L if fused else 0,
                      "B11": st["prefill_chunks"] * L if fused else 0}
    logits = []
    for dev in (cuda, torch.device("cpu")):
        pool = gen.init_paged_cache(cfg, 5, 8, kv_dtype=kv, device=dev)
        table = torch.tensor([1, 2, 3], dtype=torch.int32)
        tok = torch.from_numpy(prompts[1][None, :16].copy())
        _, pool = gen.paged_prefill_chunk(
            _on(params, dev), tok.to(dev), pool,
            table, cfg, ctx_cap=0, ctx_len=0, chunk_len=16, fused=fused)
        lg, _ = gen.paged_decode_forward(
            _on(params, dev), torch.tensor([7], dtype=torch.int32), pool,
            table[None], torch.tensor([16], dtype=torch.int32), cfg,
            fused=fused)
        logits.append(lg.cpu())
    tol = 1e-2 if kv else 1e-3
    torch.testing.assert_close(logits[0], logits[1], rtol=tol, atol=tol)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_tree_spec_engine_on_the_card_matches_cpu(cuda, kv):
    """The tree-speculating engine (draft_layers=1, spec_tree=(2, 3),
    fused) in float32 on the card and on the CPU from the same
    parameters, the post-draft layers damped by 1e-3 so that the draft
    tracks the target: the same greedy tokens, acceptance over 0.3,
    the draft pool drained, and on the card every forward through its
    kernels — per layer, B10 for each decode and draft decode step,
    B11 for each prefill chunk and draft catch-up chunk, B11-tree for
    each tree verify."""
    cfg = tl.LlamaConfig.tiny(hidden_size=128, num_heads=2, num_kv_heads=1,
                              intermediate_size=256, num_layers=2,
                              max_seq_len=64)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    for n in ("wo", "wd"):
        params["layers"][n][1:] *= 1e-3
    rs = np.random.RandomState(0)
    prompts = [rs.randint(3, 256, (n,)).astype(np.int32) for n in (5, 19, 9)]
    kw = dict(max_batch=2, page_size=8, max_len=48, kv_cache_dtype=kv,
              prefill_chunk=8, fused=True, draft_layers=1, spec_tree=(2, 3))
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        kernels.reset_launch_counts()
        eng = ContinuousBatchingEngine(params, cfg, device=dev, **kw)
        outs[dev.type] = eng.generate(prompts, max_new_tokens=8)
        counts = kernels.launch_counts()
        assert eng.spec.acceptance_rate > 0.3
        assert eng.draft_cache.allocator.num_used == 0
        if dev.type == "cuda":
            f, L = eng.stats()["forwards"], cfg.num_layers
            assert f["tree"] > 0
            assert counts == {
                **NONE, "B10": L * f["decode"] + f["draft_decode"],
                "B11": L * (f["prefill"] + f["verify"])
                + f["draft_catchup"],
                "B11-tree": L * f["tree"]}
    for a, b in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_array_equal(a, b)


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# (D, dtype, causal, GQA group, (Sq, Sk) pairs): lengths that leave
# ragged 64- and 128-row tiles; then 320 / 192, which crosses the
# 128-row query tiles unevenly, and lengths that are not multiples of 8
# (the Hopper kernels' TMA zero fill past S); then B2's edges: Sq = 45
# against Sk = 300 (under the causal mask four of B2's five 64-key tiles
# see no query and write zeros) and query tails that end inside B2's
# 64-row query tiles (100, 290)
FLASH_CASES = [(d, dt, causal, rep, ((200, 200), (72, 136)))
               for d in (64, 128)
               for dt in (torch.float32, torch.bfloat16)
               for causal in (False, True) for rep in (1, 2)] + [
    (d, dt, causal, 2, ((320, 192), (77, 77), (45, 83)))
    for d in (64, 128) for dt in (torch.float32, torch.bfloat16)
    for causal in (False, True)] + [
    (d, dt, causal, 1, ((45, 300), (100, 260), (290, 100)))
    for d in (64, 128) for dt in (torch.float32, torch.bfloat16)
    for causal in (False, True)]
FLASH_FAULT = 16   # keys dropped from the plain backward: it must fail


def _fids(c):
    odd = {(200, 200): "", (320, 192): "-odd", (45, 300): "-b2edge"}
    return (f"D{c[0]}-{str(c[1])[6:]}-{'causal' if c[2] else 'full'}-"
            f"rep{c[3]}{odd[c[4][0]]}")


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[_fids(c) for c in FLASH_CASES])
def test_flash_kernels_match_plain(cuda, case):
    D, dtype, causal, rep, lengths = case
    g = torch.Generator().manual_seed(2)
    B, HK = 2, 2
    H = HK * rep
    for sq, sk in lengths:
        q = torch.randn((B, sq, H, D), generator=g).to(dtype).to(cuda)
        k = torch.randn((B, sk, HK, D), generator=g).to(dtype).to(cuda)
        v = torch.randn((B, sk, HK, D), generator=g).to(dtype).to(cuda)
        do = torch.randn((B, sq, H, D), generator=g).to(dtype).to(cuda)
        kr = torch.repeat_interleave(k, rep, dim=2)
        vr = torch.repeat_interleave(v, rep, dim=2)
        kernels.reset_launch_counts()
        out, lse = fa.flash_fwd(q, kr, vr, causal=causal, scale=D ** -0.5)
        want, want_lse = fa.flash_attention_plain(
            q.float(), kr.float(), vr.float(), causal=causal)
        _close(out, want, dtype)
        torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.flash_attention(*leaves, causal=causal).backward(do)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == {**NONE, "B1": 2, "B2": 1,
                                           "B3": 1}
        delta = (out.float() * do.float()).sum(-1).transpose(1, 2)
        f = [t.float() for t in (q, kr, vr, do)]

        def plain_grads(keys):
            """dQ, dK, dV of the plain backward passes over the first
            ``keys`` keys (dK, dV zero past them), on B1's lse."""
            kk, vk = f[1][:, :keys], f[2][:, :keys]
            args = (f[0], kk, vk, f[3], lse, delta.contiguous(), causal,
                    D ** -0.5)
            dk, dv = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, sk - keys))
                      for t in fa.flash_bwd_dkv_plain(*args))
            return [fa.flash_bwd_dq_plain(*args)] + [
                t.reshape(B, sk, HK, rep, D).sum(3) for t in (dk, dv)]

        if dtype == torch.float32:
            ref = [t.float().requires_grad_() for t in (q, k, v)]
            o, _ = fa.flash_attention_plain(
                ref[0], torch.repeat_interleave(ref[1], rep, dim=2),
                torch.repeat_interleave(ref[2], rep, dim=2), causal=causal)
            o.backward(do.float())
            for a, b in zip(leaves, ref):
                torch.testing.assert_close(a.grad, b.grad, rtol=1e-4,
                                           atol=1e-4)
        else:
            for a, b in zip(leaves, plain_grads(sk)):
                _close(a.grad, b, dtype)
        # the planted fault: the last FLASH_FAULT keys that a query sees
        # dropped from the plain version must fail dK and dV (and dQ)
        seen = min(sq, sk) if causal else sk
        rtol = 1e-4 if dtype == torch.float32 else 2e-2
        for a, b in zip(leaves, plain_grads(seen - FLASH_FAULT)):
            assert _rows_ratio(a.grad, b, rtol).max() > 1.0


def test_flash_wrapper_raises_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 128, 2, 96), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q, q, q, causal=True, scale=0.1)
    q = torch.zeros((1, 128, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_fwd(q, q, q, causal=True, scale=0.1)


FUSED_CASES = [(dt, n, h) for dt in (torch.float32, torch.bfloat16)
               for n, h in ((37, 40), (100, 1536), (21, 5120), (3, 8192))]


@pytest.mark.parametrize("case", FUSED_CASES,
                         ids=[f"{str(c[0])[6:]}-{c[1]}x{c[2]}"
                              for c in FUSED_CASES])
def test_fused_kernels_match_plain(cuda, case):
    """B4a-B5b on (N, h) rows whose scales spread over 1e-3..7 (so eps
    matters in some rows), N not a multiple of B4b's 16 rows; the
    autograd ops give the wrappers' results."""
    dtype, n, h = case
    g = torch.Generator().manual_seed(3)

    def rand(scale=1.0):
        return (torch.randn((n, h), generator=g) * scale).to(dtype).to(cuda)

    x = rand(torch.exp(torch.empty((n, 1)).uniform_(-7, 2, generator=g)))
    w = (1 + 0.1 * torch.randn((h,), generator=g)).to(dtype).to(cuda)
    ct, gate, up = rand(), rand(3.0), rand()
    tight = 2.0 ** -7
    kernels.reset_launch_counts()
    out, rstd = fk.rms_fwd(x, w, 1e-5)
    want, want_rstd = fk.rms_norm_fwd_plain(x, w, 1e-5)
    _close(out, want, dtype, tight)
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=0)
    dx, dw = fk.rms_bwd(x, w, rstd, ct)
    want_dx, want_dw = fk.rms_norm_bwd_plain(x, w, rstd, ct)
    _close(dx, want_dx, dtype, tight)
    _close(dw[None], want_dw[None], dtype, tight)
    act = fk.swiglu_fwd(gate, up)
    _close(act, fk.swiglu_fwd_plain(gate, up), dtype, tight)
    dg, du = fk.swiglu_bwd(gate, up, ct)
    for a, b in zip((dg, du), fk.swiglu_bwd_plain(gate, up, ct)):
        _close(a, b, dtype, tight)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {**NONE, "B4a": 1, "B4b": 1,
                                       "B5a": 1, "B5b": 1}
    leaves = [t.clone().requires_grad_() for t in (x, w, gate, up)]
    fk.rms_norm(leaves[0][None], leaves[1], 1e-5).backward(ct[None])
    fk.swiglu(leaves[2], leaves[3]).backward(ct)
    for a, b in zip(leaves, (dx, dw, dg, du)):
        assert torch.equal(a.grad, b)


def test_fused_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    odd = torch.zeros((4, 12), device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        fk.rms_fwd(odd, torch.ones(12, device=cuda), 1e-5)
    wide = torch.zeros((2, 8200), device=cuda)
    with pytest.raises(ValueError, match="up to 8192"):
        fk.rms_fwd(wide, torch.ones(8200, device=cuda), 1e-5)
    half = torch.zeros((4, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        fk.swiglu_fwd(half, half)
    x = torch.zeros((4, 16), device=cuda)
    with pytest.raises(ValueError, match="on cuda"):
        fk.swiglu_bwd(x, x, torch.zeros((4, 16)))
    with pytest.raises(ValueError, match="contiguous"):
        fk.swiglu_fwd(x.t(), x.t())


TRAIN_CASES = [(p, f) for f in ("xla", "auto") for p in tl.REMAT_POLICIES]


@pytest.mark.parametrize("policy,fused_kernels", TRAIN_CASES,
                         ids=[p if f == "xla" else f"{p}-{f}"
                              for p, f in TRAIN_CASES])
def test_train_step_on_the_card_matches_cpu(cuda, policy, fused_kernels):
    """A float32 model of head dim 64 at S = 128 takes the flash kernels
    on the card: one step's loss and grad norm agree with the same step
    on the CPU (einsum attention, plain RMSNorm and SwiGLU) within 1e-4,
    and each layer launches B1 twice under every policy (backward
    recomputes the forward; "attn" keeps only the attention output, as
    the JAX policy does, so the flash residuals are recomputed too), B2
    and B3 once. Under "auto" also B4a four times a layer (two norms,
    again in the recompute) and once for the final norm, B4b twice a
    layer and once, B5a twice a layer, B5b once."""
    cfg = tl.LlamaConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2,
                              remat=True, remat_policy=policy,
                              fused_kernels=fused_kernels)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 128)))
    metrics = []
    for dev in (cuda, torch.device("cpu")):
        state = tt.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
        state = tt.TrainState(0, *(_on(t, dev) for t in (
            state.params, state.master, state.m, state.v)))
        step = tt.make_train_step(cfg, seq_chunk=64)
        kernels.reset_launch_counts()
        _, m = step(state, toks.to(dev))
        metrics.append({k: x.item() for k, x in m.items()})
        if dev.type == "cuda":
            L = cfg.num_layers
            fused = {"B4a": 4 * L + 1, "B4b": 2 * L + 1, "B5a": 2 * L,
                     "B5b": L} if fused_kernels == "auto" else {}
            assert kernels.launch_counts() == {**NONE, "B1": 2 * L,
                                               "B2": L, "B3": L, **fused}
    for k in ("loss", "grad_norm"):
        assert abs(metrics[0][k] - metrics[1][k]) <= 1e-4 * abs(
            metrics[1][k]), (k, metrics)


# (D, dtype, int8 rows, GQA group, capacity S): bf16 queries take the
# key-split kernel with its dense addressing, whose split count follows
# B, HK and S: at B = 4, HK = 2 capacities 150, 512, 1024 and 2048 give
# 1, 2, 4 and 8 splits; float32 queries take the plain-FMA body
B7_CASES = [(d, dt, q8, rep, 150) for d in (64, 128)
            for dt in (torch.float32, torch.bfloat16)
            for q8 in (False, True) for rep in (1, 2, 4, 8)] + [
    (d, torch.bfloat16, q8, rep, S) for S in (512, 1024, 2048)
    for d in (64, 128) for q8 in (False, True) for rep in (1, 4)]


def _rows_ratio(got, want, rtol):
    """Each row's error as a share of its limit (the ``_close`` rule)."""
    g, w = got.float().cpu(), want.float().cpu()
    ref = w.norm(dim=-1)
    lim = rtol * ref + 1e-4 * ref.square().mean().sqrt()
    return (g - w).norm(dim=-1) / lim


def _dense_case(g, cuda, D, dtype, q8, rep, S):
    """B7's inputs: layer 1 of a (B, L, S + 10, HK, D) cache viewed as
    (B, S, HK, D) (strides that are not a contiguous tensor's), B = 4,
    HK = 2, rows of lengths 1, S, S - 73 and 16, every column at or past
    a row's length NaN (int8: its scale NaN). int8 scales are 0.01-0.06
    at S = 150 and 0.005-0.025 above (``chip_smoke.py``'s, scores of
    order one, so that a dropped key tile of a long row moves the
    output). Returns q, the NaN-tailed views, the same views clean (for
    the plain version) and the lengths."""
    B, L, Smax, HK = 4, 2, S + 10, 2
    H = HK * rep
    lens = torch.tensor([1, S, S - 73, 16], dtype=torch.int32)
    big = (B, L, Smax, HK, D)
    lo, span = (0.01, 0.05) if S == 150 else (0.005, 0.02)
    if q8:
        k = torch.randint(-127, 128, big, generator=g, dtype=torch.int8)
        v = torch.randint(-127, 128, big, generator=g, dtype=torch.int8)
        ks = torch.rand(big[:4], generator=g) * span + lo
        vs = torch.rand(big[:4], generator=g) * span + lo
    else:
        k = torch.randn(big, generator=g).to(dtype)
        v = torch.randn(big, generator=g).to(dtype)
        ks = vs = None
    q = torch.randn((B, H, D), generator=g).to(dtype).to(cuda)
    dirty = [t if t is None else t.clone() for t in (k, v, ks, vs)]
    tail = torch.arange(Smax)[None, :] >= lens[:, None].long()   # (B, Smax)
    nan_target = (2, 3) if q8 else (0, 1)   # int8 rows: NaN their scales
    for i in nan_target:
        dirty[i][tail[:, None, :].expand(B, L, Smax)] = float("nan")

    def view(ts):
        return [t if t is None else t.to(cuda)[:, 1, :S] for t in ts]

    return q, view(dirty), view((k, v, ks, vs)), lens.to(cuda)


@pytest.mark.parametrize("case", B7_CASES, ids=[
    _ids(c) if c[4] == 150 else f"{_ids(c)}-S{c[4]}" for c in B7_CASES])
def test_decode_attention_kernel_matches_plain(cuda, case):
    """B7 on layer 1 of a (B, L, Smax, HK, D) cache viewed as (B, S, HK,
    D) (``_dense_case``), with every column at or past a row's length
    NaN. The kernel must equal the plain version on the same cache with
    a clean tail (so it read no tail column), per row, for a (B,) length
    tensor (and, on the clean views, for one int length); the plain
    version without row 1's last 16 live keys (at S = 150; 64 keys, one
    key tile of the split kernel, above) must fail that check."""
    D, dtype, q8, rep, S = case
    q, (ck, cv, kr, vr), (pk, pv, pkr, pvr), lens = _dense_case(
        torch.Generator().manual_seed(4), cuda, D, dtype, q8, rep, S)
    assert not ck.is_contiguous()
    kw = dict(k_rows=kr, v_rows=vr)
    pkw = dict(k_rows=pkr, v_rows=pvr)
    kernels.reset_launch_counts()
    out = fk.decode_attention(q, ck, cv, lens, **kw)
    want = fk.decode_attention_plain(q, pk, pv, lens, **pkw)
    _close(out, want, dtype)
    assert torch.isfinite(out).all()
    bad_lens = lens.clone()
    bad_lens[1] -= 16 if S == 150 else 64   # row 1 loses its last keys
    fault = _rows_ratio(out, fk.decode_attention_plain(q, pk, pv, bad_lens,
                                                       **pkw),
                        1e-5 if dtype == torch.float32 else 2e-2)
    assert fault.max() > 1.0
    same = fk.decode_attention(q, pk, pv, 77, **pkw)      # clean views
    _close(same, fk.decode_attention_plain(q, pk, pv, 77, **pkw), dtype)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {**NONE, "B7": 2}


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("splits", fk.DECODE_SPLITS)
def test_decode_attention_forced_splits_match_plain(cuda, splits, q8):
    """B7's bf16 kernel with its key split forced (S = 2048, where the
    rule takes 8) against the plain version, per row, on the NaN-tailed
    cache, with the same planted fault; a split count the kernel does
    not take, or a forced split for float32 queries, raises."""
    q, (ck, cv, kr, vr), (pk, pv, pkr, pvr), lens = _dense_case(
        torch.Generator().manual_seed(5), cuda, 128, torch.bfloat16, q8, 2,
        2048)
    kw = dict(k_rows=kr, v_rows=vr)
    pkw = dict(k_rows=pkr, v_rows=pvr)
    out = fk.launch_decode(q, ck, cv, lens, splits=splits, **kw)
    want = fk.decode_attention_plain(q, pk, pv, lens, **pkw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    _close(out, want, torch.bfloat16)
    bad = lens.clone()
    bad[1] -= 64
    fault = _rows_ratio(out, fk.decode_attention_plain(q, pk, pv, bad,
                                                       **pkw), 2e-2)
    assert fault.max() > 1.0
    with pytest.raises(ValueError, match="splits"):
        fk.launch_decode(q, ck, cv, lens, splits=3, **kw)
    with pytest.raises(ValueError, match="splits"):
        fk.launch_decode(q.float(), pk, pv, lens, splits=splits, **pkw)


def test_decode_attention_wrapper_raises_on_what_the_kernel_does_not_take(
        cuda):
    q = torch.zeros((2, 4, 16), device=cuda)            # head dim 16
    c = torch.zeros((2, 8, 2, 16), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fk.decode_attention(q, c, c, 4)
    q = torch.zeros((2, 16, 64), device=cuda)           # rep 16
    c = torch.zeros((2, 8, 1, 64), device=cuda)
    with pytest.raises(ValueError, match="at most 8"):
        fk.decode_attention(q, c, c, 4)
    c = torch.zeros((2, 8, 2, 64), device=cuda)
    q = torch.zeros((2, 4, 64), device=cuda)
    with pytest.raises(ValueError, match="together"):
        fk.decode_attention(q, c, c, 4, k_rows=torch.ones((2, 8, 2),
                                                          device=cuda))
    with pytest.raises(ValueError, match="float32 or"):
        fk.decode_attention(q.half(), c.half(), c.half(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        t = c.transpose(1, 3).contiguous().transpose(1, 3)
        fk.decode_attention(q, t, t, 4)
    with pytest.raises(ValueError, match="int8"):
        fk.decode_attention(q, c, c, 4, k_rows=torch.ones((2, 8, 2),
                                                          device=cuda),
                            v_rows=torch.ones((2, 8, 2), device=cuda))


def test_generate_and_beam_search_on_the_card_match_cpu(cuda):
    """Dense decoding of a float32 model of head dim 64 on the card and
    on the CPU from the same parameters: greedy ``generate`` (KV fp and
    int8) and ``beam_search`` give the same tokens, and on the card each
    call launches B7 once per layer and decode step, L * (new - 1);
    ``use_kernel=False`` and left-padded rows launch it never."""
    cfg = tl.LlamaConfig.tiny(hidden_size=128, num_heads=2, num_kv_heads=1,
                              intermediate_size=256, num_layers=2,
                              max_seq_len=64)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    card = _on(params, cuda)
    prompt = np.random.RandomState(0).randint(3, 256, (3, 9)).astype(
        np.int32)
    new, L = 8, cfg.num_layers
    runs = [("generate", dict(kv_cache_dtype=None), L * (new - 1)),
            ("generate", dict(kv_cache_dtype="int8"), L * (new - 1)),
            ("generate", dict(use_kernel=False), 0),
            ("generate", dict(pad_token_id=int(prompt[0, 0])), 0),
            ("beam_search", dict(num_beams=3), L * (new - 1))]
    for fn, kw, launches in runs:
        kernels.reset_launch_counts()
        got = getattr(gen, fn)(card, prompt, cfg, max_new_tokens=new, **kw)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == {**NONE, "B7": launches}, (fn, kw)
        want = getattr(gen, fn)(params, prompt, cfg, max_new_tokens=new,
                                **kw)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(),
                                      err_msg=f"{fn} {kw}")


ROPE_CASES = [(d, dt) for d in (6, 64, 128)
              for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("case", ROPE_CASES,
                         ids=[f"D{d}-{str(dt)[6:]}" for d, dt in ROPE_CASES])
def test_rope_kernel_matches_plain(cuda, case):
    """B6 on q (B, S, H, D) and k (B, S, HK, D) cut from one (B, S, (H +
    2 HK) D) tensor, S = 37: forward and the autograd op's VJP (sign
    -1) equal the plain version bit for bit in f32 (the kernel rounds
    each product and sum as PyTorch's separate kernels do) and within
    one bf16 ulp in bf16; the plain version with the sign of sin
    flipped must fail the row check."""
    D, dtype = case
    g = torch.Generator().manual_seed(5)
    B, S, H, HK = 2, 37, 4, 2
    qkv = torch.randn((B, S, (H + 2 * HK) * D), generator=g).to(dtype)
    qkv = qkv.to(cuda)
    q = qkv[..., :H * D].unflatten(-1, (H, D))
    k = qkv[..., H * D:(H + HK) * D].unflatten(-1, (HK, D))
    assert not q.is_contiguous()
    cos, sin = tl.rope_tables(S, D, 10000.0, device=cuda)
    kernels.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (q, k)]
    rq, rk = fk.rope_qk(*leaves, torch.cat([cos, cos], -1),
                        torch.cat([sin, sin], -1))
    ct = torch.randn(rq.shape, generator=g).to(dtype).to(cuda)
    torch.autograd.backward((rq, rk), (ct, torch.zeros_like(rk)))
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {**NONE, "B6": 4}
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    for got, want in ((rq, fk.rope_plain(q, cos, sin)),
                      (rk, fk.rope_plain(k, cos, sin)),
                      (leaves[0].grad, fk.rope_plain(ct, cos, sin, -1.0))):
        torch.testing.assert_close(got.detach().float(), want.float(),
                                   rtol=rtol, atol=0)
    fault = _rows_ratio(rq.detach(), fk.rope_plain(q, cos, sin, -1.0),
                        2.0 ** -7)
    assert fault.max() > 1.0


def _head_major_case(g, cuda, D, dtype, q8, rep, cap=160):
    """B = 4 rows of lengths 1, cap - 10, 77 and 0 (two of them end
    mid-page) over pages of 16 in a head-major pool whose block table
    holds ``cap`` tokens, -1 past each row's pages; float pools NaN past
    the lengths and in page 0."""
    B, HK, page = 4, 2, 16
    pps = cap // page
    P = 1 + B * pps
    H = HK * rep
    lens = torch.tensor([1, cap - 10, 77, 0], dtype=torch.int32)
    bt = (torch.randperm(P - 1, generator=g) + 1).reshape(B, pps).int()
    for b in range(B):
        bt[b, -(-int(lens[b]) // page):] = -1
    shape = (P, HK, page, D)
    kw = {}
    if q8:
        kp = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        kw = dict(k_dequant_scale=torch.rand((B, HK), generator=g) * 0.05
                  + 0.01, v_dequant_scale=torch.rand((HK,), generator=g)
                  * 0.05 + 0.01)
    else:
        kp = torch.randn(shape, generator=g).to(dtype)
        vp = torch.randn(shape, generator=g).to(dtype)
        for b in range(B):
            for j in range(int(lens[b]), pps * page):
                if bt[b, j // page] >= 0:
                    kp[bt[b, j // page], :, j % page] = float("nan")
                    vp[bt[b, j // page], :, j % page] = float("nan")
        kp[0] = vp[0] = float("nan")
    q = torch.randn((B, H, D), generator=g).to(dtype)
    return ([t.to(cuda) for t in (q, kp, vp, bt, lens)],
            {k: v.to(cuda) for k, v in kw.items()})


# (D, dtype, int8 pages, GQA group, table capacity): bf16 queries take
# the split-key kernel, whose split count follows B, HK and the capacity:
# at B = 4, HK = 2 capacities 160, 512, 1024 and 2048 give 1, 2, 4 and 8
# splits; float32 queries take the plain-FMA body
B8_CASES = [(d, dt, q8, rep, 160) for d in (64, 128)
            for dt in (torch.float32, torch.bfloat16)
            for q8 in (False, True) for rep in (1, 2, 8)] + [
    (d, torch.bfloat16, q8, rep, cap) for cap in (512, 1024, 2048)
    for d in (64, 128) for q8 in (False, True) for rep in (1, 2, 8)]


@pytest.mark.parametrize("case", B8_CASES,
                         ids=[f"{_ids(c)}-cap{c[4]}" for c in B8_CASES])
def test_paged_decode_hm_kernel_matches_plain(cuda, case):
    """B8 against its plain version on the same pool (which masks what
    lies past the lengths), per row; no NaN in the output and zeros for
    the row of length 0; the plain version without row 1's last 16 live
    keys must fail the check."""
    D, dtype, q8, rep, cap = case
    (q, kp, vp, bt, lens), kw = _head_major_case(
        torch.Generator().manual_seed(6), cuda, D, dtype, q8, rep, cap)
    kernels.reset_launch_counts()
    out = fk.paged_decode_attention(q, kp, vp, bt, lens, **kw)
    want = fk.paged_decode_attention_plain(q, kp, vp, bt, lens, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {**NONE, "B8": 1}
    assert torch.isfinite(out).all() and not out[3].any()
    _close(out, want, dtype)
    bad = lens.clone()
    bad[1] -= 16
    fault = _rows_ratio(out, fk.paged_decode_attention_plain(
        q, kp, vp, bt, bad, **kw), 1e-5 if dtype == torch.float32 else 2e-2)
    assert fault.max() > 1.0


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("splits", fk.DECODE_SPLITS)
def test_paged_decode_hm_forced_splits_match_plain(cuda, splits, q8):
    """B8's bf16 kernel with its key split forced (capacity 2048, where
    the rule takes 8) against the plain version, per row, with the same
    planted fault; a split count the kernel does not take raises."""
    (q, kp, vp, bt, lens), kw = _head_major_case(
        torch.Generator().manual_seed(6), cuda, 128, torch.bfloat16, q8, 2,
        2048)
    out = fk.launch_paged_decode_hm(q, kp, vp, bt, lens, splits=splits,
                                    **kw)
    want = fk.paged_decode_attention_plain(q, kp, vp, bt, lens, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and not out[3].any()
    _close(out, want, torch.bfloat16)
    bad = lens.clone()
    bad[1] -= 16
    fault = _rows_ratio(out, fk.paged_decode_attention_plain(
        q, kp, vp, bt, bad, **kw), 2e-2)
    assert fault.max() > 1.0
    with pytest.raises(ValueError, match="splits"):
        fk.launch_paged_decode_hm(q, kp, vp, bt, lens, splits=3, **kw)


def _token_major_case(g, cuda, D, q8, rep, cap):
    """B = 4 rows of lengths 1, cap - 10, 77 and 0 (two of them end
    mid-page) over pages of 16 in a token-major (P, page, HK, D) pool
    whose block table holds ``cap`` tokens, -1 past each row's pages;
    int8 pages with per-token scales of 0.005-0.025 (``chip_smoke.py``'s,
    scores of order one as in bf16, so that a dropped key tile moves the
    output); bf16 pools NaN past the lengths and in page 0. Returns the kernel's inputs, the same pools with the NaN
    cleared (the plain versions multiply NaN by their zero weights) and
    RoPE rows at each row's position."""
    B, HK, page = 4, 2, 16
    pps = cap // page
    P = 1 + B * pps
    H = HK * rep
    lens = torch.tensor([1, cap - 10, 77, 0], dtype=torch.int32)
    bt = (torch.randperm(P - 1, generator=g) + 1).reshape(B, pps).int()
    for b in range(B):
        bt[b, -(-int(lens[b]) // page):] = -1
    shape = (P, page, HK, D)
    if q8:
        kp, vp = (torch.randint(-127, 128, shape, generator=g,
                                dtype=torch.int8) for _ in range(2))
        kw = dict(ks_pages=torch.rand(shape[:3], generator=g) * 0.02 + 0.005,
                  vs_pages=torch.rand(shape[:3], generator=g) * 0.02 + 0.005)
        clean = (kp, vp)
    else:
        kp, vp = (torch.randn(shape, generator=g).bfloat16()
                  for _ in range(2))
        clean = (kp.clone(), vp.clone())
        for b in range(B):
            for j in range(int(lens[b]), pps * page):
                if bt[b, j // page] >= 0:
                    kp[bt[b, j // page], j % page] = float("nan")
                    vp[bt[b, j // page], j % page] = float("nan")
        kp[0] = vp[0] = float("nan")
        kw = {}
    q = torch.randn((B, H, D), generator=g).bfloat16()
    cos, sin = tl.rope_tables(cap, D, 10000.0, device="cpu")
    pos = (lens - 1).clamp(min=0).long()
    rows = (cos[pos], sin[pos])
    return ([t.to(cuda) for t in (q, kp, vp, bt, lens)],
            [t.to(cuda) for t in clean], [t.to(cuda) for t in rows],
            {k: v.to(cuda) for k, v in kw.items()})


def _b9_b10(fused, q, kp, vp, bt, lens, rows, kw, splits=None):
    """B9 (or B10 with ``rows``) on CUDA tensors: through the wrapper, or
    with ``splits`` forced through the launcher."""
    rope = dict(cos_row=rows[0], sin_row=rows[1]) if fused else {}
    if splits is not None:
        return pa.launch_paged_decode(q, kp, vp, bt, lens, splits=splits,
                                      **rope, **kw)
    if fused:
        return sf.fused_paged_decode_attention(q, *rows, kp, vp, bt, lens,
                                               **kw)
    return pa.paged_attention(q, kp, vp, bt, lens, **kw)


def _b9_b10_plain(fused, q, kp, vp, bt, lens, rows, kw):
    if fused:
        return sf.fused_paged_decode_plain(q, *rows, kp, vp, bt, lens, **kw)
    return pa.paged_attention_plain(q, kp, vp, bt, lens, **kw)


# (D, int8 pages, GQA group, table capacity): bf16 queries take the
# key-split kernel shared with B8; at B = 4, HK = 2 capacities 160, 512,
# 1024 and 2048 give 1, 2, 4 and 8 splits
B9_SPLIT_CASES = [(d, q8, rep, cap) for d in (64, 128) for q8 in (False, True)
                  for rep, cap in ((1, 160), (2, 160), (8, 160), (2, 512),
                                   (2, 1024), (1, 2048), (2, 2048),
                                   (8, 2048))]


@pytest.mark.parametrize("case", B9_SPLIT_CASES, ids=[
    f"D{c[0]}-{'int8' if c[1] else 'bf16'}-rep{c[2]}-cap{c[3]}"
    for c in B9_SPLIT_CASES])
def test_paged_decode_split_kernels_match_plain(cuda, case):
    """B9 and B10 in bf16 (the key-split body) against their plain
    versions on the NaN-free pools, per row; no NaN in the output, zeros
    for the row of length 0 (the plain versions average V there, a length
    no engine passes); the plain version without row 1's last 64 live
    keys (one key tile of the kernel) must fail the check."""
    D, q8, rep, cap = case
    (q, kp, vp, bt, lens), clean, rows, kw = _token_major_case(
        torch.Generator().manual_seed(8), cuda, D, q8, rep, cap)
    bad = lens.clone()
    bad[1] -= 64
    for fused in (False, True):
        kernels.reset_launch_counts()
        out = _b9_b10(fused, q, kp, vp, bt, lens, rows, kw)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == {**NONE, ("B10" if fused
                                                    else "B9"): 1}
        assert torch.isfinite(out).all() and not out[3].any()
        want = _b9_b10_plain(fused, q, *clean, bt, lens, rows, kw)
        _close(out[:3], want[:3], torch.bfloat16)
        fault = _rows_ratio(out[:3], _b9_b10_plain(
            fused, q, *clean, bt, bad, rows, kw)[:3], 2e-2)
        assert fault.max() > 1.0


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("splits", pa.DECODE_SPLITS)
@pytest.mark.parametrize("fused", [False, True], ids=["B9", "B10"])
def test_paged_decode_forced_splits_match_plain(cuda, fused, splits, q8):
    """B9 and B10's bf16 kernel with its key split forced (capacity
    2048, where the rule takes 8) against the plain version, per row,
    with the same planted fault; a split count the kernel does not take,
    or a forced split for float32 queries, raises."""
    (q, kp, vp, bt, lens), clean, rows, kw = _token_major_case(
        torch.Generator().manual_seed(9), cuda, 128, q8, 2, 2048)
    out = _b9_b10(fused, q, kp, vp, bt, lens, rows, kw, splits=splits)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and not out[3].any()
    _close(out[:3], _b9_b10_plain(fused, q, *clean, bt, lens, rows,
                                  kw)[:3], torch.bfloat16)
    bad = lens.clone()
    bad[1] -= 64
    fault = _rows_ratio(out[:3], _b9_b10_plain(
        fused, q, *clean, bt, bad, rows, kw)[:3], 2e-2)
    assert fault.max() > 1.0
    with pytest.raises(ValueError, match="splits"):
        _b9_b10(fused, q, kp, vp, bt, lens, rows, kw, splits=3)
    with pytest.raises(ValueError, match="splits"):
        _b9_b10(fused, q.float(), *clean, bt, lens, rows, kw,
                splits=splits)


@pytest.mark.parametrize("kv", [None, "static", "dynamic"])
def test_block_attention_kernel_branch_matches_the_loop(cuda, kv):
    """``block_multihead_attention`` on a pure-decode batch of CUDA
    tensors takes B8 (one launch); the same inputs with a zero additive
    mask take the per-row loop, which launches nothing: the outputs
    agree (f32, 1e-5) and the caches are written to the same bits."""
    g = torch.Generator().manual_seed(7)
    nh, hd, bs, B = 2, 64, 16, 3
    dec = torch.tensor([5, 40, 17], dtype=torch.int32)
    bt = (torch.randperm(12, generator=g)).reshape(B, 4).int()
    qkv = torch.randn((B, 3 * nh * hd), generator=g) * 0.4
    kw = dict(block_tables=bt, block_size=bs)
    if kv is None:
        kc = torch.randn((12, nh, bs, hd), generator=g) * 0.4
        vc = torch.randn((12, nh, bs, hd), generator=g) * 0.4
    else:
        kc = torch.randint(-90, 90, (12, nh, bs, hd), generator=g,
                           dtype=torch.int8)
        vc = torch.randint(-90, 90, (12, nh, bs, hd), generator=g,
                           dtype=torch.int8)
        shape = (B, nh) if kv == "dynamic" else (nh,)
        kw.update(cache_k_quant_scales=(torch.rand(shape, generator=g) * 80
                                        + 60).to(cuda),
                  cache_v_quant_scales=(torch.rand(shape, generator=g) * 80
                                        + 60).to(cuda),
                  use_dynamic_cachekv_quant=kv == "dynamic")
    args = [qkv, kc, vc, torch.zeros(B, dtype=torch.int32), dec,
            torch.ones(B, dtype=torch.int32)]
    runs = []
    for mask in (None, torch.zeros((1, 1, 64, 64))):
        kernels.reset_launch_counts()
        extra = {} if mask is None else dict(mask=mask.to(cuda))
        out, _, k2, v2 = IF.block_multihead_attention(
            *(a.clone().to(cuda) for a in args), **kw, **extra)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == {
            **NONE, "B8": 1 if mask is None else 0}
        runs.append((out._value, k2._value, v2._value))
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(runs[0][1:], runs[1][1:]):
        assert torch.equal(a, b)


def _sched_cfg():
    return tl.LlamaConfig.tiny(hidden_size=128, num_heads=2, num_kv_heads=1,
                               intermediate_size=256, num_layers=2,
                               max_seq_len=64)


def _sched_prompts():
    rs = np.random.RandomState(0)
    motif = np.asarray([7, 11, 13], np.int32)
    return ([rs.randint(3, 256, (n,)).astype(np.int32) for n in (5, 19, 9)]
            + [np.tile(motif, 5)[:14]])


def _no_sync(eng):
    """Run ``eng``'s dispatch halves under the sync debug mode "error";
    returns their call counts."""
    calls = {"decode_dispatch": 0, "spec_dispatch": 0,
             "prefill_dispatch": 0}
    depth = [0]

    def wrap(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            if depth[0] == 0:
                torch.cuda.set_sync_debug_mode("error")
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    torch.cuda.set_sync_debug_mode(0)
        return wrapper

    for name in calls:
        setattr(eng, name, wrap(name, getattr(eng, name)))
    return calls


def _serve(eng, prompts, budget=16, new=6):
    from paddle_tpu_torch.serving import Priority, ServingScheduler
    sched = ServingScheduler(eng, token_budget=budget)
    reqs = [sched.submit(p, max_new_tokens=new,
                         priority=Priority.LOW if i % 2 else Priority.NORMAL)
            for i, p in enumerate(prompts)]
    sched.run()
    assert all(r.done and len(r.tokens) == new for r in reqs)
    return [r.output.tolist() for r in reqs]


@pytest.mark.parametrize("spec_k", [0, 2], ids=["plain", "ngram"])
def test_overlapped_dispatch_does_not_synchronize(cuda, spec_k):
    """Every decode, verify and prefill dispatch of an overlapped engine
    runs under ``set_sync_debug_mode("error")``: its inputs go up through
    pinned buffers with non-blocking copies, and no kernel wrapper reads
    the card."""
    cfg = _sched_cfg()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    kw = dict(max_batch=2, page_size=8, max_len=48, prefill_chunk=8,
              fused=True, spec_k=spec_k, overlap=True, device=cuda)
    _serve(ContinuousBatchingEngine(params, cfg, **kw), _sched_prompts())
    eng = ContinuousBatchingEngine(params, cfg, **kw)   # kernels built
    calls = _no_sync(eng)
    _serve(eng, _sched_prompts())
    assert calls["prefill_dispatch"] and calls["decode_dispatch"]
    if spec_k:
        assert calls["spec_dispatch"] and eng.forwards["verify"]


def test_planted_pageable_copy_fails_the_sync_check(cuda):
    """The check has teeth: a dispatch that uploads through a pageable
    ``.to(device)`` copy raises under the sync debug mode."""
    cfg = _sched_cfg()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, page_size=8,
                                   max_len=48, fused=True, device=cuda)
    req = eng.submit(_sched_prompts()[0], max_new_tokens=4)
    eng.step()
    assert req.tokens
    eng._up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    _no_sync(eng)
    with pytest.raises(RuntimeError, match="synchroniz"):
        eng.decode_dispatch(eng.ready_mask())


def test_uploads_behind_a_busy_stream_keep_their_values(cuda):
    """Uploads queued behind a ~10 ms sleep, from one host array that
    changes between them, each keep the value they were given, with no
    synchronizing operation: every upload goes through a pinned block
    that is not reused before its copy has run."""
    cfg = _sched_cfg()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, page_size=8,
                                   max_len=48, device=cuda)
    host = np.zeros((4096,), np.int32)
    eng._up(host)                       # the allocator's first block
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ups = []
        for i in range(8):
            host[:] = i
            ups.append(eng._up(host))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [(int(t.min()), int(t.max())) for t in ups] == [
        (i, i) for i in range(8)]


@pytest.mark.parametrize("kv", [None, "int8"])
def test_overlap_equals_sync_on_the_card(cuda, kv):
    """No budget: the overlapped pipeline gives the synchronous one's
    tokens on the card (same chunk widths and decode rows in both)."""
    cfg = _sched_cfg()
    params = tl.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    outs = []
    for overlap in (False, True):
        eng = ContinuousBatchingEngine(
            params, cfg, max_batch=2, page_size=8, max_len=48,
            prefill_chunk=8, fused=True, kv_cache_dtype=kv,
            overlap=overlap, device=cuda)
        outs.append(_serve(eng, _sched_prompts(), budget=None, new=8))
        assert not eng.has_inflight() and eng.idle
    assert outs[0] == outs[1]


def test_freed_pages_refilled_while_decode_in_flight(cuda):
    """The victim's decode is queued behind a ~10 ms sleep when its
    pages go back to the pool and the next tenant's prefill is
    dispatched into them: stream order lands the tenant's writes last,
    so its tokens equal those of a run without the race."""
    cfg = _sched_cfg()
    params = tl.init_params(cfg, torch.Generator().manual_seed(2),
                            device="cpu")
    kw = dict(max_batch=1, page_size=8, max_len=48, fused=True,
              enable_prefix_cache=False, device=cuda)
    pa, pb = _sched_prompts()[:2]
    want = ContinuousBatchingEngine(params, cfg, **kw).generate(
        [pb], max_new_tokens=6)[0]
    eng = ContinuousBatchingEngine(params, cfg, **kw)
    a = eng.create_request(pa, max_new_tokens=8)
    assert eng.admit_request(a)
    eng.prefill_step()
    torch.cuda._sleep(20_000_000)
    assert eng.decode_dispatch(eng.ready_mask()) is not None
    old = set(eng.cache.pages_held(0))
    eng.preempt_request(a)
    b = eng.create_request(pb, max_new_tokens=6)
    assert eng.admit_request(b)
    assert old & set(eng.cache.pages_held(0))
    assert eng.prefill_dispatch() > 0
    eng.commit_inflight()               # the victim's token is dropped
    assert len(a.tokens) == 1
    eng.run()
    np.testing.assert_array_equal(b.output, want)


@pytest.mark.parametrize("fused", [False, True], ids=["B9", "B10"])
def test_constrained_batch_on_the_card(cuda, fused):
    """A mixed batch of tool-call JSON, comma-list regex, menu and free
    requests under the overlapped scheduler, every decode and prefill
    dispatch (the mask upload included) under the sync debug mode: each
    constrained request's tokens walk its DFA, and the tokens equal the
    synchronous run's."""
    from paddle_tpu_torch import serving
    cfg = _sched_cfg()
    params = tl.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    toks = chip_smoke.synthetic_vocab(cfg.vocab_size, seed=5)
    menu = [[40, 41, 42], [40, 43], [50, 51, 52, 53]]
    dfas = [serving.json_schema_dfa(chip_smoke.TOOL_SCHEMA, toks),
            serving.dfa_from_regex(chip_smoke.LIST_REGEX, toks),
            serving.dfa_from_sequences(menu, cfg.vocab_size), None]
    outs = []
    for overlap in (False, True, True):
        eng = ContinuousBatchingEngine(
            params, cfg, max_batch=2, page_size=8, max_len=48,
            prefill_chunk=8, fused=fused, overlap=overlap, constraints=True,
            eos_token_id=2, device=cuda)
        sched = serving.ServingScheduler(eng, token_budget=16)
        if len(outs) == 2:              # kernels built, allocator warm
            calls = _no_sync(eng)
        reqs = [sched.submit(p, max_new_tokens=12, constraint=d)
                for p, d in zip(_sched_prompts(), dfas)]
        sched.run()
        assert all(r.done for r in reqs) and eng.idle
        for r, d in zip(reqs, dfas):
            if d is not None:
                chip_smoke.walk(d, r.tokens, 2)
        outs.append([r.tokens for r in reqs])
    assert calls["decode_dispatch"] and calls["prefill_dispatch"]
    assert outs[0] == outs[1] == outs[2]


def _supervised(cuda, params, cfg, prompts, site=None, stream=None,
                watchdog_s=None, **kw):
    """Prompts under an ``EngineSupervisor`` of fused engines on the
    card, one ``raise`` fault armed at ``site``'s 4th call; returns the
    outputs, the supervisor and the current streams the decode
    dispatches saw."""
    from paddle_tpu_torch.serving import EngineSupervisor, FaultInjector
    seen = []

    def factory():
        eng = ContinuousBatchingEngine(
            params, cfg, max_batch=2, page_size=8, max_len=48,
            prefill_chunk=8, fused=True, device=cuda, **kw)
        orig = eng.decode_dispatch

        def dispatch(mask):
            seen.append(torch.cuda.current_stream())
            return orig(mask)
        eng.decode_dispatch = dispatch
        return eng
    inj = FaultInjector()
    if site is not None:
        inj.arm(site, nth=4)
    sup = EngineSupervisor(factory, token_budget=16, watchdog_s=watchdog_s,
                           sleep=lambda s: None)
    with inj, torch.cuda.stream(stream or torch.cuda.current_stream()):
        reqs = [sup.submit(p, max_new_tokens=6) for p in prompts]
        sup.run()
    assert all(r.done and len(r.tokens) == 6 for r in reqs)
    assert inj.fired_total == (site is not None) == sup.recoveries
    return [r.output.tolist() for r in reqs], sup, seen


@pytest.mark.parametrize("site,overlap", [("decode_step", False),
                                          ("prefill_chunk", False),
                                          ("dispatch", True),
                                          ("transfer", True)])
def test_supervised_recovery_on_the_card(cuda, site, overlap):
    """A fault at an engine site recovers token-identically on the card
    (f32: the replay's B11 prefill and the uninterrupted run's B10
    decode differ only in summation order), and the rebuilt engine's
    allocator balances."""
    cfg = _sched_cfg()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    want, _, _ = _supervised(cuda, params, cfg, _sched_prompts(),
                             overlap=overlap)
    got, sup, _ = _supervised(cuda, params, cfg, _sched_prompts(), site,
                              overlap=overlap)
    assert got == want
    cache = sup.engine.cache
    cache.prefix.drop_all(cache.allocator)
    assert cache.allocator.num_used == 0


def test_watchdog_steps_run_on_the_callers_stream(cuda):
    """With a watchdog each step runs on a worker thread; its launches
    still land on the stream the caller was on (PyTorch's current stream
    is per thread), so the outputs equal a run on the default stream."""
    cfg = _sched_cfg()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    want, _, _ = _supervised(cuda, params, cfg, _sched_prompts())
    side = torch.cuda.Stream()
    got, _, seen = _supervised(cuda, params, cfg, _sched_prompts(),
                               "decode_step", stream=side, watchdog_s=60.0)
    assert got == want
    assert seen and all(s == side for s in seen)


def test_hooks_on_keep_dispatches_sync_free(cuda):
    """Metrics and request tracing on: every dispatch of an overlapped
    engine still runs under the sync debug mode, and the hooks that wait
    for the card (the fused step latency, the prefill chunk) wait in the
    commit halves and record."""
    import paddle_tpu_torch.observability as obs
    cfg = _sched_cfg()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    kw = dict(max_batch=2, page_size=8, max_len=48, prefill_chunk=8,
              fused=True, overlap=True, device=cuda)
    want = _serve(ContinuousBatchingEngine(params, cfg, **kw),
                  _sched_prompts())
    obs.REGISTRY.clear()
    obs.enable()
    obs.tracing.enable()
    try:
        eng = ContinuousBatchingEngine(params, cfg, **kw)
        calls = _no_sync(eng)
        got = _serve(eng, _sched_prompts())
        snap = obs.REGISTRY.to_json()
    finally:
        obs.disable()
        obs.tracing.disable()
        obs.REGISTRY.clear()
    assert got == want
    assert calls["decode_dispatch"] and calls["prefill_dispatch"]
    lat = snap["serving_fused_step_ms"]["values"]["kernel=decode_rope_attn"]
    assert lat["count"] == eng.forwards["decode"] and lat["sum"] > 0
    assert snap["serving_decode_steps_total"]["values"][""] == \
        eng.forwards["decode"]


# ---------------------------------------------------------- the host tier

def _tier_cache(cuda, kv, max_batch=3):
    """A host-tier cache on the card, its pool filled with random
    bytes, and slot 0 holding 20 committed tokens."""
    from paddle_tpu_torch.serving import TieredKVCache
    cfg = tl.LlamaConfig.tiny(num_layers=2, max_seq_len=64,
                              dtype=torch.bfloat16)
    cache = TieredKVCache(cfg, max_batch, 48, page_size=8, kv_dtype=kv,
                          persist_prefix=False, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    for arr in cache.pool.values():
        if arr.dtype == torch.int8:
            arr.copy_(torch.randint(-127, 128, arr.shape, generator=g,
                                    device=cuda))
        else:
            arr.copy_(torch.randn(arr.shape, generator=g, device=cuda))
    cache.admit(0, 20)
    cache.lengths[0] = 20
    return cache


def _slot_bytes(cache, slot, k):
    idx = torch.as_tensor(cache.pages_held(slot)[:k], device=cache.device)
    return {n: a.index_select(1, idx).view(torch.uint8)
            for n, a in cache.pool.items()}


def _zero_pages(cache, slot):
    """Write zeros into ``slot``'s pages, page by page (no index upload,
    so nothing synchronizes)."""
    for a in cache.pool.values():
        for p in cache.pages_held(slot):
            a[:, p].zero_()


def _same(a, b):
    return set(a) == set(b) and all(torch.equal(a[n], b[n]) for n in a)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["bf16", "int8"])
def test_swap_round_trip_is_byte_equal_on_the_card(cuda, kv):
    """A swap-out to pinned host memory and the swap-in scatter give back
    the pages' bytes (elsewhere in the pool), bf16 and int8 with its f32
    scales; the payload rests in pinned memory."""
    cache = _tier_cache(cuda, kv)
    cache.admit(1, 40)
    cache.lengths[1] = 27
    want = _slot_bytes(cache, 1, 4)
    cache.swap_out(1, rid=7)
    entry = cache.host.get(("swap", 7), touch=False)
    assert all(t.is_pinned() for t in entry["tensors"].values())
    cache.admit(2, 16)                  # a new tenant on the freed pages
    _zero_pages(cache, 2)
    assert cache.swap_in(1, 7, 40, expect_tokens=27) == 27
    torch.cuda.synchronize()
    assert _same(_slot_bytes(cache, 1, 4), want)
    assert cache.swap_outs_total == cache.swap_ins_total == 1


def test_nonblocking_swap_out_is_fenced_before_any_read(cuda):
    """A non-blocking swap-out queued behind a busy stream synchronizes
    nothing; the freed pages' next tenant writes them at once (queued
    after the gather), and the payload that ``fence_swaps`` puts in the
    store holds the victim's bytes, not the tenant's."""
    cache = _tier_cache(cuda, None, max_batch=2)
    want = {n: t.clone() for n, t in _slot_bytes(cache, 0, 3).items()}
    torch.cuda._sleep(20_000_000)
    torch.cuda.set_sync_debug_mode("error")
    try:
        cache.swap_out(0, rid=3, nonblocking=True)
        cache.admit(1, 24)
        _zero_pages(cache, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cache.swap_outs_total == 0 and cache.has_swapped(3)
    assert cache.fence_swaps() == 1 and cache.swap_outs_total == 1
    got = type(cache.host).decode(cache.host.get(("swap", 3),
                                                 touch=False))
    assert _same({n: t.to(cuda).view(torch.uint8) for n, t in got.items()},
                 want)
    cache.release(1)
    assert cache.swap_in(0, 3, 24, expect_tokens=20) == 20
    torch.cuda.synchronize()
    assert _same(_slot_bytes(cache, 0, 3), want)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["bf16", "int8"])
def test_move_pages_across_pools_and_defrag_are_byte_equal(cuda, kv):
    """``_move_pages`` from another pool lands the source pages
    byte-equal; ``defrag`` within one pool, whose source and destination
    ids overlap, moves every live page byte-equal."""
    src = _tier_cache(cuda, kv)
    dst = _tier_cache(cuda, kv)
    src.admit(1, 40)
    src.lengths[1] = 33
    want = _slot_bytes(src, 1, 5)
    dst.import_request_direct(1, src, 1, 40)
    torch.cuda.synchronize()
    assert _same(_slot_bytes(dst, 1, 5), want)
    assert dst.direct_moves_total == 1
    live = _slot_bytes(dst, 1, 5)
    live = {n: t.clone() for n, t in live.items()}
    dst.release(0)                      # holes below slot 1's pages
    assert dst.allocator.fragmentation() > 0
    dst.defrag()
    torch.cuda.synchronize()
    assert dst.allocator.fragmentation() == 0
    assert dst.pages_held(1)[:5] == [1, 2, 3, 4, 5]
    assert _same(_slot_bytes(dst, 1, 5), live)


def _adapter_registry(cfg, n=3, rank=4):
    from paddle_tpu_torch.serving import AdapterRegistry, init_lora
    reg = AdapterRegistry(cfg)
    for aid in range(1, n + 1):
        reg.register(aid, init_lora(cfg, rank, seed=40 + aid))
    return reg


def test_adapter_install_queues_without_a_sync(cuda):
    """Installs into a bf16 adapter pool on the card, queued behind a
    ~10 ms sleep under the sync debug mode, synchronize nothing and land
    each adapter's factors (zero-padded past its rank) and its scale
    exactly as the host casts them; slot 0 stays zeros."""
    from paddle_tpu_torch.serving import AdapterPool
    cfg = tl.LlamaConfig.tiny(num_layers=2, max_seq_len=64,
                              dtype=torch.bfloat16)
    reg = _adapter_registry(cfg, rank=4)
    pool = AdapterPool(cfg, slots=2, rank=8, registry=reg, device=cuda)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    torch.cuda.set_sync_debug_mode("error")
    try:
        slots = [pool.acquire(1), pool.acquire(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for aid, s in zip((1, 2), slots):
        src = reg.get(aid)
        got = pool.arrays["aq"][:, s].cpu()
        want = torch.from_numpy(src["aq"]).to(torch.bfloat16)
        assert torch.equal(got[:, :, :4], want)
        assert not got[:, :, 4:].any()
        assert torch.equal(pool.arrays["bo"][:, s, :4].cpu(),
                           torch.from_numpy(src["bo"]).to(torch.bfloat16))
        assert float(pool.arrays["scale"][s]) == 1.0
    assert not any(pool.arrays[n][:, 0].any() for n in ("aq", "bq", "ao",
                                                          "bo"))


@pytest.mark.parametrize("kv", [None, "int8"])
def test_adapter_pool_on_the_card(cuda, kv):
    """On the card (B10 and B11): base rows served by an engine with an
    adapter pool are token-identical to the engine without one, and an
    overlapped run with adapter rows keeps every dispatch free of a
    synchronization and drops every pin."""
    cfg = _sched_cfg()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    kw = dict(max_batch=2, page_size=8, max_len=48, prefill_chunk=8,
              fused=True, kv_cache_dtype=kv, device=cuda)
    pool = dict(slots=2, rank=4, registry=_adapter_registry(cfg))
    plain = _serve(ContinuousBatchingEngine(params, cfg, **kw),
                   _sched_prompts(), budget=None)
    based = _serve(ContinuousBatchingEngine(params, cfg, adapters=pool,
                                            **kw), _sched_prompts(),
                   budget=None)
    assert based == plain
    from paddle_tpu_torch.serving import ServingScheduler
    eng = ContinuousBatchingEngine(params, cfg, adapters=pool,
                                   overlap=True, **kw)
    calls = _no_sync(eng)
    sched = ServingScheduler(eng)
    reqs = [sched.submit(p, max_new_tokens=6, adapter_id=aid)
            for p, aid in zip(_sched_prompts(), (1, 2, 3, 0))]
    sched.run()
    assert all(r.done and len(r.tokens) == 6 for r in reqs)
    assert calls["prefill_dispatch"] and calls["decode_dispatch"]
    assert not any(eng.adapters._pins.values())
    assert reqs[3].tokens == plain[3][-6:]      # the base row


# ---- GPT-2, ERNIE and the attention functionals (phase 3n's path)
def _gpt_tiny_bf16():
    from paddle_tpu_torch.models import gpt as tg
    return tg, tg.GPTConfig.tiny(hidden_size=128, num_heads=2,
                                 intermediate_size=256, max_seq_len=256,
                                 dtype=torch.bfloat16, remat=True)


def test_gpt_bf16_on_the_card_against_f32_on_the_cpu(cuda):
    """A 2-layer GPT at head dim 64, S = 256: the bf16 loss and ``wqkv``
    gradient through B1-B3 (B1 twice a layer under remat, B2 and B3
    once) against f32 on the CPU from the same parameters."""
    import dataclasses
    tg, cfg = _gpt_tiny_bf16()
    params = tg.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    host = chip_smoke.f32_cpu(params)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 256)), dtype=torch.int32)
    kernels.reset_launch_counts()
    card = chip_smoke.loss_and_grads(torch, tg, params, tokens.to(cuda), cfg)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert kernels.launch_counts() == dict(NONE, B1=2 * L, B2=L, B3=L)
    ref = chip_smoke.loss_and_grads(
        torch, tg, host, tokens, dataclasses.replace(cfg, dtype=torch.float32))
    assert abs(card[0] - ref[0]) <= 2e-3 * abs(ref[0])
    for n in ("layers/wqkv", "layers/wo"):
        a, b = card[1][n], ref[1][n]
        assert ((a - b).norm() / b.norm()).item() <= chip_smoke.SLICE_LEAF_RTOL


def test_ernie_mask_on_the_card_equals_the_cpu(cuda):
    from paddle_tpu_torch.models import ernie as te
    cfg = te.ErnieConfig.tiny()
    rng = np.random.default_rng(1)
    for _ in range(3):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 128)),
                              dtype=torch.int32)
        assert torch.equal(te._mlm_mask(tok.to(cuda), cfg).cpu(),
                           te._mlm_mask(tok, cfg))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_functional_flash_attention_on_the_card(cuda, D, causal):
    """``nn.functional.flash_attention`` on CUDA ``Tensor``s launches B1
    once, and B2 and B3 once under ``.backward()``; its output and input
    gradients hold the row rule against ``backend="xla"`` in f32, which
    launches nothing."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nn import functional as TF
    g = torch.Generator(device=cuda).manual_seed(D + causal)
    q, k, v, do = (torch.randn((1, 256, 2, D), generator=g, device=cuda)
                   .bfloat16() for _ in range(4))
    kernels.reset_launch_counts()
    ts = [ptt.to_tensor(t, stop_gradient=False) for t in (q, k, v)]
    out, _ = TF.flash_attention(*ts, causal=causal)
    out.backward(ptt.to_tensor(do))
    torch.cuda.synchronize()
    assert kernels.launch_counts() == dict(NONE, B1=1, B2=1, B3=1)
    kernels.reset_launch_counts()
    rs = [ptt.to_tensor(t.float(), stop_gradient=False) for t in (q, k, v)]
    ref, _ = TF.flash_attention(*rs, causal=causal, backend="xla")
    ref.backward(ptt.to_tensor(do.float()))
    torch.cuda.synchronize()
    assert kernels.launch_counts() == NONE
    _close(out._value, ref._value.detach(), torch.bfloat16)
    for t, r in zip(ts, rs):
        _close(t.grad._value, r.grad._value, torch.bfloat16)
