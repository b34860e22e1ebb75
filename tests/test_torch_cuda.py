"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False (as on a CPU-only test machine) and runs on an H100 with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` keeps the JAX-side test harness out of the process).
Shapes are small but cover every template instantiation the wrappers
dispatch to: head dim 64 and 128, float32 and bfloat16 queries, native
and int8 KV, GQA rep 1 and 2; the flash kernels B1-B3 also causal and
full, at ragged lengths (Sq = Sk = 200; Sq = 72 against Sk = 136).
Tolerances: float32 1e-5 (same math, another summation order; 1e-4
for the flash gradients, sums of up to 200 products, against autograd
through the plain forward). bfloat16, ``chip_smoke.py``'s row check:
every row (one D-vector) within 2e-2 * |plain row| + 1e-4 * the rms of
the plain rows (the kernels round their outputs, and p and ds, to bf16,
2^-9 relative; the floor admits rows that cancel to zero); the flash
gradients against the plain B2 and B3 in float32 on B1's own lse and
delta, as the autograd op hands them over.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import generate as gen
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import train as tt
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as fa
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


def _close(got, want, dtype):
    g, w = got.float().cpu(), want.float().cpu()
    if dtype == torch.float32:
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    else:
        ref = w.norm(dim=-1)
        lim = 2e-2 * ref + 1e-4 * ref.square().mean().sqrt()
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


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_engine_on_the_card_matches_cpu(cuda, kv, fused):
    """A float32 engine with head dim 64 on the card and on the CPU from
    the same parameters: every request finishes, the card run goes
    through the kernels, and the first decode logits agree within 1e-3
    (the card's matmuls and kernels sum in other orders) — 1e-2 for
    int8 KV, where a value within an ulp of a rounding boundary may land
    on the neighbouring int8 step and move the logits by ~1e-3."""
    cfg = tl.LlamaConfig.tiny(hidden_size=128, num_heads=2, num_kv_heads=1,
                              intermediate_size=256, num_layers=2,
                              max_seq_len=64)
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


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev)


FLASH_CASES = [(d, dt, causal, rep) for d in (64, 128)
               for dt in (torch.float32, torch.bfloat16)
               for causal in (False, True) for rep in (1, 2)]


def _fids(c):
    return (f"D{c[0]}-{str(c[1])[6:]}-{'causal' if c[2] else 'full'}-"
            f"rep{c[3]}")


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[_fids(c) for c in FLASH_CASES])
def test_flash_kernels_match_plain(cuda, case):
    D, dtype, causal, rep = case
    g = torch.Generator().manual_seed(2)
    B, HK = 2, 2
    H = HK * rep
    for sq, sk in ((200, 200), (72, 136)):
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
        if dtype == torch.float32:
            ref = [t.float().requires_grad_() for t in (q, k, v)]
            o, _ = fa.flash_attention_plain(
                ref[0], torch.repeat_interleave(ref[1], rep, dim=2),
                torch.repeat_interleave(ref[2], rep, dim=2), causal=causal)
            o.backward(do.float())
            for a, b in zip(leaves, ref):
                torch.testing.assert_close(a.grad, b.grad, rtol=1e-4,
                                           atol=1e-4)
            continue
        delta = (out.float() * do.float()).sum(-1).transpose(1, 2)
        f = [t.float() for t in (q, kr, vr, do)]
        args = (*f, lse, delta.contiguous(), causal, D ** -0.5)
        dk, dv = fa.flash_bwd_dkv_plain(*args)
        want = [fa.flash_bwd_dq_plain(*args)] + [
            t.reshape(B, sk, HK, rep, D).sum(3) for t in (dk, dv)]
        for a, b in zip(leaves, want):
            _close(a.grad, b, dtype)


def test_flash_wrapper_raises_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 128, 2, 96), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q, q, q, causal=True, scale=0.1)
    q = torch.zeros((1, 128, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_fwd(q, q, q, causal=True, scale=0.1)


@pytest.mark.parametrize("policy", tl.REMAT_POLICIES)
def test_train_step_on_the_card_matches_cpu(cuda, policy):
    """A float32 model of head dim 64 at S = 128 takes the flash kernels
    on the card: one step's loss and grad norm agree with the same step
    on the CPU (einsum attention) within 1e-4, and each layer launches
    B1 twice under every policy (backward recomputes the forward; "attn"
    keeps only the attention output, as the JAX policy does, so the
    flash residuals are recomputed too), B2 and B3 once."""
    cfg = tl.LlamaConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2,
                              remat=True, remat_policy=policy)
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
            assert kernels.launch_counts() == {**NONE, "B1": 2 * L,
                                               "B2": L, "B3": L}
    for k in ("loss", "grad_norm"):
        assert abs(metrics[0][k] - metrics[1][k]) <= 1e-4 * abs(
            metrics[1][k]), (k, metrics)
