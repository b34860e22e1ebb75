#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path and training step on one
NVIDIA card.

    python3 chip_smoke.py                      # full run
    python3 chip_smoke.py --layers 2 --requests 4 --train-layers 2 \
        --train-steps 2                        # short check

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Card and build: prints the card's name and power limit
   (``nvidia-smi``), then builds every CUDA kernel of ``paddle_tpu_torch``
   from ``paddle_tpu_torch/csrc`` (one ``nvcc`` per source, all started
   together) and prints the build time and ptxas's register report.
2. Kernel vs plain: B9 (ragged paged decode), B10 (fused RoPE paged
   decode) and B11 (flash chunk prefill), each with bf16 and int8 KV, at
   the serving shapes (H = HK = 32, D = 128, page 16, B = 8 rows of
   mixed lengths up to 2048 with one of length 1; T = 256 chunks at
   several context caps). Each kernel's output is held against its
   plain PyTorch version on the same inputs within the stated bf16
   tolerance, and timed with CUDA events beside its plain version, one
   PyTorch library call computing the same function
   (``scaled_dot_product_attention`` on the pre-gathered cache) and the
   card's bound for the work. Then B1-B3 (flash attention forward and
   its two backward passes) at the training shape (B = 4, S = 4096,
   H = 12, D = 128, causal) and six ragged ones, each against its plain
   version and against a planted fault the check must reject
   (``check_flash``); the training shape is timed beside SDPA.
3. The engine at Llama-2-7B width (random weights from a seeded
   generator): ``max_batch=8, page_size=16, max_len=2048,
   prefill_chunk=256`` serving the request set in four tiers, KV {bf16,
   int8} x fused {off, on}. Per tier the launch counters are zeroed just
   before ``run()`` and read just after, and must equal the counts the
   tier's path implies; every request must finish with its token count;
   one request's prompt and output are fed back through the kernel-free
   prefill and its logits held against the kernel decode step's. Then
   ``torch.profiler`` traces a few prefill chunks and decode steps of
   the bf16 KV, fused tier and splits the card's kernel time into the
   attention kernels, matmuls and the rest, against the host's wall time.
3b. Training: ``make_train_step`` on the JAX bench's training model
   (20 layers, hidden 1536, seq 4096, batch 4, ``seq_chunk=512``), 2
   warm-up and 5 timed steps with the launch counters zeroed just before
   the timed steps (B1 twice per layer and step: backward recomputes the
   checkpointed layer; B2 and B3 once); tokens/s, MFU, peak memory and
   the losses, which must be finite and fall; a ``torch.profiler`` split
   of one step; and the whole-slice check (``whole_slice``) of a 2-layer
   model in bf16 on the card against f32 on the CPU.
4. The ``{"kernels": [...]}`` line, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Exits with 1 and prints no result when no CUDA card is visible. A JSON
record of the run goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak
# Every attention kernel against its plain version, row by row (a row is
# one D-vector: a query's output or dQ, a key's dK or dV):
#     |kernel row - plain row| <= ROW_RTOL * |plain row| + ROW_FLOOR * rms
# with rms the root mean square of the plain tensor's row norms. Rows
# shrink with their context (an output row of a query that sees t keys
# of N(0, 1) values has norm ~ sqrt(D / t)), so the limit follows each
# row and not the tensor's largest values. The kernels round their
# outputs to bf16 (2^-9 relative) and p and ds to bf16 before the
# products, as the TPU kernels do; on an H100 the worst rows of B1-B3
# and B9-B11 read 0.3-0.6% of their norms. The floor only admits rows
# that cancel to zero up to f32 rounding (dQ of the first query, dK and
# dV of keys no query sees). A flash kernel that skips its last key
# tile moves the late rows by 50-100%: check_flash plants that fault in
# the plain versions and fails unless the check rejects it.
ROW_RTOL, ROW_FLOOR = 2e-2, 1e-4
FAULT_TILE = 64                # keys dropped by the planted fault
LOGITS_ATOL = 0.25             # bf16 through 32 layers, logits ~ N(0, 1)
# flash B1's lse against the plain forward in f32 from the same bf16
# inputs: both f32 (~9 at S = 4096, ulp 1e-6), summed in other orders
LSE_ATOL = 1e-5
# whole-slice check: a 2-layer full-width model in bf16 on the card
# against f32 on the CPU from the same parameters, relative errors of
# the loss, the gradient norm, and each layer's wq, wk and wv gradient
# (the leaves that only the flash backward feeds; bf16 gradients through
# two layers of bf16 activations). Two planted attention faults on the
# CPU side (attention output zero; last key tile skipped) must fail it.
SLICE_LOSS_RTOL, SLICE_GNORM_RTOL, SLICE_ATTN_RTOL = 2e-4, 5e-3, 4e-2
ATTN_LEAVES = ("wq", "wk", "wv")
REPO = os.path.dirname(os.path.abspath(__file__))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float):
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / BF16_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def row_ratio(torch, got, want) -> float:
    """The worst row of ``got`` against ``want`` as a share of its limit
    (ROW_RTOL, ROW_FLOOR above); the check passes at <= 1, and a NaN
    fails it."""
    g, w = got.float(), want.float()
    ref = w.norm(dim=-1)
    lim = ROW_RTOL * ref + ROW_FLOOR * ref.square().mean().sqrt()
    return ((g - w).norm(dim=-1) / lim).max().item()


def check_close(torch, got, want, what: str):
    """Fail unless every row of ``got`` is within its limit of ``want``;
    returns (max abs error, worst row's share of its limit)."""
    ratio = row_ratio(torch, got, want)
    err = (got.float() - want.float()).abs().max().item()
    if not ratio <= 1.0:
        fail(f"{what}: worst row at {ratio:.3g} of its limit ({ROW_RTOL} * "
             f"|plain row| + {ROW_FLOOR} * rms); max abs err {err}")
    return err, ratio


# ---------------------------------------------------------------- phase 2
def decode_inputs(torch, kv_int8: bool, seed: int):
    """B = 8 rows at mixed lengths (one of length 1) over a shuffled pool
    of 1 + 8 * 128 pages, H = HK = 32, D = 128, page 16."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, HK, D, page, ppseq = 8, 32, 32, 128, 16, 128
    P = 1 + B * ppseq
    lens = torch.tensor([1, 2048, 1537, 700, 1024, 333, 2000, 64],
                        dtype=torch.int32, device="cuda")
    perm = torch.randperm(P - 1, generator=g, device="cuda") + 1
    bt = perm.reshape(B, ppseq).to(torch.int32)
    q = torch.randn((B, H, D), generator=g, device="cuda").bfloat16()
    shape = (P, page, HK, D)
    if kv_int8:
        kp = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        ks = torch.rand(shape[:3], generator=g, device="cuda") * 0.02 + 0.005
        vs = torch.rand(shape[:3], generator=g, device="cuda") * 0.02 + 0.005
    else:
        kp = torch.randn(shape, generator=g, device="cuda").bfloat16()
        vp = torch.randn(shape, generator=g, device="cuda").bfloat16()
        ks = vs = None
    return dict(q=q, k_pages=kp, v_pages=vp, block_tables=bt, lengths=lens,
                ks_pages=ks, vs_pages=vs)


def check_decode(torch, F, kernels, fused: bool, kv_int8: bool):
    from paddle_tpu_torch.models.llama import rope_tables
    pa, sf = kernels.paged_attention, kernels.serving_fused
    x = decode_inputs(torch, kv_int8, seed=11 if fused else 7)
    q, kp, vp, bt, lens = (x["q"], x["k_pages"], x["v_pages"],
                           x["block_tables"], x["lengths"])
    ks, vs = x["ks_pages"], x["vs_pages"]
    B, H, D = q.shape
    HK, page = kp.shape[2], kp.shape[1]
    kw = dict(ks_pages=ks, vs_pages=vs)
    if fused:
        cos, sin = rope_tables(2048, D, 10000.0, device="cuda")
        pos = (lens - 1).long()
        cos_row, sin_row = cos[pos], sin[pos]
        def kern():
            return sf.fused_paged_decode_attention(
                q, cos_row, sin_row, kp, vp, bt, lens, **kw)
        def plain():
            return sf.fused_paged_decode_plain(
                q, cos_row, sin_row, kp, vp, bt, lens, **kw)
        q_lib = sf.rotate_q_plain(q, cos_row, sin_row)
    else:
        def kern():
            return pa.paged_attention(q, kp, vp, bt, lens, **kw)
        def plain():
            return pa.paged_attention_plain(q, kp, vp, bt, lens, **kw)
        q_lib = q
    out_k = kern()
    torch.cuda.synchronize()
    out_p = plain()
    torch.cuda.synchronize()
    err, ratio = check_close(torch, out_k, out_p,
                             f"{'B10' if fused else 'B9'} kv_int8={kv_int8}")
    # library yardstick: SDPA over the cache gathered and dequantized
    # beforehand (outside the timed call)
    ck = pa.gather_pages(kp, bt)
    cv = pa.gather_pages(vp, bt)
    if kv_int8:
        ck = (ck.float() * pa.gather_pages(ks, bt)[..., None]).bfloat16()
        cv = (cv.float() * pa.gather_pages(vs, bt)[..., None]).bfloat16()
    K = ck.permute(0, 2, 1, 3).contiguous()
    V = cv.permute(0, 2, 1, 3).contiguous()
    S = K.shape[2]
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None].long())
    mask = mask[:, None, None, :]
    ql = q_lib[:, :, None, :]
    def lib():
        return F.scaled_dot_product_attention(ql, K, V, attn_mask=mask)
    ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain, reps=5, warmup=1)
    lib_ms = time_ms(torch, lib)
    n_tok = int(lens.sum().item())
    esz = 1 if kv_int8 else 2
    n_pages = int(((lens + page - 1) // page).sum().item())
    nbytes = (2 * B * H * D * 2                       # q in, out
              + 2 * n_tok * HK * D * esz              # live K and V rows
              + (2 * n_tok * HK * 4 if kv_int8 else 0)  # row scales
              + n_pages * 4 + B * 4                   # live table, lengths
              + (2 * B * (D // 2) * 4 if fused else 0))  # cos/sin rows
    flops = 4 * n_tok * H * D
    b_ms, b_by = bound_ms(nbytes, flops)
    return dict(max_abs_err=err, row_ratio=ratio, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def check_chunk(torch, F, kernels, kv_int8: bool, ctx_cap: int,
                ctx_len: int):
    """B11 at T = 256 against a (1, ctx_cap + 256) temp cache whose valid
    columns start at ctx_cap - ctx_len."""
    sf = kernels.serving_fused
    g = torch.Generator(device="cuda").manual_seed(100 + ctx_cap)
    B, T, H, HK, D = 1, 256, 32, 32, 128
    W = ctx_cap + T
    kstart = torch.tensor([ctx_cap - ctx_len], dtype=torch.int32,
                          device="cuda")
    q = torch.randn((B, T, H, D), generator=g, device="cuda").bfloat16()
    if kv_int8:
        ck = torch.randint(-127, 128, (B, W, HK, D), generator=g,
                           device="cuda", dtype=torch.int8)
        cv = torch.randint(-127, 128, (B, W, HK, D), generator=g,
                           device="cuda", dtype=torch.int8)
        kr = torch.rand((B, W, HK), generator=g, device="cuda") * 0.02 + 0.005
        vr = torch.rand((B, W, HK), generator=g, device="cuda") * 0.02 + 0.005
    else:
        ck = torch.randn((B, W, HK, D), generator=g, device="cuda").bfloat16()
        cv = torch.randn((B, W, HK, D), generator=g, device="cuda").bfloat16()
        kr = vr = None
    kw = dict(k_rows=kr, v_rows=vr)

    def kern():
        return sf.flash_chunk_attention(q, ck, cv, W, kstart, **kw)

    def plain():
        return sf.flash_chunk_attention_plain(q, ck, cv, W, kstart, **kw)

    out_k = kern()
    torch.cuda.synchronize()
    out_p = plain()
    torch.cuda.synchronize()
    err, ratio = check_close(torch, out_k, out_p,
                             f"B11 kv_int8={kv_int8} ctx_cap={ctx_cap}")
    if kv_int8:
        ckd = (ck.float() * kr[..., None]).bfloat16()
        cvd = (cv.float() * vr[..., None]).bfloat16()
    else:
        ckd, cvd = ck, cv
    K = ckd.permute(0, 2, 1, 3).contiguous()
    V = cvd.permute(0, 2, 1, 3).contiguous()
    Q = q.permute(0, 2, 1, 3).contiguous()
    kpos = torch.arange(W, device="cuda")[None, :]
    qpos = (W - T) + torch.arange(T, device="cuda")[:, None]
    mask = (kpos <= qpos) & (kpos >= int(kstart[0]))

    def lib():
        return F.scaled_dot_product_attention(Q, K, V, attn_mask=mask)

    ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain, reps=5, warmup=1)
    lib_ms = time_ms(torch, lib)
    ks0 = int(kstart[0])
    cols = W - ks0
    esz = 1 if kv_int8 else 2
    pairs = sum((W - T + t) - ks0 + 1 for t in range(T))
    nbytes = (2 * B * T * H * D * 2 + 2 * cols * HK * D * esz
              + (2 * cols * HK * 4 if kv_int8 else 0) + 4)
    flops = 4 * pairs * H * D
    b_ms, b_by = bound_ms(nbytes, flops)
    return dict(max_abs_err=err, row_ratio=ratio, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def flash_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the flash kernels compute: all, or under the
    top-left causal mask those with key <= query."""
    if not causal:
        return sq * sk
    n = min(sq, sk)
    return n * (n + 1) // 2 + max(0, sq - sk) * sk


def check_flash(torch, F, fa, B, sq, sk, H, HK, D, causal, seed, timed):
    """B1, B2 and B3 on one shape (bf16), each against its plain version
    in f32 on the same bf16 inputs: B1's O and lse; dQ, dK and dV from
    ``flash_attention(...).backward(dO)`` (the training path's autograd
    op, GQA group sums included) against the plain backward passes on
    B1's own lse and ``delta = rowsum(O * dO)`` of B1's own O, as the op
    gives them to B2 and B3. Then the planted fault: the plain versions
    without the last FAULT_TILE keys that some query sees must fail the
    same row checks, every output of them. With ``timed``, each kernel's
    time beside its plain version's, its bound, and SDPA's."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(s, h):
        return torch.randn((B, s, h, D), generator=g,
                           device="cuda").bfloat16()

    q, k, v, do = rand(sq, H), rand(sk, HK), rand(sk, HK), rand(sq, H)
    rep, scale = H // HK, D ** -0.5
    kr = torch.repeat_interleave(k, rep, dim=2)
    vr = torch.repeat_interleave(v, rep, dim=2)
    what = f"B{B} Sq{sq} Sk{sk} H{H} HK{HK} D{D} causal={causal}"
    out, lse = fa.flash_fwd(q, kr, vr, causal=causal, scale=scale)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o_op = fa.flash_attention(*leaves, causal=causal)
    o_op.backward(do)
    torch.cuda.synchronize()
    if not torch.equal(o_op.detach(), out):
        fail(f"B1 {what}: the autograd op's O is not flash_fwd's")
    got = {"O": out, "dQ": leaves[0].grad, "dK": leaves[1].grad,
           "dV": leaves[2].grad}
    del o_op, leaves
    delta = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    qf, kf, vf, dof = (t.float() for t in (q, kr, vr, do))

    def plain_over(keys: int):
        """O, lse, dQ, dK, dV of the plain versions over the first
        ``keys`` keys; dK and dV summed over each GQA group, zero past
        ``keys``."""
        kk, vk = kf[:, :keys], vf[:, :keys]
        o, l = fa.flash_attention_plain(qf, kk, vk, causal, scale)
        dk, dv = fa.flash_bwd_dkv_plain(qf, kk, vk, dof, lse, delta, causal,
                                        scale)
        dq = fa.flash_bwd_dq_plain(qf, kk, vk, dof, lse, delta, causal, scale)

        def group(t):
            t = F.pad(t, (0, 0, 0, 0, 0, sk - keys))
            return t.reshape(B, sk, HK, rep, D).sum(3)

        return {"O": o, "dQ": dq, "dK": group(dk), "dV": group(dv)}, l

    want, want_lse = plain_over(sk)
    errs, ratios = {}, {}
    for n in got:
        errs[n], ratios[n] = check_close(torch, got[n], want[n],
                                         f"{n} {what}")
    lse_err = (lse - want_lse).abs().max().item()
    if not lse_err <= LSE_ATOL:
        fail(f"B1 lse {what}: max abs err {lse_err} > {LSE_ATOL}")
    del want, want_lse
    seen = min(sq, sk) if causal else sk
    fault, _ = plain_over(seen - FAULT_TILE)
    fault_ratios = {n: row_ratio(torch, got[n], fault[n]) for n in got}
    del fault, qf, kf, vf, dof
    for n, r in fault_ratios.items():
        if not r > 1.0:
            fail(f"{n} {what}: the check passes the plain version without "
                 f"its last {FAULT_TILE} seen keys (worst row at {r:.3g} of "
                 f"its limit)")
    by_kernel = {"B1": ("O",), "B2": ("dK", "dV"), "B3": ("dQ",)}
    rec = {"shape": what, "max_abs_err": errs, "row_ratio": ratios,
           "fault_row_ratio": fault_ratios, "lse_err": lse_err,
           "kernel_err": {b: max(errs[n] for n in ns)
                          for b, ns in by_kernel.items()},
           "kernel_row_ratio": {b: max(ratios[n] for n in ns)
                                for b, ns in by_kernel.items()}}
    if not timed:
        return rec
    kw = dict(causal=causal, scale=scale)
    args = (q, kr, vr, do, lse, delta)
    ms = {"B1": time_ms(torch, lambda: fa.flash_fwd(q, kr, vr, **kw)),
          "B2": time_ms(torch, lambda: fa.flash_bwd_dkv(*args, **kw)),
          "B3": time_ms(torch, lambda: fa.flash_bwd_dq(*args, **kw))}
    plain = {
        "B1": time_ms(torch, lambda: fa.flash_attention_plain(
            q, kr, vr, causal, scale), reps=3, warmup=1),
        "B2": time_ms(torch, lambda: fa.flash_bwd_dkv_plain(
            *args, causal, scale), reps=3, warmup=1),
        "B3": time_ms(torch, lambda: fa.flash_bwd_dq_plain(
            *args, causal, scale), reps=3, warmup=1)}
    Q, K, V, dO = (t.transpose(1, 2).contiguous() for t in (q, kr, vr, do))
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        Q, K, V, is_causal=causal))
    Ql, Kl, Vl = (t.requires_grad_() for t in (Q, K, V))

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(Ql, Kl, Vl, is_causal=causal)
        return torch.autograd.grad(o, (Ql, Kl, Vl), dO)

    lib_fb = time_ms(torch, lib_fwd_bwd)
    pairs = B * H * flash_pairs(sq, sk, causal)
    qbytes, kbytes = B * sq * H * D * 2, B * sk * H * D * 2
    rows = B * H * sq * 4                             # one f32 per row
    work = {  # bytes (each input read once, each output written once), flops
        "B1": (2 * qbytes + 2 * kbytes + rows, 4 * D * pairs),
        "B2": (2 * qbytes + 4 * kbytes + 2 * rows, 8 * D * pairs),
        "B3": (3 * qbytes + 2 * kbytes + 2 * rows, 6 * D * pairs)}
    for name in ("B1", "B2", "B3"):
        b_ms, b_by = bound_ms(*work[name])
        rec[name] = dict(ms=ms[name],
                         plain_ms=plain[name], bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_fwd if name == "B1" else None)
    rec["sdpa_fwd_ms"], rec["sdpa_fwd_bwd_ms"] = lib_fwd, lib_fb
    return rec


# ---------------------------------------------------------------- phase 3
def make_requests(n: int, vocab: int, seed: int):
    """Prompts of 128..1024 tokens and 32..128 new tokens; every fourth
    request opens with one shared 200-token system prompt."""
    import numpy as np
    rs = np.random.RandomState(seed)
    system = rs.randint(3, vocab, (200,)).astype(np.int32)
    reqs = []
    for i in range(n):
        plen = int(rs.randint(128, 1025))
        p = rs.randint(3, vocab, (plen,)).astype(np.int32)
        if i % 4 == 0:
            p[:200] = system
        reqs.append((p, int(rs.randint(32, 129))))
    return reqs


def chunked_prefill(torch, gen, eng, slot, seq, fused):
    """Prefill ``seq`` into ``slot``'s pages in the engine's chunk
    widths and context buckets; returns the last chunk's logits."""
    cache = eng.cache
    page = cache.page_size
    bt = cache.block_table_tensor(slot)
    done, logits = 0, None
    while done < seq.size:
        width = min(cache.pages_for(seq.size - done) * page,
                    eng.prefill_chunk)
        take = min(seq.size - done, width)
        ctx_cap = cache.ctx_cap_pages(cache.pages_for(done)) * page
        chunk = torch.zeros((1, width), dtype=torch.int32)
        chunk[0, :take] = torch.from_numpy(seq[done:done + take])
        logits, _ = gen.paged_prefill_chunk(
            eng.params, chunk.cuda(), cache.pool, bt, eng.cfg,
            ctx_cap=ctx_cap, ctx_len=done, chunk_len=take, fused=fused)
        done += take
    return logits


def consistency(torch, gen, eng, req):
    """Decode-step logits through the tier's kernels vs the kernel-free
    prefill (``fused=False``) of the same sequence."""
    import numpy as np
    cache = eng.cache
    seq = np.concatenate([req.prompt[0],
                          np.asarray(req.tokens[:-1], np.int32)])
    n = seq.size
    cache.admit(0, n + 1)
    chunked_prefill(torch, gen, eng, 0, seq[:-1], eng.fused)
    lengths = torch.zeros(eng.max_batch, dtype=torch.int32)
    lengths[0] = n - 1
    last = torch.zeros(eng.max_batch, dtype=torch.int32)
    last[0] = int(seq[-1])
    active = torch.zeros(eng.max_batch, dtype=torch.bool)
    active[0] = True
    dec, _ = gen.paged_decode_forward(
        eng.params, last.cuda(), cache.pool, cache.block_table_tensor(),
        lengths.cuda(), eng.cfg, active=active.cuda(), fused=eng.fused)
    cache.admit(1, n)
    ref = chunked_prefill(torch, gen, eng, 1, seq, False)
    cache.release(0)
    cache.release(1)
    d, r = dec[0].float(), ref[0].float()
    err = (d - r).abs().max().item()
    return dict(logits_max_abs_err=err,
                logits_max_abs=r.abs().max().item(),
                argmax_equal=bool(int(d.argmax()) == int(r.argmax())),
                argmax_is_last_token=bool(int(d.argmax()) == req.tokens[-1]))


def run_tier(torch, kernels, gen, Engine, params, cfg, reqs, kv, fused):
    eng = Engine(params, cfg, max_batch=8, page_size=16, max_len=2048,
                 kv_cache_dtype=kv, prefill_chunk=256, fused=fused)
    handles = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
    dec_ms, pre_ms = [], []
    orig_decode, orig_prefill = eng.decode_step, eng.prefill_step

    def timed(fn, sink):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = fn(*a, **k)
            torch.cuda.synchronize()
            if n:
                sink.append((time.perf_counter() - t0) * 1e3)
            return n
        return wrapper

    eng.decode_step = timed(orig_decode, dec_ms)
    eng.prefill_step = timed(orig_prefill, pre_ms)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    del eng.decode_step, eng.prefill_step   # back to the class methods
    for h, (p, m) in zip(handles, reqs):
        if not h.done or len(h.tokens) != m or h.finish_reason != "max_len":
            fail(f"tier kv={kv} fused={fused}: request {h.rid} finished "
                 f"{h.finish_reason} with {len(h.tokens)}/{m} tokens")
    st = eng.stats()
    L = cfg.num_layers
    want = {**dict.fromkeys(kernels.WRAPPERS, 0),
            "B9": 0 if fused else st["steps"] * L,
            "B10": st["steps"] * L if fused else 0,
            "B11": st["prefill_chunks"] * L if fused else 0}
    if counts != want:
        fail(f"tier kv={kv} fused={fused}: launches {counts} != {want}")
    eng.cache.prefix.drop_all(eng.cache.allocator)
    alloc = eng.cache.allocator
    if alloc.num_used or alloc.allocs_total != alloc.frees_total:
        fail(f"tier kv={kv} fused={fused}: pages leaked "
             f"({alloc.stats()})")
    cons = consistency(torch, gen, eng, handles[0])
    if not (cons["logits_max_abs_err"] <= LOGITS_ATOL):
        fail(f"tier kv={kv} fused={fused}: decode logits vs kernel-free "
             f"prefill {cons}")
    gen_tokens = sum(len(h.tokens) for h in handles)
    rec = dict(kv=kv or "bf16", fused=fused, requests=len(handles),
               generated_tokens=gen_tokens, wall_s=wall,
               tokens_per_s=gen_tokens / wall,
               decode_steps=st["steps"], prefill_chunks=st["prefill_chunks"],
               decode_step_ms_mean=sum(dec_ms) / max(1, len(dec_ms)),
               decode_step_ms_median=sorted(dec_ms)[len(dec_ms) // 2]
               if dec_ms else None,
               prefill_chunk_ms_mean=sum(pre_ms) / max(1, len(pre_ms)),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
               launches=counts, cow_copies=st["cow_copies"],
               shares_total=st["shares_total"], **cons)
    del eng, handles
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def device_breakdown(torch, prof, calls: int, wall_ms: float):
    """Split the card's kernel time in ``prof`` by kind, per call, against
    the host's wall time per call. Only the card's own events are summed:
    a CPU operator's self device time repeats the time of the kernels it
    launched."""
    from torch.autograd import DeviceType
    kinds = {"attention kernel": 0.0, "gemm": 0.0, "other": 0.0}
    top = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or not ev.self_device_time_total:
            continue
        us = ev.self_device_time_total
        top.append((us, ev.count, ev.key))
        key = ev.key.lower()
        if "paged_decode" in key or "flash_" in key:
            kinds["attention kernel"] += us
        elif any(w in key for w in ("gemm", "gemv", "nvjet", "xmma",
                                    "cutlass", "splitk")):
            kinds["gemm"] += us
        else:
            kinds["other"] += us
    busy = sum(kinds.values()) / 1e3 / calls
    if busy == 0.0:
        return {"device_time": "not measured (profiler saw no kernels)",
                "wall_ms_per_call": wall_ms}
    return {"wall_ms_per_call": wall_ms, "device_busy_ms_per_call": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "device_ms_per_call_by_kind": {k: v / 1e3 / calls
                                           for k, v in kinds.items()},
            "top_kernels": [
                {"name": name[:90], "ms_per_call": us / 1e3 / calls,
                 "launches_per_call": n / calls}
                for us, n, name in sorted(top, reverse=True)[:12]]}


def profile_tier(torch, Engine, params, cfg, reqs, chunks: int = 4,
                 steps: int = 8):
    """Where the time goes in the bf16 KV, fused tier (kernels B10 and
    B11): admit 8 requests, trace ``chunks`` prefill chunks, finish the
    prefills, then trace ``steps`` decode steps of all 8 rows, each with
    ``torch.profiler``. Launches made here are not counted on the main
    path."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    eng = Engine(params, cfg, max_batch=8, page_size=16, max_len=2048,
                 prefill_chunk=256, fused=True)
    for p, _ in reqs[:8]:
        eng.submit(p, max_new_tokens=128)
    eng._admit()
    eng.prefill_step()                     # warm
    torch.cuda.synchronize()
    widths = []
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            widths.append(eng.prefill_step())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / chunks
    prefill = device_breakdown(torch, prof, chunks, wall)
    prefill["chunk_widths"] = widths
    while eng._pending:
        eng.prefill_step()
    mask = eng.ready_mask()
    eng.decode_step(mask)                  # warm
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.decode_step(mask)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    decode = device_breakdown(torch, prof, steps, wall)
    lengths = eng.cache.lengths[mask]
    decode.update(rows=int(mask.sum()),
                  mean_length=float(lengths.mean()))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"tier": "bf16 KV, fused", "prefill_chunk": prefill,
            "decode_step": decode}


# --------------------------------------------------------------- phase 3b
def train_config(LlamaConfig, layers: int):
    """The JAX bench's training model (``bench.py`` ``pick_config`` for a
    TPU): bf16, remat with policy "nothing"."""
    return LlamaConfig(vocab_size=32000, hidden_size=1536,
                       intermediate_size=4096, num_layers=layers,
                       num_heads=12, num_kv_heads=12, max_seq_len=4096)


def run_training(torch, np, kernels, tl, tt, args):
    """2 warm-up and ``args.train_steps`` timed steps on one batch; the
    launch counters are zeroed just before the timed steps and read just
    after."""
    cfg = train_config(tl.LlamaConfig, args.train_layers)
    seq, batch = 4096, 4               # bench.py's _SWEEP_BASE_BATCH
    t0 = time.perf_counter()
    state = tt.init_train_state(cfg, torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)), dtype=torch.int32, device="cuda")
    step = tt.make_train_step(cfg, seq_chunk=512)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    metrics = []
    for _ in range(2):
        state, m = step(state, tokens)
        metrics.append(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    step_ms = []
    t0 = time.perf_counter()
    for _ in range(args.train_steps):
        ts = time.perf_counter()
        state, m = step(state, tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        metrics.append(m)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"].item() for m in metrics]
    gnorms = [m["grad_norm"].item() for m in metrics]
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"training: non-finite loss or grad norm {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        fail(f"training: the loss did not fall: {losses}")
    L, n = cfg.num_layers, args.train_steps
    want = {**dict.fromkeys(kernels.WRAPPERS, 0),
            "B1": 2 * L * n, "B2": L * n, "B3": L * n}
    if counts != want:
        fail(f"training: launches {counts} != {want} (B1 runs twice per "
             f"layer: backward recomputes the checkpointed layer)")
    tps = n * batch * seq / wall
    rec = dict(layers=L, batch=batch, seq=seq, seq_chunk=512,
               params=cfg.num_params(), init_s=init_s,
               tokens_per_s=tps, step_ms=step_ms,
               step_ms_mean=sum(step_ms) / n,
               mfu=tps * cfg.flops_per_token(seq) / BF16_FLOPS_PER_S,
               peak_mem_gb=peak, losses=losses, grad_norms=gnorms,
               launches=counts)
    return rec, step, state, tokens


def attn_grads(torch, tl, params, tokens, cfg):
    """``loss_fn`` and its gradients of the ATTN_LEAVES, as f32 on the
    CPU (each a (layers, in, out) stack)."""
    ws = [params["layers"][n] for n in ATTN_LEAVES]
    for w in ws:
        w.requires_grad_(True)
    try:
        loss = tl.loss_fn(params, tokens, cfg, seq_chunk=512)
        grads = torch.autograd.grad(loss, ws, materialize_grads=True)
    finally:
        for w in ws:
            w.requires_grad_(False)
    return loss.item(), [g.float().cpu() for g in grads]


def slice_errors(torch, card, ref):
    """Relative errors of (loss, grads) ``card`` against ``ref``: the
    loss, and each ATTN_LEAVES gradient per layer (Frobenius norm of the
    difference over the larger of the two norms)."""
    errs = {"loss": abs(card[0] - ref[0]) / abs(ref[0])}
    for n, a, b in zip(ATTN_LEAVES, card[1], ref[1]):
        errs[n] = [((x - y).norm() / torch.maximum(x.norm(), y.norm())).item()
                   for x, y in zip(a, b)]
    return errs


def slice_failures(errs) -> list:
    """The entries of ``errs`` over their SLICE_* limits (NaN is over)."""
    lim = {"loss": SLICE_LOSS_RTOL, "grad_norm": SLICE_GNORM_RTOL,
           **dict.fromkeys(ATTN_LEAVES, SLICE_ATTN_RTOL)}
    return [k for k, e in errs.items()
            if not max(e if isinstance(e, list) else [e]) <= lim[k]]


def whole_slice(torch, np, tl, tt, fa, seed: int):
    """A 2-layer model at full width, B = 1, S = 1024: bf16 with the
    kernels on the card, and from the same parameters in f32 on the CPU
    with the plain versions. Compares ``loss_fn``'s wq, wk, wv gradients,
    then one ``make_train_step`` step's loss and grad norm. Controls: the
    CPU side with two planted attention faults must fail the same
    limits."""
    import dataclasses
    cfg = train_config(tl.LlamaConfig, 2)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 1024)), dtype=torch.int32)
    card = tt.init_train_state(cfg, torch.Generator(
        device="cuda").manual_seed(seed + 1), device="cuda")

    def f32_cpu(tree):
        return {k: f32_cpu(v) if isinstance(v, dict) else v.float().cpu()
                for k, v in tree.items()}

    cpu = tt.TrainState(0, *(f32_cpu(t) for t in (
        card.params, card.master, card.m, card.v)))
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    t0 = time.perf_counter()
    on_card = attn_grads(torch, tl, card.params, tokens.cuda(), cfg)
    on_cpu = attn_grads(torch, tl, cpu.params, tokens, cpu_cfg)
    cpu_s = time.perf_counter() - t0
    errs = slice_errors(torch, on_card, on_cpu)

    def skip_last_tile(q, k, v, causal=True):
        return fa.flash_attention_plain(q, k[:, :-FAULT_TILE],
                                        v[:, :-FAULT_TILE], causal)[0]

    controls = {}
    model_attention = tl._attention
    for name, fault in (("attention output zero",
                         lambda q, k, v, causal=True: q * 0.0),
                        (f"last {FAULT_TILE} keys skipped", skip_last_tile)):
        tl._attention = fault        # the CPU reference's einsum path
        try:
            faulty = attn_grads(torch, tl, cpu.params, tokens, cpu_cfg)
        finally:
            tl._attention = model_attention
        controls[name] = slice_errors(torch, on_card, faulty)
        if not slice_failures(controls[name]):
            fail(f"whole slice: the check passes the CPU reference with its "
                 f"{name} ({controls[name]})")
    # the step's loss is loss_fn's above; its grad norm covers every leaf
    _, mc = tt.make_train_step(cfg, seq_chunk=512)(card, tokens.cuda())
    _, mh = tt.make_train_step(cpu_cfg, seq_chunk=512)(cpu, tokens)
    rec = {k: {"card_bf16": mc[k].item(), "cpu_f32": mh[k].item()}
           for k in ("loss", "grad_norm")}
    a, b = rec["grad_norm"]["card_bf16"], rec["grad_norm"]["cpu_f32"]
    errs["grad_norm"] = abs(a - b) / abs(b)
    bad = slice_failures(errs)
    if bad:
        fail(f"whole slice: {bad} over their limits: {errs}")
    rec.update(rel_err=errs, controls=controls, cpu_grads_s=cpu_s)
    return rec


def profile_train(torch, step, state, tokens, step_ms: float):
    """``torch.profiler`` over one training step; the idle share is taken
    against the unprofiled step time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, tokens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rec = device_breakdown(torch, prof, 1, step_ms)
    rec["profiled_wall_ms"] = wall
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="engine depth (Llama-2-7B has 32)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--train-layers", type=int, default=20,
                    help="training model depth (the JAX bench's has 20)")
    ap.add_argument("--train-steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script runs on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import torch.nn.functional as F
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import generate as gen
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.models import train as tt
    from paddle_tpu_torch.models.llama import LlamaConfig, init_params
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    record = {"card": card, "kind": kind}

    # ---- phase 1: build
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s ({built})")
    for name in _build.SOURCES:
        log = _build.log_path(name)
        if log.exists():
            for line in log.read_text(errors="replace").splitlines():
                if ("registers" in line or "spill" in line
                        or "entry function" in line):
                    print(f"  ptxas {name}: {line.strip()}")
    record["build_s"] = build_s

    # ---- phase 2: kernels vs plain
    results = {}
    for fused, name in ((False, "B9"), (True, "B10")):
        for kv_int8 in (False, True):
            r = check_decode(torch, F, kernels, fused, kv_int8)
            torch.cuda.synchronize()
            key = f"{name}-{'int8' if kv_int8 else 'bf16'}"
            results[key] = r
            print(f"kernel {key}: " + json.dumps(r))
    for kv_int8 in (False, True):
        worst, worst_ratio = 0.0, 0.0
        key = f"B11-{'int8' if kv_int8 else 'bf16'}"
        for ctx_cap, ctx_len in ((0, 0), (256, 200), (1024, 1000),
                                 (2048, 1900)):
            r = check_chunk(torch, F, kernels, kv_int8, ctx_cap, ctx_len)
            torch.cuda.synchronize()
            worst = max(worst, r["max_abs_err"])
            worst_ratio = max(worst_ratio, r["row_ratio"])
            print(f"kernel {key} ctx_cap={ctx_cap}: " + json.dumps(r))
            if ctx_cap == 1024:
                results[key] = r
        results[key].update(max_abs_err=worst, row_ratio=worst_ratio)
    flash = [check_flash(torch, F, fa, 4, 4096, 4096, 12, 12, 128, True,
                         seed=21, timed=True)]
    for B, sq, sk, H, HK, D, causal in ((2, 320, 320, 4, 4, 128, True),
                                        (2, 320, 320, 4, 4, 128, False),
                                        (2, 192, 320, 4, 4, 128, True),
                                        (2, 320, 192, 4, 4, 128, True),
                                        (2, 320, 320, 4, 2, 64, True),
                                        (2, 192, 320, 4, 2, 64, False)):
        flash.append(check_flash(torch, F, fa, B, sq, sk, H, HK, D, causal,
                                 seed=22, timed=False))
    for rec in flash:
        print("kernel flash " + json.dumps(rec))
    for name in ("B1", "B2", "B3"):
        results[name] = dict(
            flash[0][name],
            max_abs_err=max(r["kernel_err"][name] for r in flash),
            row_ratio=max(r["kernel_row_ratio"][name] for r in flash))
    gc.collect()
    torch.cuda.empty_cache()
    record["kernels_phase"] = results
    record["flash_phase"] = flash

    # ---- phase 3: the engine
    cfg = LlamaConfig.llama2_7b(num_layers=args.layers)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        args.seed), device="cuda")
    torch.cuda.synchronize()
    print(f"params: {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
          f"{time.perf_counter() - t0:.1f} s to init")
    reqs = make_requests(args.requests, cfg.vocab_size, args.seed)
    tiers = []
    for kv in (None, "int8"):
        for fused in (False, True):
            rec = run_tier(torch, kernels, gen, ContinuousBatchingEngine,
                           params, cfg, reqs, kv, fused)
            tiers.append(rec)
            print("tier " + json.dumps(rec))
    record["tiers"] = tiers
    prof = profile_tier(torch, ContinuousBatchingEngine, params, cfg, reqs)
    print("profile " + json.dumps(prof))
    record["profile"] = prof
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 3b: training
    train, step, state, tokens = run_training(torch, np, kernels, tl, tt,
                                              args)
    print("train " + json.dumps(train))
    tprof = profile_train(torch, step, state, tokens, train["step_ms_mean"])
    print("train profile " + json.dumps(tprof))
    del step, state, tokens
    gc.collect()
    torch.cuda.empty_cache()
    train["slice_check"] = whole_slice(torch, np, tl, tt, fa, args.seed)
    print("train slice " + json.dumps(train["slice_check"]))
    train["profile"] = tprof
    record["train"] = train

    # ---- phase 4: the kernel line
    launches = {k: train["launches"][k] for k in ("B1", "B2", "B3")}
    for rec in tiers:
        kvn = rec["kv"]
        for k, n in rec["launches"].items():
            if n:
                launches[f"{k}-{kvn}"] = launches.get(f"{k}-{kvn}", 0) + n
    flash_src = "paddle_tpu_torch/csrc/flash_attention.cu"
    meta = {
        "B1": ("cuda", flash_src,
               "paddle_tpu/ops/pallas/flash_attention.py:184"),
        "B2": ("cuda", flash_src,
               "paddle_tpu/ops/pallas/flash_attention.py:343"),
        "B3": ("cuda", flash_src,
               "paddle_tpu/ops/pallas/flash_attention.py:370"),
        "B9": ("cuda", "paddle_tpu_torch/csrc/paged_decode.cu",
               "paddle_tpu/ops/pallas/paged_attention.py:163"),
        "B10": ("cuda", "paddle_tpu_torch/csrc/paged_decode.cu",
                "paddle_tpu/ops/pallas/serving_fused.py:156"),
        "B11": ("cuda", "paddle_tpu_torch/csrc/flash_chunk.cu",
                "paddle_tpu/ops/pallas/serving_fused.py:453"),
    }
    line = []
    for key, r in results.items():
        kname = key.split("-")[0]
        route, src, repl = meta[kname]
        n = launches.get(key, 0)
        if n == 0:
            fail(f"{key} was not launched on the main path")
        line.append({"name": key, "route": route, "source": src,
                     "replaces": repl, "launches": n,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    record["kernel_line"] = line
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": line}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
