#!/usr/bin/env python3
"""Time the flash-attention kernels B1, B2 and B3, the flash chunk kernel
B11, the decode kernel B7 (contiguous cache) and the paged decode kernels
B8 (head-major pool), B9 and B10 (token-major pool; B10 with q's RoPE)
of the port in a given checkout, on one CUDA card; or, with
``--engine``, the card time of the paged engine's decode step; or, with
``--dense``, that of dense decoding's long tier.

    python3 compare_flash.py PATH [PATH ...]
    python3 compare_flash.py --engine PATH [PATH ...]
    python3 compare_flash.py --dense PATH [PATH ...]

Each PATH is the root of a checkout of this repository (``.`` for this
one; an older commit unpacked with ``git archive`` for a comparison).
Every checkout runs in its own process, in the order given, so a
comparison should list them in turns (old, new, new, old) to show the
card's drift. Shapes: B1-B3 at the training step's (B = 4, S = 4096,
H = 12, D = 128, causal, bf16) and its D = 64 twin (H = 24), beside
SDPA's forward; B11 at ``chip_smoke.py`` phase 2's shapes (D = 128,
H = 32, bf16 and int8 KV): the prefill chunk T = 256 at ctx_cap 0, 256,
1024 and 2048 (B = 1), the linear verify T = 5 at ctx_cap 1024 and 2048
and the (2, 4) comb tree T = 9 at 2048 (B = 8 ragged rows), and under
GQA (HK = 8) T = 256 and T = 5 at 2048; B8 at ``chip_smoke.py`` phase
2's shapes (H = 32, D = 128, pages of 64, bf16 and int8 KV with (B, HK)
scales): at HK = 32 the ragged rows of lengths 1 ... 2048 in a 32-page
table, the Paddle decoder's 8 equal rows of 1,056 tokens in 17 pages and
one row of 4,096 tokens in 64, and the ragged rows under GQA (HK = 8);
B9 and B10 at ``chip_smoke.py`` phase 2's (H = 32, D = 128, pages of
16, bf16 and int8 KV with per-token scales): the ragged rows in 128-page
tables at HK = 32 and under GQA (HK = 8), and one row of 4,096 tokens;
B7 at ``chip_smoke.py`` phase 2's shapes (D = 128, layer 1 of a
two-layer dense cache, bf16 and int8 KV with per-token scales): the
ragged rows at H = HK = 32 and S = 2048, the JAX bench model's 8 rows
at H = HK = 12 and S = 192, one row of 4,096 tokens, the ragged rows
under GQA (HK = 8), and dense decoding's long tier (8 rows of 1,984
tokens, the middle of its decode steps, S = 2048). Times are CUDA events
over 20 launches after 3 warm-up launches; one JSON line per checkout,
``compare {...}``.

``--engine`` runs the checkout's own ``chip_smoke.profile_tier`` (the
bf16 KV, fused tier of the engine at Llama-2-7B width, 32 layers, seeded
random weights: ``torch.profiler`` over 4 prefill chunks and 8 decode
steps of 8 rows) and prints its record, ``engine {...}``: card busy and
host wall ms a step, by kind. ``--dense`` runs the checkout's own
``chip_smoke.profile_dense`` at dense decoding's long tier (Llama-2-7B
width, 32 layers, seeded random bf16 weights, 8 prompts of 1,920
tokens: ``torch.profiler`` over 8 decode steps) and prints its record,
``dense {...}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

SLEEP_CYCLES = 20_000_000      # ~10 ms of the card's clock (time_ms)
SHAPES = ((4, 4096, 12, 128), (4, 4096, 24, 64))
# B11: (name, B, T, HK, ctx_cap, context length of row 0, tree)
B11_SHAPES = tuple(
    (f"T{T}-ctx{cap}{'-tree' if tree else ''}{'-gqa' if hk == 8 else ''}",
     b, T, hk, cap, n, tree)
    for b, T, hk, cap, n, tree in (
        (1, 256, 32, 0, 0, False), (1, 256, 32, 256, 200, False),
        (1, 256, 32, 1024, 1000, False), (1, 256, 32, 2048, 1900, False),
        (8, 5, 32, 1024, 1024, False), (8, 5, 32, 2048, 2048, False),
        (8, 9, 32, 2048, 2048, True), (1, 256, 8, 2048, 1900, False),
        (8, 5, 8, 2048, 2048, False)))
# B8: (name, row lengths, table pages a row, kv heads)
RAGGED = (1, 2048, 1537, 700, 1024, 333, 2000, 64)
B8_SHAPES = (("ragged", RAGGED, 32, 32), ("decoder", (1056,) * 8, 17, 32),
             ("single", (4096,), 64, 32), ("gqa", RAGGED, 32, 8))
# B9/B10: (name, row lengths, table pages a row, kv heads)
B9_SHAPES = (("ragged", RAGGED, 128, 32), ("single", (4096,), 256, 32),
             ("gqa", RAGGED, 128, 8))
# B7: (name, row lengths, capacity S, query heads, kv heads)
B7_SHAPES = (("ragged", RAGGED, 2048, 32, 32),
             ("bench", (1, 192, 150, 129, 64, 100, 191, 17), 192, 12, 12),
             ("single", (4096,), 4096, 32, 32),
             ("gqa", RAGGED, 2048, 32, 8),
             ("long", (1984,) * 8, 2048, 32, 32))


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Card ms of one ``fn()``: CUDA events around ``reps`` calls, queued
    behind a sleep kernel of ~10 ms, so that the host has queued every
    call before the first starts and the events time the card, not the
    host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chunk_inputs(torch, B, T, HK, ctx_cap, n0, tree, kv_int8, seed):
    """A B11 call's arguments as ``chip_smoke.py`` phase 2 builds them: q
    (B, T, 32, 128) bf16, a (B, ctx_cap + T, HK, 128) cache (int8 with
    row scales), rows' context lengths n0 (B = 1) or chip_smoke's eight
    ragged ones down to 1, and for a tree the (2, 4) comb's ancestor
    matrix."""
    import numpy as np
    from paddle_tpu_torch.serving import build_comb_tree, \
        tree_ancestor_matrix
    g = torch.Generator(device="cuda").manual_seed(seed)
    H, D, W = 32, 128, ctx_cap + T
    lens = ([n0] if B == 1 else
            [ctx_cap, int(0.93 * ctx_cap), int(0.75 * ctx_cap),
             ctx_cap // 2, int(0.34 * ctx_cap), int(0.16 * ctx_cap), 16, 1])
    kstart = torch.tensor([ctx_cap - n for n in lens], dtype=torch.int32,
                          device="cuda")
    q = torch.randn((B, T, H, D), generator=g, device="cuda").bfloat16()
    kw = {}
    if kv_int8:
        ck, cv = (torch.randint(-127, 128, (B, W, HK, D), generator=g,
                                device="cuda", dtype=torch.int8)
                  for _ in range(2))
        kw["k_rows"], kw["v_rows"] = (
            torch.rand((B, W, HK), generator=g, device="cuda") * 0.02 + 0.005
            for _ in range(2))
    else:
        ck, cv = (torch.randn((B, W, HK, D), generator=g,
                              device="cuda").bfloat16() for _ in range(2))
    if tree:
        depth = (T - 1) // 2
        t = build_comb_tree(0, np.arange(1, depth + 1),
                            [np.arange(1) + 100 * (d + 1)
                             for d in range(depth)])
        kw["tree_mask"] = torch.from_numpy(tree_ancestor_matrix(
            t.parents)).cuda().expand(B, T, T).contiguous()
    return (q, ck, cv, W, kstart), kw


def paged_inputs(torch, lens, pps, HK, kv_int8, seed):
    """A B8 call's arguments: q (B, 32, 128) bf16, head-major (P, HK, 64,
    128) pools (int8 with (B, HK) scales), a shuffled block table with -1
    past each row's pages, the row lengths."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, D, page = len(lens), 32, 128, 64
    P = 1 + B * pps
    bt = (torch.randperm(P - 1, generator=g, device="cuda") + 1).reshape(
        B, pps).to(torch.int32)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    live = (ln.long() + page - 1) // page
    bt[torch.arange(pps, device="cuda")[None, :] >= live[:, None]] = -1
    q = torch.randn((B, H, D), generator=g, device="cuda").bfloat16()
    kw = {}
    if kv_int8:
        kp, vp = (torch.randint(-127, 128, (P, HK, page, D), generator=g,
                                device="cuda", dtype=torch.int8)
                  for _ in range(2))
        kw["k_dequant_scale"], kw["v_dequant_scale"] = (
            torch.rand((B, HK), generator=g, device="cuda") * 0.02 + 0.005
            for _ in range(2))
    else:
        kp, vp = (torch.randn((P, HK, page, D), generator=g,
                              device="cuda").bfloat16() for _ in range(2))
    return (q, kp, vp, bt, ln), kw


def token_major_inputs(torch, lens, pps, HK, kv_int8, seed):
    """A B9/B10 call's arguments: q (B, 32, 128) bf16, token-major (P,
    16, HK, 128) pools (int8 with per-token scales), a shuffled block
    table with -1 past each row's pages, the row lengths, and the cos/sin
    rows at each row's position."""
    from paddle_tpu_torch.models.llama import rope_tables
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, D, page = len(lens), 32, 128, 16
    P = 1 + B * pps
    bt = (torch.randperm(P - 1, generator=g, device="cuda") + 1).reshape(
        B, pps).to(torch.int32)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    live = (ln.long() + page - 1) // page
    bt[torch.arange(pps, device="cuda")[None, :] >= live[:, None]] = -1
    q = torch.randn((B, H, D), generator=g, device="cuda").bfloat16()
    kw = {}
    if kv_int8:
        kp, vp = (torch.randint(-127, 128, (P, page, HK, D), generator=g,
                                device="cuda", dtype=torch.int8)
                  for _ in range(2))
        kw["ks_pages"], kw["vs_pages"] = (
            torch.rand((P, page, HK), generator=g, device="cuda") * 0.02
            + 0.005 for _ in range(2))
    else:
        kp, vp = (torch.randn((P, page, HK, D), generator=g,
                              device="cuda").bfloat16() for _ in range(2))
    cos, sin = rope_tables(pps * page, D, 10000.0, device="cuda")
    pos = (ln - 1).long()
    return (q, kp, vp, bt, ln), (cos[pos], sin[pos]), kw


def dense_inputs(torch, lens, S, H, HK, kv_int8, seed):
    """A B7 call's arguments: q (B, H, 128) bf16, layer 1 of a two-layer
    (2, B, S, HK, 128) cache (int8 with (B, S, HK) per-token scales), the
    row lengths."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, D = len(lens), 128
    shape = (2, B, S, HK, D)
    q = torch.randn((B, H, D), generator=g, device="cuda").bfloat16()
    kw = {}
    if kv_int8:
        ck, cv = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                                dtype=torch.int8)[1] for _ in range(2))
        kw["k_rows"], kw["v_rows"] = (
            torch.rand(shape[:4], generator=g, device="cuda")[1] * 0.02
            + 0.005 for _ in range(2))
    else:
        ck, cv = (torch.randn(shape, generator=g, device="cuda").bfloat16()[1]
                  for _ in range(2))
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return (q, ck, cv, ln), kw


def measure_dense(root: str) -> dict:
    """``profile_dense`` of the checkout at ``root`` at dense decoding's
    long tier (imported from there; call once per process)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    import chip_smoke
    from paddle_tpu_torch.models import generate as gen
    from paddle_tpu_torch.models import llama as tl

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tl.LlamaConfig.llama2_7b(num_layers=32)
    params = tl.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), device="cuda")
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        3, cfg.vocab_size, (8, 1920)), dtype=torch.int32, device="cuda")
    rec = chip_smoke.profile_dense(torch, tl, gen, params, cfg, prompt)
    rec["root"] = root
    return rec


def measure_engine(root: str) -> dict:
    """``profile_tier`` of the checkout at ``root`` (imported from there;
    call once per process)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import chip_smoke
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.llama2_7b(num_layers=32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    reqs = chip_smoke.make_requests(16, cfg.vocab_size, 0)
    rec = chip_smoke.profile_tier(torch, ContinuousBatchingEngine, params,
                                  cfg, reqs)
    rec["root"] = root
    return rec


def measure(root: str) -> dict:
    """B1-B3 and SDPA's forward, B11, B7 and B8-B10 of the checkout at
    ``root`` (imported from there; call once per process)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused as fk
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import serving_fused as sf

    _build.build(["flash_attention", "flash_chunk", "decode_attention",
                  "paged_decode"])
    out = {"root": root, "B11": {}, "B7": {}, "B8": {}, "B9": {},
           "B10": {}}
    for name, lens, S, H, HK in B7_SHAPES:
        for kv_int8 in (False, True):
            args, kw = dense_inputs(torch, lens, S, H, HK, kv_int8,
                                    seed=S + HK)
            out["B7"][f"{name}-{'int8' if kv_int8 else 'bf16'}"] = time_ms(
                torch, lambda: fk.decode_attention(*args, **kw))
            del args, kw
    for name, lens, pps, HK in B9_SHAPES:
        for kv_int8 in (False, True):
            args, rows, kw = token_major_inputs(torch, lens, pps, HK,
                                                kv_int8, seed=pps + HK)
            key = f"{name}-{'int8' if kv_int8 else 'bf16'}"
            out["B9"][key] = time_ms(
                torch, lambda: pa.paged_attention(*args, **kw))
            q, *rest = args
            out["B10"][key] = time_ms(
                torch, lambda: sf.fused_paged_decode_attention(
                    q, *rows, *rest, **kw))
            del args, rows, kw, q, rest
    for name, lens, pps, HK in B8_SHAPES:
        for kv_int8 in (False, True):
            args, kw = paged_inputs(torch, lens, pps, HK, kv_int8, seed=pps)
            out["B8"][f"{name}-{'int8' if kv_int8 else 'bf16'}"] = time_ms(
                torch, lambda: fk.paged_decode_attention(*args, **kw))
            del args, kw
    for name, B, T, HK, cap, n0, tree in B11_SHAPES:
        for kv_int8 in (False, True):
            args, kw = chunk_inputs(torch, B, T, HK, cap, n0, tree, kv_int8,
                                    seed=T + cap)
            out["B11"][f"{name}-{'int8' if kv_int8 else 'bf16'}"] = time_ms(
                torch, lambda: sf.flash_chunk_attention(*args, **kw))
            del args, kw
    for B, S, H, D in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(5)
        q, k, v, do = (torch.randn((B, S, H, D), generator=g,
                                   device="cuda").bfloat16()
                       for _ in range(4))
        kw = dict(causal=True, scale=D ** -0.5)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2)
        args = (q, k, v, do, lse, delta.contiguous())
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        out[f"D{D}"] = {
            "B1": time_ms(torch, lambda: fa.flash_fwd(q, k, v, **kw)),
            "B2": time_ms(torch, lambda: fa.flash_bwd_dkv(*args, **kw)),
            "B3": time_ms(torch, lambda: fa.flash_bwd_dq(*args, **kw)),
            "sdpa_fwd": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))}
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print("compare " + json.dumps(measure(argv[1])), flush=True)
        return 0
    if len(argv) == 2 and argv[0] == "--one-engine":
        print("engine " + json.dumps(measure_engine(argv[1])), flush=True)
        return 0
    if len(argv) == 2 and argv[0] == "--one-dense":
        print("dense " + json.dumps(measure_dense(argv[1])), flush=True)
        return 0
    one = "--one"
    if argv and argv[0] in ("--engine", "--dense"):
        one, argv = "--one-" + argv[0][2:], argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            one, root])
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
