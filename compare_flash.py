#!/usr/bin/env python3
"""Time the flash-attention kernels B1, B2 and B3 of the port in a given
checkout, beside SDPA's forward, on one CUDA card.

    python3 compare_flash.py PATH [PATH ...]

Each PATH is the root of a checkout of this repository (``.`` for this
one; an older commit unpacked with ``git archive`` for a comparison).
Every checkout runs in its own process, in the order given, so a
comparison should list them in turns (old, new, new, old) to show the
card's drift. Shapes: the training step's (B = 4, S = 4096, H = 12,
D = 128, causal, bf16) and its D = 64 twin (H = 24). Times are CUDA
events over 20 launches after 3 warm-up launches; one JSON line per
checkout, ``compare {...}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

SHAPES = ((4, 4096, 12, 128), (4, 4096, 24, 64))


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


def measure(root: str) -> dict:
    """B1-B3 and SDPA's forward of the checkout at ``root`` (imported
    from there; call once per process)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    _build.build(["flash_attention"])
    out = {"root": root}
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
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root])
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
