"""A CPU model of the numerics of the split-key paged decode kernel
(``csrc/paged_split.cuh``, bf16 queries) against the JAX package's
kernels, on the CPU: B8 (a head-major page pool, one dequant scale per
(row, kv head)) against ``paged_decode_attention``, and B9 / B10 (a
token-major pool, one scale per token; B10 rotates q first) against
``paged_attention_kernel`` and ``fused_paged_decode_kernel``.

The kernel computes, for bf16 queries on an H100, what the emulation
below computes step by step. The rep query rows of one kv
head fill one 16-row tile; the token axis is cut into ``decode_split``
splits (``keysplit.cuh``) (a power of two, chosen from B, HK and the table's capacity
``ppseq * page`` alone, each split at least 256 tokens, rounded to 64); a
split reads only the row's live tokens [0, len) of its range, through
the block table (-1 entries read page 0), in 64-token tiles, and each of
4 slices of a tile (16 tokens, one warp) keeps its own online softmax:
exp2 with ``scale * log2(e)`` folded in, the running max in raw ``q.k``
units, p rounded to the query dtype before ``p @ v`` while l sums it
unrounded. int8 pages are dequantized with the (row, kv head) scale
(B8) or each token's own scale (B9/B10) and rounded to the query dtype
before their products. B10's q is rotated in f32 (each product and sum
rounded) and rounded to the query dtype before q.k. The slices merge in
order, then the splits in order; a split past the row's length leaves an
empty partial, and a row of length 0 writes zeros. The kernel cannot run
here; this model settles that those choices compute what the TPU kernel
computes.

The same seeded numpy inputs go through the JAX ``paged_decode_attention``
in interpret mode (as ``tests/test_torch_kernels.py`` runs it) and
through the model, at table capacities that give 1, 2, 4 and 8 splits,
with rows of length 1, 0, one that ends mid-page in the last split and
one that leaves every split but the first empty, -1 table entries past
each row's pages, float32 and bfloat16 queries and int8 pages with
(B, HK) scales; B9 and B10 go through the model and the JAX kernels
(interpret mode) on token-major pools of 16-token pages (four a tile)
with per-token int8 scales, B10 with each row's cos/sin rows.
Tolerances: float32 within 2e-5 (the same f32 math summed in another
order); bfloat16, ``chip_smoke.py``'s row rule (every D-vector within
``ROW_RTOL * |its row| + ROW_FLOOR * rms``).
"""
import math
import re
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import fused as jfz
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.ops.pallas import serving_fused as jsf

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the row rule and its limits)

torch.set_num_threads(1)
LOG2E = 1.4426950408889634
F32 = dict(rtol=2e-5, atol=2e-5)
BN, SLICE = 64, 16          # tokens of a ring tile, and of a warp's slice
MAX_SPLITS, MIN_SPLIT, TARGET_CTAS = 8, 256, 264   # keysplit.cuh


def decode_split(B, HK, cap):
    """``keysplit.cuh``'s ``split_count`` and ``split_length`` (the rule
    B8 shares with B11's verify): (number of splits, tokens each)."""
    n = 1
    while (n < MAX_SPLITS and 2 * n * B * HK <= TARGET_CTAS
           and cap >= 2 * n * MIN_SPLIT):
        n *= 2
    per = -(-cap // n)
    return n, -(-per // BN) * BN


class Softmax:
    """One online softmax over the rows of a tile: m (raw q.k), l, acc."""

    def __init__(self, rows, D, c):
        self.c = c
        self.m = torch.full((rows, 1), -math.inf)
        self.l = torch.zeros((rows, 1))
        self.acc = torch.zeros((rows, D))

    def step(self, s, ok, v):
        """s (rows, n) raw scores, ok (n,) live tokens, v (n, D)."""
        s = torch.where(ok[None, :], s, -math.inf)
        mn = torch.maximum(self.m, s.amax(dim=1, keepdim=True))
        mc = torch.where(mn == -math.inf, 0.0, mn * self.c)
        alpha = torch.exp2(self.m * self.c - mc)
        p = torch.exp2(s * self.c - mc)
        self.l = self.l * alpha + p.sum(dim=1, keepdim=True)
        self.acc = self.acc * alpha + p.to(v.dtype).float() @ v.float()
        self.m = mn


def merge(parts, c):
    """(m, l, acc) partials merged in the given order -> (m, l, acc);
    a partial with m = -inf (nothing seen) weighs 0."""
    mk = torch.stack([p[0] for p in parts]).amax(dim=0)
    live = mk != -math.inf
    l = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for m, pl, pa in parts:
        w = torch.where(live & (m != -math.inf),
                        torch.exp2((m - torch.where(live, mk, 0.0)) * c), 0.0)
        l = l + w * pl
        acc = acc + w * pa
    return mk, l, acc


def rotate(q, cos_row, sin_row):
    """q (B, H, D) rotated by RoPE in f32 (each product and sum rounded,
    no fused multiply-add) and rounded to q's dtype: B10's staging."""
    x1, x2 = q.float().chunk(2, dim=-1)
    c, s = cos_row[:, None, :], sin_row[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(q.dtype)


def model_decode(q, kp, vp, bt, lens, scale, ks=None, vs=None,
                 token_major=False, rope=None):
    """The split kernel on q (B, H, D) through the block tables bt (B,
    ppseq) -> (B, H, D) in q's dtype, the way it tiles and rounds: B8 on
    head-major pools (P, HK, page, D) with (B, HK) scales ks, vs of int8
    pools; with ``token_major`` B9 on (P, page, HK, D) pools with (P,
    page, HK) scales; ``rope`` (cos_row, sin_row) makes it B10. With
    ``bt`` None, B7: dense (B, S, HK, D) caches with (B, S, HK) scales,
    the capacity S."""
    B, H, D = q.shape
    if bt is None:
        HK, cap = kp.shape[2], kp.shape[1]
    else:
        HK, page = ((kp.shape[2], kp.shape[1]) if token_major
                    else (kp.shape[1], kp.shape[2]))
        cap = bt.shape[1] * page
    rep = H // HK
    if rope is not None:
        q = rotate(q, *rope)
    nsplit, split = decode_split(B, HK, cap)
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    out = torch.zeros_like(q)
    for b in range(B):
        n = min(max(int(lens[b]), 0), cap)
        for g in range(HK):
            qg = q[b, g * rep:(g + 1) * rep].float()

            def rows(pool, sc, j0, j1):
                """Tokens [j0, j1) of kv head g, zeros at or past n."""
                t = torch.zeros((j1 - j0, D), dtype=q.dtype)
                j = torch.arange(j0, max(j0, min(j1, n)))
                if bt is None:        # dense: the row is its own page
                    x = pool[b, j, g]
                    s = None if sc is None else sc[b, j, g, None]
                    t[:len(j)] = (x if s is None else x.float() * s).to(
                        q.dtype)
                    return t
                pg = bt[b, j // page].long().clamp(min=0)
                if token_major:
                    x = pool[pg, j % page, g]
                    s = None if sc is None else sc[pg, j % page, g, None]
                else:
                    x = pool[pg, g, j % page]
                    s = None if sc is None else sc[b, g]
                t[:len(j)] = (x if s is None else x.float() * s).to(q.dtype)
                return t

            parts = []
            for s0 in range(0, nsplit * split, split):
                s_end = min(n, s0 + split)
                if s_end <= s0:       # past the row's length: empty
                    parts.append((torch.full((rep, 1), -math.inf),
                                  torch.zeros((rep, 1)),
                                  torch.zeros((rep, D))))
                    continue
                slices = [Softmax(rep, D, c) for _ in range(BN // SLICE)]
                for c0 in range(s0, s_end, BN):
                    kt, vt = rows(kp, ks, c0, c0 + BN), rows(vp, vs, c0,
                                                              c0 + BN)
                    for w, sm in enumerate(slices):
                        j0 = w * SLICE
                        ok = torch.arange(c0 + j0, c0 + j0 + SLICE) < s_end
                        sm.step(qg @ kt[j0:j0 + SLICE].float().T, ok,
                                vt[j0:j0 + SLICE])
                parts.append(merge([(s.m, s.l, s.acc) for s in slices], c))
            _, l, acc = merge(parts, c)
            out[b, g * rep:(g + 1) * rep] = torch.where(
                l > 0, acc / torch.where(l > 0, l, 1.0), 0.0).to(q.dtype)
    return out


@pytest.fixture(autouse=True)
def _interpret():
    jfa.set_interpret(True)
    yield
    jfa.set_interpret(False)


SPLITS = (1, 2, 4, 8)
KINDS = ("float32", "bfloat16", "int8")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nsplit", SPLITS)
def test_split_decode_model_matches_jax(nsplit, kind):
    """Capacity 256 * nsplit tokens in pages of 64 (B = 4, HK = 2, rep 2,
    D = 16): rows of lengths 1, 0, cap - 37 (ends mid-page in the last
    split) and 100 (every split but the first empty)."""
    rs = np.random.RandomState(10 * nsplit + KINDS.index(kind))
    B, HK, rep, D, page = 4, 2, 2, 16, 64
    H, pps = HK * rep, 4 * nsplit
    cap = pps * page
    assert decode_split(B, HK, cap)[0] == nsplit
    lens = np.asarray([1, 0, cap - 37, 100], np.int32)
    P = 1 + B * pps
    bt = (rs.permutation(P - 1) + 1).reshape(B, pps).astype(np.int32)
    for b, n in enumerate(lens):
        bt[b, -(-n // page):] = -1
    q = rs.randn(B, H, D).astype(np.float32)
    qdt = "float32" if kind == "float32" else "bfloat16"
    jd, td = getattr(jnp, qdt), getattr(torch, qdt)
    kw = {}
    if kind == "int8":
        kp, vp = (rs.randint(-127, 128, (P, HK, page, D)).astype(np.int8)
                  for _ in range(2))
        kw = dict(k_dequant_scale=(rs.rand(B, HK) * 0.05 + 0.01).astype(
            np.float32), v_dequant_scale=(rs.rand(B, HK) * 0.05
                                          + 0.01).astype(np.float32))
        jkv = [jnp.asarray(a) for a in (kp, vp)]
        tkv = [torch.from_numpy(a) for a in (kp, vp)]
    else:
        kp, vp = (rs.randn(P, HK, page, D).astype(np.float32)
                  for _ in range(2))
        jkv = [jnp.asarray(a).astype(jd) for a in (kp, vp)]
        tkv = [torch.from_numpy(a).to(td) for a in (kp, vp)]
    scale = 1.0 / math.sqrt(D)
    want = np.asarray(jfz.paged_decode_attention(
        jnp.asarray(q).astype(jd), *jkv, jnp.asarray(bt), jnp.asarray(lens),
        **{k: jnp.asarray(v) for k, v in kw.items()}).astype(jnp.float32))
    sc = {k: torch.from_numpy(v) for k, v in kw.items()}
    got = model_decode(torch.from_numpy(q).to(td), *tkv,
                       torch.from_numpy(bt), torch.from_numpy(lens), scale,
                       sc.get("k_dequant_scale"), sc.get("v_dequant_scale"))
    assert not got[1].any()              # the row of length 0
    if kind == "float32":
        np.testing.assert_allclose(got.numpy(), want, **F32)
        return
    ratio = chip_smoke.row_ratio(torch, got[[0, 2, 3]],
                                 torch.tensor(want)[[0, 2, 3]])
    assert ratio <= 1.0, f"worst row at {ratio:.3g} of its limit"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nsplit", SPLITS)
def test_token_major_split_model_matches_jax(nsplit, kind):
    """B9 and B10 on token-major pools of 16-token pages, capacity 256 *
    nsplit tokens (B = 4, HK = 2, rep 2, D = 16): rows of lengths 1, 0,
    cap - 37 and 100 as above, per-token int8 scales; B10's cos/sin rows
    at each row's position. JAX's kernels write zeros for the row of
    length 0, as the model does."""
    rs = np.random.RandomState(100 + 10 * nsplit + KINDS.index(kind))
    B, HK, rep, D, page = 4, 2, 2, 16, 16
    H, pps = HK * rep, 16 * nsplit
    cap = pps * page
    assert decode_split(B, HK, cap)[0] == nsplit
    lens = np.asarray([1, 0, cap - 37, 100], np.int32)
    P = 1 + B * pps
    bt = (rs.permutation(P - 1) + 1).reshape(B, pps).astype(np.int32)
    for b, n in enumerate(lens):
        bt[b, -(-n // page):] = -1
    q = rs.randn(B, H, D).astype(np.float32)
    ang = np.outer(np.maximum(lens - 1, 0),
                   1.0 / 10000 ** (np.arange(0, D, 2) / D))
    rows = [np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)]
    qdt = "float32" if kind == "float32" else "bfloat16"
    jd, td = getattr(jnp, qdt), getattr(torch, qdt)
    kw = {}
    if kind == "int8":
        kp, vp = (rs.randint(-127, 128, (P, page, HK, D)).astype(np.int8)
                  for _ in range(2))
        kw = {k: (rs.rand(P, page, HK) * 0.05 + 0.01).astype(np.float32)
              for k in ("ks_pages", "vs_pages")}
        jkv = [jnp.asarray(a) for a in (kp, vp)]
        tkv = [torch.from_numpy(a) for a in (kp, vp)]
    else:
        kp, vp = (rs.randn(P, page, HK, D).astype(np.float32)
                  for _ in range(2))
        jkv = [jnp.asarray(a).astype(jd) for a in (kp, vp)]
        tkv = [torch.from_numpy(a).to(td) for a in (kp, vp)]
    scale = 1.0 / math.sqrt(D)
    jq, jsc = jnp.asarray(q).astype(jd), {k: jnp.asarray(v)
                                          for k, v in kw.items()}
    jrest = (jnp.asarray(bt), jnp.asarray(lens))
    wants = (jpa.paged_attention_kernel(jq, *jkv, *jrest, **jsc),
             jsf.fused_paged_decode_kernel(jq, *map(jnp.asarray, rows),
                                           *jkv, *jrest, **jsc))
    sc = {k: torch.from_numpy(v) for k, v in kw.items()}
    for rope, want in zip((None, [torch.from_numpy(r) for r in rows]),
                          wants):
        want = np.asarray(want.astype(jnp.float32))
        got = model_decode(torch.from_numpy(q).to(td), *tkv,
                           torch.from_numpy(bt), torch.from_numpy(lens),
                           scale, sc.get("ks_pages"), sc.get("vs_pages"),
                           token_major=True, rope=rope)
        assert not got[1].any() and not want[1].any()  # length 0: zeros
        if kind == "float32":
            np.testing.assert_allclose(got.numpy(), want, **F32)
            continue
        ratio = chip_smoke.row_ratio(torch, got[[0, 2, 3]],
                                     torch.tensor(want)[[0, 2, 3]])
        assert ratio <= 1.0, f"worst row at {ratio:.3g} of its limit"


# B7: (capacity S, GQA group); at B = 6 rows, HK = 2 the rule gives 1,
# 2, 4 and 8 splits
DENSE_CASES = ((192, 1), (512, 4), (1024, 1), (2048, 4))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("S,rep", DENSE_CASES,
                         ids=[f"S{c[0]}-rep{c[1]}" for c in DENSE_CASES])
def test_dense_split_model_matches_jax(S, rep, kind):
    """B7: the split kernel's dense addressing on layer 1 of a (B, L, S,
    HK, D) cache (a strided view, as dense ``generate`` passes a layer),
    B = 6, HK = 2, D = 16, against the JAX ``decode_attention`` in
    interpret mode: rows of lengths 1, 0, S, one past S (clamped to S),
    S - 37 (ends mid-tile in the last split) and 100 (every split but
    the first empty); S = 192 is not a multiple of the 64-token tile.
    The model reads a cache whose columns past each row's length are
    NaN (int8: their scales), JAX the same cache with a clean tail; int8
    rows carry (B, S, HK) per-token scales. JAX writes zeros for the row
    of length 0, as the model does."""
    rs = np.random.RandomState(1000 + S + KINDS.index(kind))
    B, L, HK, D = 6, 2, 2, 16
    H = HK * rep
    nsplit = {192: 1, 512: 2, 1024: 4, 2048: 8}[S]
    assert decode_split(B, HK, S)[0] == nsplit
    lens = np.asarray([1, 0, S, S + 1, S - 37, 100], np.int32)
    q = rs.randn(B, H, D).astype(np.float32)
    qdt = "float32" if kind == "float32" else "bfloat16"
    jd, td = getattr(jnp, qdt), getattr(torch, qdt)
    big = (B, L, S, HK, D)
    if kind == "int8":
        kv = [rs.randint(-127, 128, big).astype(np.int8) for _ in range(2)]
        sc = [(rs.rand(*big[:4]) * 0.05 + 0.01).astype(np.float32)
              for _ in range(2)]
        jkv = [jnp.asarray(a[:, 1]) for a in kv]
        tkv = [torch.from_numpy(a.copy())[:, 1] for a in kv]
    else:
        kv = [rs.randn(*big).astype(np.float32) for _ in range(2)]
        sc = [None, None]
        jkv = [jnp.asarray(a[:, 1]).astype(jd) for a in kv]
        tkv = [torch.from_numpy(a.copy()).to(td)[:, 1] for a in kv]
    jsc = {} if sc[0] is None else dict(
        k_dequant_rows=jnp.asarray(sc[0][:, 1]),
        v_dequant_rows=jnp.asarray(sc[1][:, 1]))
    tsc = [None if a is None else torch.from_numpy(a.copy())[:, 1]
           for a in sc]
    tail = np.arange(S)[None, :] >= lens[:, None]            # (B, S)
    for t in (tsc if kind == "int8" else tkv):
        t[torch.from_numpy(tail)] = float("nan")
    assert not tkv[0].is_contiguous()
    want = np.asarray(jfz.decode_attention(
        jnp.asarray(q).astype(jd), *jkv, jnp.asarray(lens),
        **jsc).astype(jnp.float32))
    got = model_decode(torch.from_numpy(q).to(td), *tkv, None,
                       torch.from_numpy(lens), 1.0 / math.sqrt(D), *tsc)
    assert torch.isfinite(got).all() and not got[1].any()
    assert not want[1].any()                 # the row of length 0: zeros
    live = [0, 2, 3, 4, 5]
    if kind == "float32":
        np.testing.assert_allclose(got.numpy()[live], want[live], **F32)
        return
    ratio = chip_smoke.row_ratio(torch, got[live], torch.tensor(want)[live])
    assert ratio <= 1.0, f"worst row at {ratio:.3g} of its limit"


@pytest.mark.parametrize("shape,want", [
    ((8, 32, 2048), 1), ((8, 32, 1088), 1), ((1, 32, 4096), 8),
    ((8, 8, 2048), 4), ((1, 32, 256), 1), ((4, 2, 2048), 8),
    ((8, 12, 192), 1), ((4, 2, 512), 2), ((4, 2, 1024), 4)])
def test_split_rule_at_the_timed_shapes(shape, want):
    """The split counts the kernel's source note and ``chip_smoke.py``
    state, for B7's dense cache (capacity S) as for B8-B10's tables: 8
    rows x 32 kv heads (ragged and the Paddle decoder's rows; the paged
    engine's decode step, ``max_batch=8`` at ``max_len=2048``; dense
    decoding's long tier and beam rows) 1, one row of 4,096 tokens 8,
    GQA's 8 x 8 4; a table shorter than two splits' minimum 1; the JAX
    bench model's 8 x 12 at S = 192 1; the card tests' B = 4, HK = 2 at
    512, 1024 and 2048, 2, 4 and 8."""
    n, split = decode_split(*shape)
    assert n == want and split % BN == 0 and n * split >= shape[2]


CSRC = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"


@pytest.mark.parametrize("name,value", [
    ("kTile", BN), ("kMaxSplits", MAX_SPLITS), ("kMinSplit", MIN_SPLIT),
    ("kTargetCtas", TARGET_CTAS)])
def test_model_constants_are_the_headers(name, value):
    """The model's tile and split-rule constants are ``keysplit.cuh``'s,
    which the kernels of B7-B10 compile with."""
    src = (CSRC / "keysplit.cuh").read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", src)
    assert found == [str(value)]
