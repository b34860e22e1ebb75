"""A CPU model of the numerics of the Hopper flash chunk kernels (B11-linear
and B11-tree) against the JAX package's chunk attention, on the CPU.

``csrc/flash_chunk.cu`` computes, for bf16 queries on an H100, what the
emulation below computes step by step. The T * rep query rows of one kv
head are packed into one tile (row r = t * rep + j for head g * rep + j),
and the packed row count M picks the design:

- M >= 64 (prefill): 64-row tiles walk 64-key tiles from kstart's tile to
  the tile's causal limit (W for a tree), one online softmax a row;
- M < 64 (verify): the rows fill 1, 2 or 4 sixteen-row tiles; the key axis
  is cut into ``verify_split`` splits (a power of two that keeps the grid
  near 264 CTAs and each split at least 256 columns, rounded to 64; the
  rule of ``keysplit.cuh``, shared with B8); in a
  split, 4 (or with four row tiles 2) key slices of each 64-key tile each
  keep their own online softmax over their 16-key chunks; the slices merge
  in order, then the splits in order.

Each online softmax step is exp2 with ``scale * log2(e)`` folded in and
the running max in raw ``q.k`` units; p is rounded to the value dtype
before ``p @ v`` while l sums it unrounded; an int8 K/V row is
dequantized with its f32 scale and rounded to the query dtype before its
products (dequant-then-cast); a row that sees no column writes 0. The
kernels cannot run here; this model settles that those choices compute
what the TPU kernels compute.

The same seeded numpy inputs go through the JAX
``flash_chunk_attention_kernel`` in interpret mode (as
``tests/test_torch_kernels.py`` runs it), through
``flash_chunk_attention_reference`` and through the model: both regimes
and their boundary (M = 63, 64, 65 at rep 1; 60, 64, 68 at rep 4), rows
that see one column, a row whose kstart lies in the last split, trees of
up to 32 nodes (node 31 in the bitmask's sign bit), float32 and bfloat16
queries with native and int8 KV. Every row sees at least one column (the
reference's softmax spreads a row that sees none over every column).
Tolerances: float32 within 2e-5 (the same f32 math summed in another
order); bfloat16, ``chip_smoke.py``'s row rule (every D-vector within
``ROW_RTOL * |its row| + ROW_FLOOR * rms``).
"""
import math
import re
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import serving_fused as jsf

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the row rule and its limits)

torch.set_num_threads(1)
LOG2E = 1.4426950408889634
F32 = dict(rtol=2e-5, atol=2e-5)
BN = 64            # keys of a tile (both designs)
PRE_ROWS = 64      # packed rows of a prefill tile
MAX_SPLITS, MIN_SPLIT, TARGET_CTAS = 8, 256, 264


def _jit_call(fn, *args, **kw):
    """``fn(*args, **kw)`` compiled as one XLA program: the array
    arguments are traced, the rest (ints, floats, None, tuples of them)
    fixed. Eager JAX compiles each op of ``fn`` on its own, which is
    most of this file's time on the CPU."""
    flat, tree = jax.tree.flatten((args, kw), is_leaf=lambda x: x is None)
    live = [i for i, x in enumerate(flat)
            if isinstance(x, (np.ndarray, jax.Array))]

    def run(xs):
        full = list(flat)
        for i, x in zip(live, xs):
            full[i] = x
        a, k = jax.tree.unflatten(tree, full)
        return fn(*a, **k)

    return jax.jit(run)([flat[i] for i in live])


def verify_split(B, HK, W):
    """The kernel's ``verify_split``: (number of splits, columns each)."""
    n = 1
    while (n < MAX_SPLITS and 2 * n * B * HK <= TARGET_CTAS
           and W >= 2 * n * MIN_SPLIT):
        n *= 2
    per = -(-W // n)
    return n, -(-per // BN) * BN


class Softmax:
    """One online softmax over the rows of a tile: m (raw q.k), l, acc."""

    def __init__(self, rows, D, c):
        self.c = c
        self.m = torch.full((rows, 1), -math.inf)
        self.l = torch.zeros((rows, 1))
        self.acc = torch.zeros((rows, D))

    def step(self, s, ok, v):
        """s (rows, n) raw scores, ok (rows, n) visibility, v (n, D)."""
        s = torch.where(ok, s, -math.inf)
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


def model_chunk(q, ck, cv, W, kstart, scale, k_rows=None, v_rows=None,
                tree_mask=None):
    """B11 on (B, T, H, D) q and (B, W, HK, D) caches -> (B, T, H, D) in
    q's dtype, the way the kernels tile and round."""
    B, T, H, D = q.shape
    HK = ck.shape[2]
    rep, M, qoff = H // HK, T * (H // HK), W - T
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    if k_rows is not None:  # dequant-then-cast
        ck = (ck.float() * k_rows[..., None]).to(q.dtype)
        cv = (cv.float() * v_rows[..., None]).to(q.dtype)
    out = torch.zeros_like(q)
    for b in range(B):
        kst = max(int(kstart[b]), 0)
        cols = torch.arange(W)
        t_of = torch.arange(M) // rep
        if tree_mask is None:
            vis = cols[None, :] <= qoff + t_of[:, None]
        else:
            chunk = torch.as_tensor(tree_mask[b]).bool()[t_of]   # (M, T)
            vis = torch.cat([torch.ones((M, qoff), dtype=torch.bool),
                             chunk], dim=1)
        vis = vis & (cols[None, :] >= kst)
        for g in range(HK):
            qp = q[b, :, g * rep:(g + 1) * rep].reshape(M, D).float()
            kg, vg = ck[b, :, g], cv[b, :, g]

            def scores(r0, r1, c0, c1):
                k = torch.zeros((c1 - c0, D), dtype=kg.dtype)
                v = torch.zeros_like(k)
                n = max(0, min(c1, W) - c0)   # past W: zeros, masked
                k[:n], v[:n] = kg[c0:c0 + n], vg[c0:c0 + n]
                ok = torch.zeros((r1 - r0, c1 - c0), dtype=torch.bool)
                ok[:, :n] = vis[r0:r1, c0:c0 + n]
                return qp[r0:r1] @ k.float().T, ok, v

            o = torch.zeros((M, D))
            if M >= PRE_ROWS:                       # prefill tiles
                for r0 in range(0, M, PRE_ROWS):
                    r1 = min(M, r0 + PRE_ROWS)
                    t_last = (r1 - 1) // rep
                    c_end = W if tree_mask is not None else min(
                        W, qoff + t_last + 1)
                    sm = Softmax(r1 - r0, D, c)
                    for c0 in range(kst // BN * BN, c_end, BN):
                        sm.step(*scores(r0, r1, c0, c0 + BN))
                    o[r0:r1] = torch.where(sm.l > 0, sm.acc * (1 / sm.l),
                                           0.0)
            else:                                   # verify: key splits
                nsplit, split = verify_split(B, HK, W)
                ks = 4 if M <= 32 else 2            # key slices of a tile
                per = BN // ks
                splits = []
                for s0 in range(0, nsplit * split, split):
                    c_begin = max(s0, kst // BN * BN)
                    slices = [Softmax(M, D, c) for _ in range(ks)]
                    for c0 in range(c_begin, min(W, s0 + split), BN):
                        for k, sm in enumerate(slices):
                            for k0 in range(c0 + k * per,
                                            c0 + (k + 1) * per, 16):
                                sm.step(*scores(0, M, k0, k0 + 16))
                    splits.append(merge([(sm.m, sm.l, sm.acc)
                                         for sm in slices], c))
                _, l, acc = merge(splits, c)
                o = torch.where(l > 0, acc / l, 0.0)
            out[b, :, g * rep:(g + 1) * rep] = o.reshape(T, rep, D).to(
                q.dtype)
    return out


def _tree(rs, T):
    """(T, T) ancestor-or-self matrix of a random tree whose node i hangs
    off a node before it, and whose last node is a leaf of depth >= 2."""
    par = [-1] + [int(rs.randint(0, i)) for i in range(1, T)]
    if T > 2:
        par[-1] = T - 2
    anc = np.zeros((T, T), bool)
    for i in range(T):
        j = i
        while j >= 0:
            anc[i, j] = True
            j = par[j]
    return anc


# (B, T, H, HK, D, W, kstart, tree, kind): M = T * H / HK packed rows;
# each regime and its boundary see float32, bfloat16 and int8 KV
CASES = {
    "verify-M5-splits-f32": (2, 5, 2, 2, 64, 605, (0, 600), False, "float32"),
    "verify-M5-splits-int8": (2, 5, 2, 2, 64, 605, (0, 600), False, "int8"),
    "verify-M20-rep4-bf16": (2, 5, 8, 2, 64, 605, (3, 330), False,
                             "bfloat16"),
    "verify-M36-rep4-int8": (2, 9, 8, 2, 64, 521, (0, 512), False, "int8"),
    "verify-M63-bf16": (1, 63, 1, 1, 64, 200, (10,), False, "bfloat16"),
    "prefill-M64-f32": (1, 64, 1, 1, 64, 200, (136,), False, "float32"),
    "prefill-M65-int8": (1, 65, 1, 1, 64, 200, (70,), False, "int8"),
    "verify-M60-rep4-int8": (1, 15, 4, 1, 64, 150, (3,), False, "int8"),
    "prefill-M64-rep4-bf16": (1, 16, 4, 1, 64, 150, (134,), False,
                              "bfloat16"),
    "prefill-M68-rep4-f32": (1, 17, 4, 1, 64, 150, (0,), False, "float32"),
    "tree-T9-int8": (2, 9, 2, 2, 64, 521, (100, 512), True, "int8"),
    "tree-T32-bf16": (2, 32, 2, 2, 64, 232, (0, 200), True, "bfloat16"),
    "tree-T32-prefill-f32": (1, 32, 4, 2, 64, 232, (57,), True, "float32"),
    "tree-T32-prefill-int8": (1, 32, 4, 2, 64, 232, (57,), True, "int8"),
}


@pytest.fixture(autouse=True)
def _interpret():
    jfa.set_interpret(True)
    yield
    jfa.set_interpret(False)


@pytest.mark.parametrize("name", list(CASES))
def test_chunk_tiling_model_matches_jax(name):
    B, T, H, HK, D, W, ks, tree, kind = CASES[name]
    rs = np.random.RandomState(sum(map(ord, name)))
    scale = 1.0 / math.sqrt(D)
    qdt = torch.float32 if kind == "float32" else torch.bfloat16
    q = torch.from_numpy(rs.randn(B, T, H, D).astype(np.float32)).to(qdt)
    kw = {}
    if kind == "int8":
        ck, cv = (torch.from_numpy(rs.randint(-127, 128, (B, W, HK, D))
                                   .astype(np.int8)) for _ in range(2))
        kw["k_rows"], kw["v_rows"] = (
            torch.from_numpy((rs.rand(B, W, HK) * 0.05 + 0.01)
                             .astype(np.float32)) for _ in range(2))
    else:
        ck, cv = (torch.from_numpy(rs.randn(B, W, HK, D).astype(np.float32))
                  .to(qdt) for _ in range(2))
    kstart = np.asarray(ks, np.int32)
    if tree:
        kw["tree_mask"] = np.stack([_tree(rs, T) for _ in range(B)])
    got = model_chunk(q, ck, cv, W, kstart, scale, **kw)

    jdt = jnp.float32 if kind == "float32" else jnp.bfloat16
    jkw = {k: jnp.asarray(np.asarray(v)) for k, v in kw.items()}
    jargs = (jnp.asarray(q.float().numpy(), jdt),
             jnp.asarray(ck.numpy() if kind == "int8"
                         else ck.float().numpy(),
                         jnp.int8 if kind == "int8" else jdt),
             jnp.asarray(cv.numpy() if kind == "int8"
                         else cv.float().numpy(),
                         jnp.int8 if kind == "int8" else jdt),
             W, jnp.asarray(kstart))
    ref = np.asarray(_jit_call(jsf.flash_chunk_attention_reference, *jargs,
                               scale=scale, **jkw).astype(jnp.float32))
    ker = np.asarray(_jit_call(jsf.flash_chunk_attention_kernel, *jargs,
                               scale=scale, block_k=128,
                               **jkw).astype(jnp.float32))
    if tree:  # node 31 of a 32-node tree sets the sign bit of its mask
        bits = (kw["tree_mask"].astype(np.int64)
                << np.arange(T)).sum(axis=2)
        assert T < 32 or (bits[:, 31] >= 2 ** 31).all()
    for want in (ker, ref):
        if kind == "float32":
            np.testing.assert_allclose(got.numpy(), want, **F32)
        else:
            ratio = chip_smoke.row_ratio(torch, got,
                                         torch.from_numpy(want.copy()))
            assert ratio <= 1.0, f"worst row at {ratio:.3g} of its limit"


CSRC = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"


@pytest.mark.parametrize("source,name,value", [
    ("flash_chunk.cu", "kPreRows", PRE_ROWS),
    ("flash_chunk.cu", "kPreBN", BN),
    ("keysplit.cuh", "kTile", BN),
    ("keysplit.cuh", "kMaxSplits", MAX_SPLITS),
    ("keysplit.cuh", "kMinSplit", MIN_SPLIT),
    ("keysplit.cuh", "kTargetCtas", TARGET_CTAS)])
def test_model_constants_are_the_kernels(source, name, value):
    """The model's tile sizes and verify split rule are the ones
    ``csrc/flash_chunk.cu`` compiles with (its prefill tile, and the
    verify tile and rule it takes from ``keysplit.cuh``)."""
    src = (CSRC / source).read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", src)
    assert found == [str(value)]
