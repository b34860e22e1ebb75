"""The port's fused RMSNorm and SwiGLU (B4, B5) against the JAX package's.

On the CPU the port's wrappers run their plain versions; the JAX side
runs its Pallas kernels in interpret mode, with ``block_rows=16`` over
6 * 33 = 198 rows, so the last block is padded and the TPU kernel's
padded-row branch runs. Forward outputs and the cotangents of
``jax.vjp`` go against ``_RMSNorm`` and ``_SwiGLU`` through autograd on
the same seeded numpy inputs. Tolerances: float32 rtol = atol = 1e-5
(the same f32 math, summed in other orders); bfloat16 rtol = 2^-7 and
atol = 1e-6, one bf16 ulp of the value, as both sides round the same
f32 result once and may land on neighbouring steps. ``gradcheck`` runs
in float64, where the plain versions keep float64. The serving forwards
ignore ``fused_kernels`` (as the JAX package's do), and "pallas" routes
every RMSNorm and SwiGLU of the training model through the fused ops,
with the per-layer counts the card's launch check expects under "auto";
on the CPU "auto" is the "xla" composition bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import fused as jfz
from paddle_tpu_torch.models import generate as tgen
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.ops.kernels import fused as fk

torch.set_num_threads(1)
TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2.0 ** -7, atol=1e-6)}
SHAPE, BLOCK_ROWS = (6, 33, 64), 16


@pytest.fixture(autouse=True)
def _interpret():
    jfa.set_interpret(True)
    yield
    jfa.set_interpret(False)


def _inputs(dtype, *scales, seed=0):
    """Seeded numpy arrays of SHAPE (a scale of None: a (64,) weight
    around 1), as (jax, torch) pairs in ``dtype``."""
    rs = np.random.RandomState(seed)
    out = []
    for s in scales:
        a = (1 + 0.1 * rs.randn(SHAPE[-1]) if s is None
             else s * rs.randn(*SHAPE)).astype(np.float32)
        out.append((jnp.asarray(a).astype(dtype),
                    torch.from_numpy(a).to(getattr(torch, dtype))))
    return out


def _close(got, want, dtype, what):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               err_msg=what, **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_the_pallas_kernels(dtype):
    (jx, tx), (jw, tw), (jct, tct), (jr, tr) = _inputs(dtype, 1.0, None,
                                                       1.0, 0.5)
    eps = 1e-5
    jout, vjp = jax.vjp(lambda x, w: jfz.rms_norm(
        x, w, eps, block_rows=BLOCK_ROWS), jx, jw)
    jdx, jdw = vjp(jct)
    x, w = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    out = fk.rms_norm(x, w, eps)
    out.backward(tct)
    _close(out.detach(), jout, dtype, "out")
    _close(x.grad, jdx, dtype, "dx")
    _close(w.grad, jdw, dtype, "dw")
    assert out.dtype == x.grad.dtype == w.grad.dtype == tx.dtype
    # residual form: (norm(x + r), x + r)
    jo, jsum = jfz.rms_norm(jx, jw, eps, residual=jr,
                            block_rows=BLOCK_ROWS)
    o, s = fk.rms_norm(tx, tw, eps, residual=tr)
    _close(o, jo, dtype, "residual out")
    _close(s, jsum, dtype, "residual sum")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches_the_pallas_kernels(dtype):
    (jg, tg), (ju, tu), (jd, td) = _inputs(dtype, 3.0, 1.0, 1.0, seed=1)
    jout, vjp = jax.vjp(lambda g, u: jfz.swiglu(
        g, u, block_rows=BLOCK_ROWS), jg, ju)
    jdg, jdu = vjp(jd)
    g, u = tg.clone().requires_grad_(), tu.clone().requires_grad_()
    out = fk.swiglu(g, u)
    out.backward(td)
    _close(out.detach(), jout, dtype, "out")
    _close(g.grad, jdg, dtype, "dg")
    _close(u.grad, jdu, dtype, "du")


@pytest.mark.parametrize("op", ["rms_norm", "swiglu"])
def test_gradcheck_in_float64(op):
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((5, 16), generator=gen, dtype=torch.float64)
    b = torch.randn((5, 16), generator=gen, dtype=torch.float64)
    if op == "rms_norm":
        w = 1 + 0.1 * torch.randn((16,), generator=gen, dtype=torch.float64)
        args = (a.requires_grad_(), w.requires_grad_(), 1e-5)
        fn = fk._RMSNorm.apply
    else:
        args = (a.requires_grad_(), b.requires_grad_())
        fn = fk._SwiGLU.apply
    assert torch.autograd.gradcheck(fn, args)


@pytest.fixture(scope="module")
def tiny_params():
    cfg = tl.LlamaConfig.tiny(num_layers=2, max_seq_len=64)
    return tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _boom(*args, **kwargs):
    raise AssertionError("the serving path reached a fused op")


@pytest.mark.parametrize("attn_fused", [False, True],
                         ids=["plain", "fused"])
def test_serving_ignores_fused_kernels(tiny_params, monkeypatch,
                                       attn_fused):
    """A prefill chunk and a decode step under ``fused_kernels="auto"``
    never reach the fused ops and give the "xla" config's logits and
    pools bit for bit (``attn_fused`` is the serving forwards' own
    switch for B10/B11)."""
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        3, 256, (1, 8)).astype(np.int32))
    table = torch.tensor([2, 0, 1], dtype=torch.int32)
    runs = []
    for fk_mode in ("xla", "auto"):
        cfg = tl.LlamaConfig.tiny(num_layers=2, max_seq_len=64,
                                  fused_kernels=fk_mode)
        if fk_mode == "auto":
            for name in ("rms_norm", "swiglu", "rms_fwd", "rms_bwd",
                         "swiglu_fwd", "swiglu_bwd"):
                monkeypatch.setattr(fk, name, _boom)
        pool = tgen.init_paged_cache(cfg, 4, 8, device="cpu")
        pre, pool = tgen.paged_prefill_chunk(
            tiny_params, toks, pool, table, cfg, ctx_cap=0, ctx_len=0,
            chunk_len=7, fused=attn_fused)
        dec, pool = tgen.paged_decode_forward(
            tiny_params, toks[0, 7:8], pool, table[None],
            torch.tensor([7], dtype=torch.int32), cfg,
            active=torch.tensor([True]), fused=attn_fused)
        runs.append((pre, dec, pool["k"], pool["v"]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused_kernels", ["xla", "auto", "pallas"])
def test_training_model_routes_through_the_fused_ops(tiny_params,
                                                     monkeypatch,
                                                     fused_kernels):
    """One loss and backward of the 2-layer model under remat "nothing"
    calls the fused ops' plain versions under "pallas" as often as the
    card launches the kernels under "auto": B4a 4L + 1 (two norms a
    layer, again in the recompute, and the final norm), B4b 2L + 1, B5a
    2L, B5b L; "xla" never, and "auto" on these CPU tensors never either
    (fused only on the card)."""
    calls = dict.fromkeys(("rms_norm_fwd_plain", "rms_norm_bwd_plain",
                           "swiglu_fwd_plain", "swiglu_bwd_plain"), 0)

    def spy(name, fn):
        def counted(*args):
            calls[name] += 1
            return fn(*args)
        return counted

    for name in calls:
        monkeypatch.setattr(fk, name, spy(name, getattr(fk, name)))
    cfg = tl.LlamaConfig.tiny(num_layers=2, max_seq_len=64, remat=True,
                              fused_kernels=fused_kernels)
    params = {k: v if k == "layers" else v.clone().requires_grad_()
              for k, v in tiny_params.items()}
    params["layers"] = {k: v.clone().requires_grad_()
                        for k, v in tiny_params["layers"].items()}
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (2, 16)).astype(np.int32))
    tl.loss_fn(params, toks, cfg, seq_chunk=8).backward()
    L = cfg.num_layers
    want = [4 * L + 1, 2 * L + 1, 2 * L, L]
    assert list(calls.values()) == (
        want if fused_kernels == "pallas" else [0, 0, 0, 0]), calls


def test_auto_is_xla_on_the_cpu():
    """``fused_kernels="auto"`` on CPU tensors is the "xla" composition
    bit for bit in bfloat16 (where the fused ops' cast order would show),
    as the JAX package's "auto" is wherever its kernels do not run."""
    logits = []
    for mode in ("xla", "auto", "pallas"):
        cfg = tl.LlamaConfig.tiny(dtype=torch.bfloat16, fused_kernels=mode)
        params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.from_numpy(np.random.RandomState(4).randint(
            0, cfg.vocab_size, (2, 128)).astype(np.int32))
        logits.append(tl.forward(params, toks, cfg))
    assert torch.equal(logits[0], logits[1])
    assert not torch.equal(logits[0], logits[2])
