"""PyTorch/CUDA port of paddle_tpu's serving path (plain and
speculative), dense decoding, models and training step.

The JAX package ``paddle_tpu`` stays the reference; this package holds
its counterpart for an NVIDIA H100, module for module:

- ``models/llama.py``: the Llama config, parameters and model (forward,
  remat, the chunked next-token loss);
- ``models/gpt.py`` and ``models/ernie.py``: the GPT-2 family
  (pre-LN, fused qkv, tanh GELU, the tied head; attention through
  ``llama._attention``, so B1-B3 at head dim 64 on the card) and the
  ERNIE/BERT encoder (post-LN, segments, pads, the pooler and NSP head,
  the stateless MLM mask and loss);
- ``models/train.py``: the single-device training step shared by the
  model families (``model=``; AdamW on f32 master weights, global-norm
  clip);
- ``models/generate.py``: dense ``generate`` (greedy and sampled,
  EOS, left-padded batches, int8 KV, a shared prompt cache),
  ``beam_search``, ``precompute_prompt_cache``, weight-only
  ``quantize_weights`` (int8, int4), the paged prefill-chunk / ragged
  decode forwards, the speculative verify (linear and token-tree), the
  tree commit and the truncated-layer draft model;
- ``serving/paged_cache.py``: the refcounted page allocator, the
  prefix trie and the device page pools;
- ``serving/speculative.py``: n-gram drafting, the acceptance rules
  and token trees (host numpy);
- ``serving/resilience.py``: fault points, the fault injector, the
  request journal and ``EngineSupervisor`` (supervised recovery,
  drain/restore);
- ``observability/``: the metrics registry, the hot-path hooks, request
  tracing and the flight recorder; ``profiler/``: the host-span
  collector the hooks feed;
- ``inference/predictor.py``: the continuous-batching engine, with
  n-gram, draft-model and tree speculation and weight-only int8/int4
  (``weight_bits``);
- ``_core/``: the Paddle tensor core (``Tensor`` over a
  ``torch.Tensor``, ``to_tensor``, the dtype names, the autograd surface
  on torch autograd), the RNG state (``random.py``: threefry2x32 as
  ``jax.random`` draws it, ``Generator``, ``seed``, ``rng_scope``) and
  ``ops/_registry.py`` (``as_tensor``, ``raw`` and the few ``Tensor``
  methods built on it);
- ``nn/functional``: the attention functionals (``flash_attention``
  on B1-B3 for CUDA tensors, ``scaled_dot_product_attention``,
  ``flash_attn_unpadded``, the packed forms, ``flashmask_attention``,
  ``sdp_kernel``);
- ``incubate/nn/functional``: the fused serving ops of
  ``paddle.incubate`` (``fused_rms_norm``, ``fused_layer_norm``,
  ``swiglu``, ``fused_rotary_position_embedding``,
  ``blha_get_max_len``, ``block_multihead_attention``);
- ``entry.py``: the counterpart of ``__graft_entry__.entry()``;
- ``ops/kernels/``: the wrappers of the hand-written CUDA kernels in
  ``csrc/`` (flash attention forward and backward, decode attention
  against a contiguous cache, ragged paged decode, fused RoPE paged
  decode, flash chunk prefill and verify in a linear and a tree form,
  fused RMSNorm and SwiGLU, fused RoPE, decode attention over a
  head-major page pool), each beside its plain PyTorch version.

Entry points run on the card (``device="cuda"``, ``place=None``) unless
the caller asks for the CPU (``device="cpu"``, ``place="cpu"``); on the
CPU every kernel wrapper takes its plain version. The package imports
neither JAX nor ``paddle_tpu``.
"""
from ._core.autograd import no_grad  # noqa: F401
from ._core.random import get_rng_state, seed, set_rng_state  # noqa: F401
from ._core.tensor import Tensor, to_tensor  # noqa: F401
from .device import resolve_device  # noqa: F401
from .ops import _registry  # noqa: F401  (attaches the Tensor methods)
from . import nn  # noqa: F401,E402

__all__ = ["Tensor", "get_rng_state", "nn", "no_grad", "resolve_device",
           "seed", "set_rng_state", "to_tensor"]
