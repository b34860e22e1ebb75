"""PyTorch/CUDA port of paddle_tpu's serving path and training step.

The JAX package ``paddle_tpu`` stays the reference; this package holds
its counterpart for an NVIDIA H100, module for module:

- ``models/llama.py``: the Llama config, parameters and model (forward,
  remat, the chunked next-token loss);
- ``models/train.py``: the single-device training step (AdamW on f32
  master weights, global-norm clip);
- ``models/generate.py``: the paged prefill-chunk / ragged decode
  forwards;
- ``serving/paged_cache.py``: the refcounted page allocator, the
  prefix trie and the device page pools;
- ``inference/predictor.py``: the continuous-batching engine;
- ``entry.py``: the counterpart of ``__graft_entry__.entry()``;
- ``ops/kernels/``: the wrappers of the hand-written CUDA kernels in
  ``csrc/`` (flash attention forward and backward, ragged paged decode,
  fused RoPE paged decode, flash chunk prefill), each beside its plain
  PyTorch version.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``); on the CPU every kernel wrapper takes
its plain version. The package imports neither JAX nor ``paddle_tpu``.
"""
from .device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
