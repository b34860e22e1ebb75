"""``paddle.nn`` for the port (counterpart of ``paddle_tpu/nn``).

Only the attention functionals are ported (``nn.functional``); the
layers (``Layer``, ``Linear``, ``LayerNorm``, ``MultiHeadAttention``,
``Transformer*``) and the initializers wait for ROADMAP.md queue A step
9b.
"""
from . import functional  # noqa: F401
