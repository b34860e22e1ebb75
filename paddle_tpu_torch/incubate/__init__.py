"""``paddle.incubate`` of the port: the fused serving ops of
``incubate.nn.functional`` (counterpart of ``paddle_tpu/incubate``).
The rest of the reference's ``incubate`` (its layers, MoE, optimizers,
ASP, ...) is not ported yet: ROADMAP.md, queue A step 9b."""
from . import nn  # noqa: F401
