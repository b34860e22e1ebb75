"""``paddle.incubate.nn`` of the port: ``functional`` only (the fused
layers of ``paddle_tpu/incubate/nn/layer.py`` wait for ROADMAP.md queue
A step 9b)."""
from . import functional  # noqa: F401
