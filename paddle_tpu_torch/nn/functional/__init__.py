"""``paddle.nn.functional`` for the port: the attention functionals
(``attention.py``). The rest of the reference's functionals wait for
ROADMAP.md queue A step 9b."""
from .attention import (  # noqa: F401
    flash_attention, scaled_dot_product_attention, flash_attn_unpadded,
    sdp_kernel, flash_attn_qkvpacked, flash_attn_varlen_qkvpacked,
    flashmask_attention,
)
