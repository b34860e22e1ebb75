"""Wrappers of the port's hand-written CUDA kernels (``csrc/``), each
beside its plain PyTorch version and with a launch counter."""
from typing import Dict

from . import (flash_attention, fused, paged_attention,  # noqa: F401
               serving_fused)

#: every kernel wrapper of the port, by its TPU kernel's number
WRAPPERS = {
    "B1": flash_attention.flash_fwd,
    "B2": flash_attention.flash_bwd_dkv,
    "B3": flash_attention.flash_bwd_dq,
    "B4a": fused.rms_fwd,
    "B4b": fused.rms_bwd,
    "B5a": fused.swiglu_fwd,
    "B5b": fused.swiglu_bwd,
    "B6": fused.rope_apply,
    "B7": fused.decode_attention,
    "B8": fused.paged_decode_attention,
    "B9": paged_attention.paged_attention,
    "B10": serving_fused.fused_paged_decode_attention,
    "B11": serving_fused.flash_chunk_attention,
    "B11-tree": serving_fused.flash_chunk_tree_attention,
}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k: fn.launches for k, fn in WRAPPERS.items()}
