"""Operators of the port: the hand-written CUDA kernels' wrappers
(:mod:`.kernels`), the fused transformer sub-blocks built from them
(:mod:`.fused_attn`, :mod:`.fused_mlp`), and plain-PyTorch helpers
(:mod:`.patches`, :mod:`.interp`). Importing builds nothing: the kernels
are compiled at their first launch (:mod:`._build`)."""

from .fused_attn import fused_attention_block, fused_ln_attention_block
from .fused_mlp import fused_ln_mlp_block
from .kernels import LAUNCHES, reset_launches

__all__ = [
    "LAUNCHES",
    "fused_attention_block",
    "fused_ln_attention_block",
    "fused_ln_mlp_block",
    "reset_launches",
]
