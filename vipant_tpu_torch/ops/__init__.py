"""Operators of the port: the hand-written CUDA kernels' wrappers
(:mod:`.kernels`), the fused transformer sub-blocks built from them
(:mod:`.fused_attn`, :mod:`.fused_mlp`), bf16 and forward-only int8,
attention on separate q, k, v with its dispatcher (:mod:`.attention`), the
int8 scope and plain quantizers (:mod:`.quant`), and plain-PyTorch helpers
(:mod:`.patches`, :mod:`.interp`). Importing builds nothing: the kernels
are compiled at their first launch (:mod:`._build`)."""

from .attention import flash_attention  # not `attention`: the name is the submodule's
from .fused_attn import (
    fused_attention_block,
    fused_attention_block_int8,
    fused_ln_attention_block,
    fused_ln_attention_block_int8,
)
from .fused_mlp import fused_ln_mlp_block, fused_ln_mlp_block_int8
from .kernels import LAUNCHES, reset_launches
from .quant import int8_fwd_context, int8_fwd_enabled, quantize_cols, quantize_rows

__all__ = [
    "LAUNCHES",
    "flash_attention",
    "fused_attention_block",
    "fused_attention_block_int8",
    "fused_ln_attention_block",
    "fused_ln_attention_block_int8",
    "fused_ln_mlp_block",
    "fused_ln_mlp_block_int8",
    "int8_fwd_context",
    "int8_fwd_enabled",
    "quantize_cols",
    "quantize_rows",
    "reset_launches",
]
