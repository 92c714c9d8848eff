"""Operators of the port: the hand-written CUDA kernels' wrappers
(:mod:`.kernels`), the fused transformer sub-blocks built from them
(:mod:`.fused_attn`, :mod:`.fused_mlp`), bf16 and forward-only int8,
attention on separate q, k, v with its dispatcher (:mod:`.attention`), the
int8 scope and plain quantizers (:mod:`.quant`), plain-PyTorch helpers
(:mod:`.patches`, :mod:`.interp`), and the host Kaldi fbank of the data
loader (:mod:`.fbank_np`, :mod:`.mel`: NumPy only).

Importing builds nothing: the kernels are compiled at their first launch
(:mod:`._build`). The names below are imported at first use, so that the
data loader's worker processes reach :mod:`.fbank_np` without importing
torch or the kernels."""

import importlib

_EXPORTS = {  # name -> submodule; not `attention`: that name is the submodule's
    "flash_attention": "attention",
    "fused_attention_block": "fused_attn",
    "fused_attention_block_int8": "fused_attn",
    "fused_ln_attention_block": "fused_attn",
    "fused_ln_attention_block_int8": "fused_attn",
    "fused_ln_mlp_block": "fused_mlp",
    "fused_ln_mlp_block_int8": "fused_mlp",
    "LAUNCHES": "kernels",
    "reset_launches": "kernels",
    "int8_fwd_context": "quant",
    "int8_fwd_enabled": "quant",
    "quantize_cols": "quant",
    "quantize_rows": "quant",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
