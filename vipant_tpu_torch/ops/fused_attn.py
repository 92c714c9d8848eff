"""The pre-LN attention sub-block ``x + proj(attn(LN(x)))``, forward only.

Port of the Pallas kernel ``vipant_tpu/ops/fused_attn.py::_fwd_kernel`` and
its public ops ``fused_ln_attention_block`` / ``fused_attention_block``. On
the TPU the whole sub-block ran in one VMEM-resident grid step per item. On
Hopper its [T, 3C] projection and [H, T, T] scores do not fit one block's
shared memory, so the sub-block is a chain of four hand-written kernels
(:mod:`.kernels`):

    h   = layernorm_fwd(x)                     (optional)
    qkv = gemm_bias_act(h, Wqkv, bqkv)         [B, T, 3C] bf16
    o   = attention_fwd(qkv, bias)             [B, T, C]  bf16
    out = gemm_bias_act(o, Wout, bout, residual=x)

Weights are in the torch ``nn.MultiheadAttention`` layout the port's modules
hold: ``wqkv`` [3C, C] (``in_proj_weight``), ``bqkv`` [3C], ``wout`` [C, C]
(``out_proj.weight``, [out, in]), ``bout`` [C]. The JAX package's [C, 3, C]
qkv layout exists for TPU head sharding and is not carried over.

``*_plain`` compose the kernels' plain versions: the same function, for
holding the kernels to on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels
from .kernels import LAUNCHES


def canon_bias(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """fp32, with -inf clamped to -1e30 so a causal (-inf) plus packing
    (-1e30) mask stays finite and no softmax row turns NaN."""
    if bias is None:
        return None
    return torch.clamp(bias.float(), min=-1e30).contiguous()


def _block(ops, x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads):
    layernorm, gemm, attention = ops
    dt = x.dtype
    h = layernorm(x, lns.float(), lnb.float()) if lns is not None else x
    qkv = gemm(h, wqkv.to(dt).contiguous(), bqkv.float())
    o = attention(qkv, canon_bias(bias), heads, 1.0 / float((x.shape[-1] // heads) ** 0.5))
    return gemm(o, wout.to(dt).contiguous(), bout.float(),
                residual=x if lns is not None else None)


_KERNELS = (kernels.layernorm_fwd, kernels.gemm_bias_act, kernels.attention_fwd)
_PLAIN = (kernels.layernorm_plain, kernels.gemm_bias_act_plain, kernels.attention_plain)


class _FusedAttention(torch.autograd.Function):
    """Autograd boundary of the kernel chain. The backward is the port of
    the Pallas ``_bwd_kernel``, which is not written yet."""

    @staticmethod
    def forward(ctx, x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads):
        out = _block(_KERNELS, x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads)
        if x.is_cuda:
            LAUNCHES["fused_ln_attention_block" if lns is not None else "fused_attention_block"] += 1
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("backward kernel lands with training")


def fused_ln_attention_block(
    x: torch.Tensor,
    lns: torch.Tensor,
    lnb: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    heads: int = 12,
) -> torch.Tensor:
    """x + proj(attn(LN(x))). x: [B, T, C]; lns/lnb: LayerNorm [C];
    bias: optional additive [T, T]. Returns [B, T, C] in x's dtype."""
    return _FusedAttention.apply(x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads)


def fused_attention_block(
    x: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    heads: int = 12,
) -> torch.Tensor:
    """proj(attn(x)): the packed attention without LN or residual."""
    return _FusedAttention.apply(x, None, None, wqkv, bqkv, wout, bout, bias, heads)


def fused_ln_attention_block_plain(x, lns, lnb, wqkv, bqkv, wout, bout, bias=None, heads=12):
    return _block(_PLAIN, x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads)


def fused_attention_block_plain(x, wqkv, bqkv, wout, bout, bias=None, heads=12):
    return _block(_PLAIN, x, None, None, wqkv, bqkv, wout, bout, bias, heads)
