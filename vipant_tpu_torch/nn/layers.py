"""Primitive layers: fp32-island LayerNorm, QuickGELU, the packed-qkv
self-attention and MLP sub-blocks, residual blocks and the Transformer.

Counterpart of ``vipant_tpu/nn/layers.py`` for the forward path. Parameter
names are torch/CLIP's (``attn.in_proj_weight`` [3C, C], ``attn.out_proj``,
``mlp.c_fc``, ``mlp.c_proj``, ``ln_1``, ``ln_2``), so a reference or CLIP
state dict loads with ``load_state_dict``. Parameters are fp32; the fused
ops cast the weight matrices to the activations' dtype at use, as the JAX
package does. Both sub-blocks always run through the fused ops
(:mod:`..ops.fused_attn`, :mod:`..ops.fused_mlp`): the hand-written kernels
on a CUDA tensor, their plain versions on the CPU. Inside an
:func:`..ops.quant.int8_fwd_context` scope (int8 serving, a frozen int8
tower) both run their forward-only int8 variants.

Not ported here: cross-attention, KV-cached decode and the layer-stacked
``StackedTransformer`` (captioning and pipeline parallelism).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops import fused_attn, fused_mlp
from ..ops.kernels import quick_gelu  # noqa: F401  (the MLP's activation, public here)
from ..ops.quant import int8_fwd_enabled


class LayerNorm(nn.Module):
    """LayerNorm with fp32 parameters and statistics; the output is cast back
    to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, unbiased=False, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Packed-qkv self-attention as the pre-LN residual sub-block
    ``x + out_proj(attn(LN(x)))`` (the JAX module's ``ln_residual`` path).
    ``n_layers`` sets CLIP's depth-scaled init of the out projection."""

    def __init__(self, width: int, heads: int, n_layers: int = 1, device=None):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} is not divisible by {heads} heads")
        self.heads, self.n_layers = heads, n_layers
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width, device=device))
        self.out_proj = nn.Linear(width, width, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        d = self.in_proj_weight.shape[1]
        nn.init.normal_(self.in_proj_weight, std=d ** -0.5, generator=generator)
        nn.init.normal_(self.out_proj.weight, std=d ** -0.5 * (2 * self.n_layers) ** -0.5,
                        generator=generator)
        nn.init.zeros_(self.in_proj_bias)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor, ln: LayerNorm,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        block = (fused_attn.fused_ln_attention_block_int8 if int8_fwd_enabled()
                 else fused_attn.fused_ln_attention_block)
        return block(
            x, ln.weight, ln.bias, self.in_proj_weight, self.in_proj_bias,
            self.out_proj.weight, self.out_proj.bias, bias=bias, heads=self.heads,
        )


class MLP(nn.Module):
    """4x-expansion MLP as the pre-LN residual sub-block
    ``x + c_proj(act(c_fc(LN(x))))``; act is QuickGELU (CLIP) or exact GELU."""

    def __init__(self, width: int, expansion: int = 4, act: str = "quick_gelu",
                 n_layers: int = 1, device=None):
        super().__init__()
        self.act, self.n_layers = act, n_layers
        self.c_fc = nn.Linear(width, expansion * width, device=device)
        self.c_proj = nn.Linear(expansion * width, width, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        d = self.c_fc.weight.shape[1]
        nn.init.normal_(self.c_fc.weight, std=(2 * d) ** -0.5, generator=generator)
        nn.init.normal_(self.c_proj.weight, std=d ** -0.5 * (2 * self.n_layers) ** -0.5,
                        generator=generator)
        nn.init.zeros_(self.c_fc.bias)
        nn.init.zeros_(self.c_proj.bias)

    def forward(self, x: torch.Tensor, ln: LayerNorm) -> torch.Tensor:
        block = (fused_mlp.fused_ln_mlp_block_int8 if int8_fwd_enabled()
                 else fused_mlp.fused_ln_mlp_block)
        return block(
            x, ln.weight, ln.bias, self.c_fc.weight, self.c_fc.bias,
            self.c_proj.weight, self.c_proj.bias, act=self.act,
        )


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block: x + attn(ln_1(x)); x + mlp(ln_2(x))."""

    def __init__(self, width: int, heads: int, act: str = "quick_gelu",
                 n_layers: int = 1, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(width, device=device)
        self.attn = MultiHeadAttention(width, heads, n_layers=n_layers, device=device)
        self.ln_2 = LayerNorm(width, device=device)
        self.mlp = MLP(width, act=act, n_layers=n_layers, device=device)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.attn(x, self.ln_1, bias)
        return self.mlp(x, self.ln_2)


class Transformer(nn.Module):
    """A stack of residual attention blocks (``resblocks``, CLIP's name)."""

    def __init__(self, width: int, layers: int, heads: int, act: str = "quick_gelu",
                 device=None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, act=act, n_layers=layers, device=device)
            for _ in range(layers)
        )

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, bias)
        return x


def causal_mask(n: int, device=None) -> torch.Tensor:
    """Additive [n, n] causal mask (-inf above the diagonal)."""
    return torch.triu(torch.full((n, n), -math.inf, device=device), diagonal=1)


def pack_tokens(h: torch.Tensor, k: int):
    """([B, T, C], k) -> ([B/k, kT, C], additive [kT, kT] block-diagonal
    mask): attention behind the mask is exactly k separate attentions
    (softmax rows never mix items; LayerNorm and MLP are token-wise)."""
    B, T, C = h.shape
    if B % k:
        raise ValueError(f"batch {B} not divisible by pack {k}")
    eye = torch.eye(k, device=h.device)
    bias = torch.kron(1.0 - eye, torch.ones(T, T, device=h.device)) * -1e30
    return h.reshape(B // k, k * T, C), bias
