"""Primitive layers: fp32-island LayerNorm, QuickGELU, the packed-qkv
attention and MLP sub-blocks, residual blocks (with optional
cross-attention and KV-cached decode) and the Transformer.

Counterpart of ``vipant_tpu/nn/layers.py``. Parameter names are torch/CLIP's
(``attn.in_proj_weight`` [3C, C], ``attn.out_proj``, ``mlp.c_fc``,
``mlp.c_proj``, ``ln_1``, ``ln_2``; in a decoder block also ``ln_c`` and
``cross_attn.{q,k,v}_proj_weight``, ``cross_attn.in_proj_bias``,
``cross_attn.out_proj``), so a reference or CLIP state
dict loads with ``load_state_dict``. Parameters are fp32; the ops cast the
weight matrices to the activations' dtype at use, as the JAX package does.

The self-attention and MLP sub-blocks always run through the fused ops
(:mod:`..ops.fused_attn`, :mod:`..ops.fused_mlp`): the hand-written kernels
on a CUDA tensor, their plain versions on the CPU. Inside an
:func:`..ops.quant.int8_fwd_context` scope (int8 serving, a frozen int8
tower) both run their forward-only int8 variants. Cross-attention projects
q from x and k, v from the memory with ``F.linear`` (plain products outside
any kernel in the JAX package too) and attends through
:func:`..ops.attention.attention`, the hand-written flash kernels; it has no
int8 form. The single-position KV-cached decode paths attend with plain
products and a softmax, as the JAX package does there.

Not ported here: the layer-stacked ``StackedTransformer`` (pipeline and
sequence parallelism).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as attention_ops
from ..ops import fused_attn, fused_mlp
from ..ops.kernels import quick_gelu  # noqa: F401  (the MLP's activation, public here)
from ..ops.quant import int8_fwd_enabled


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal of variance 1 / fan_in truncated at
    two standard deviations."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


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


def _attend_one(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One query position against all of k, v: q [B, 1, H, D]; k, v
    [B, S, H, D] -> [B, 1, H*D]. fp32 scores and softmax, probabilities cast
    to v's dtype before p . v."""
    B, _, H, D = q.shape
    s = torch.matmul(q.transpose(1, 2).float(), k.permute(0, 2, 3, 1).float()) * (D ** -0.5)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v.transpose(1, 2)).transpose(1, 2).reshape(B, 1, H * D)


class MultiHeadAttention(nn.Module):
    """Multi-head attention in torch ``nn.MultiheadAttention``'s parameter
    scheme. As self-attention it is the pre-LN residual sub-block
    ``x + out_proj(attn(LN(x)))`` (the JAX module's ``ln_residual`` path) on
    the packed ``in_proj_weight`` [3C, C]. With ``cross=True`` it is
    cross-attention ``out_proj(attn(q(x), k(kv), v(kv)))`` without LN or
    residual and holds ``q_proj_weight``, ``k_proj_weight``,
    ``v_proj_weight`` [C, C] (torch's names when the three are separate)
    beside the packed ``in_proj_bias``: the JAX module's q, k and v are
    three leaves, and LARS scales each weight leaf by its own trust ratio,
    so one packed weight would train differently. ``n_layers`` sets CLIP's
    depth-scaled init of the out projection.

    ``decode_state`` switches to single-position cached decoding (x is
    [B, 1, C]) and makes the call return ``(out, new_state)``:
    self-attention takes ``{"k", "v": [B, L, H, D] caches, "pos": int}``,
    writes this position's k, v at ``pos`` and attends over positions
    ``<= pos``; cross-attention takes ``{"k", "v"}``, the projected memory,
    or None values to project it once and return it."""

    def __init__(self, width: int, heads: int, n_layers: int = 1, cross: bool = False,
                 clip_init: bool = True, device=None):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} is not divisible by {heads} heads")
        self.heads, self.n_layers, self.cross, self.clip_init = heads, n_layers, cross, clip_init
        if cross:
            for name in ("q_proj_weight", "k_proj_weight", "v_proj_weight"):
                setattr(self, name, nn.Parameter(torch.empty(width, width, device=device)))
        else:
            self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width, device=device))
        self.out_proj = nn.Linear(width, width, device=device)

    def _in_weights(self):
        if self.cross:
            return [self.q_proj_weight, self.k_proj_weight, self.v_proj_weight]
        return [self.in_proj_weight]

    def init_weights(self, generator: torch.Generator) -> None:
        d = self.out_proj.in_features
        if not self.clip_init:  # flax's lecun-normal default (the DeiT blocks)
            for w in self._in_weights() + [self.out_proj.weight]:
                lecun_normal_(w, d, generator)
        else:
            for w in self._in_weights():
                nn.init.normal_(w, std=d ** -0.5, generator=generator)
            nn.init.normal_(self.out_proj.weight, std=d ** -0.5 * (2 * self.n_layers) ** -0.5,
                            generator=generator)
        nn.init.zeros_(self.in_proj_bias)
        nn.init.zeros_(self.out_proj.bias)

    def _project(self, z: torch.Tensor, section: int) -> torch.Tensor:
        """Cross-attention: q (0), k (1) or v (2) projected from z,
        [B, T, H, D]; each has its own weight, so each is its own product."""
        C = self.out_proj.in_features
        w = self._in_weights()[section]
        b = self.in_proj_bias[section * C:(section + 1) * C]
        return F.linear(z, w.to(z.dtype), b.to(z.dtype)).view(*z.shape[:2], self.heads, C // self.heads)

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        return F.linear(o, self.out_proj.weight.to(o.dtype), self.out_proj.bias.to(o.dtype))

    def _decode_self(self, x, ln, state):
        h, C = ln(x), x.shape[-1]
        qkv = F.linear(h, self.in_proj_weight.to(h.dtype), self.in_proj_bias.to(h.dtype))
        q, k, v = qkv.view(*h.shape[:2], 3, self.heads, C // self.heads).unbind(dim=2)  # each [B, 1, H, D]
        pos = int(state["pos"])
        ck, cv = state["k"], state["v"]
        ck[:, pos], cv[:, pos] = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)
        # the cache past `pos` is not attended to (the JAX step masks it at -1e30: p = 0)
        out = x + self._out(_attend_one(q, ck[:, :pos + 1], cv[:, :pos + 1]))
        return out, {"k": ck, "v": cv, "pos": pos + 1}

    def _decode_cross(self, x, kv, state):
        if state.get("k") is None:
            mk, mv = self._project(kv, 1), self._project(kv, 2)
        else:
            mk, mv = state["k"], state["v"]
        q = self._project(x, 0)
        return self._out(_attend_one(q, mk, mv)), {"k": mk, "v": mv}

    def forward(self, x: torch.Tensor, ln: Optional[LayerNorm] = None,
                bias: Optional[torch.Tensor] = None, kv: Optional[torch.Tensor] = None,
                decode_state: Optional[dict] = None):
        if (kv is not None) != self.cross:
            raise ValueError("kv goes with a cross-attention module (cross=True), and only with one")
        if kv is not None:
            if ln is not None:
                raise ValueError("the pre-LN residual form is a self-attention feature")
            if decode_state is not None:
                return self._decode_cross(x, kv, decode_state)
            q, k, v = self._project(x, 0), self._project(kv, 1), self._project(kv, 2)
            o = attention_ops.attention(q, k, v, bias=bias)
            return self._out(o.reshape(*x.shape))
        if decode_state is not None:
            return self._decode_self(x, ln, decode_state)
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
                 n_layers: int = 1, clip_init: bool = True, device=None):
        super().__init__()
        self.act, self.n_layers, self.clip_init = act, n_layers, clip_init
        self.c_fc = nn.Linear(width, expansion * width, device=device)
        self.c_proj = nn.Linear(expansion * width, width, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        d = self.c_fc.weight.shape[1]
        if not self.clip_init:  # flax's lecun-normal default (the DeiT blocks)
            lecun_normal_(self.c_fc.weight, d, generator)
            lecun_normal_(self.c_proj.weight, self.c_proj.weight.shape[1], generator)
        else:
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
    """Pre-LN transformer block: x + attn(ln_1(x)); x + mlp(ln_2(x)). With
    ``cross_attn`` (the captioning decoder) x + cross_attn(ln_c(x), memory)
    comes between the two. With ``decode_state`` ``{"self", "mem"}`` it
    runs one cached decode position and returns ``(x, new_state)``."""

    def __init__(self, width: int, heads: int, act: str = "quick_gelu",
                 n_layers: int = 1, cross_attn: bool = False, clip_init: bool = True,
                 device=None):
        super().__init__()
        self.ln_1 = LayerNorm(width, device=device)
        self.attn = MultiHeadAttention(width, heads, n_layers=n_layers, clip_init=clip_init,
                                       device=device)
        if cross_attn:
            self.ln_c = LayerNorm(width, device=device)
            self.cross_attn = MultiHeadAttention(width, heads, n_layers=n_layers, cross=True,
                                                 device=device)
        else:
            self.cross_attn = None
        self.ln_2 = LayerNorm(width, device=device)
        self.mlp = MLP(width, act=act, n_layers=n_layers, clip_init=clip_init, device=device)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                memory: Optional[torch.Tensor] = None, decode_state: Optional[dict] = None):
        if self.cross_attn is not None and memory is None:
            raise ValueError("a cross-attention block requires memory")
        new_state = None
        if decode_state is not None:
            x, self_state = self.attn(x, self.ln_1, decode_state=decode_state["self"])
            new_state = {"self": self_state}
        else:
            x = self.attn(x, self.ln_1, bias)
        if self.cross_attn is not None:
            h = self.ln_c(x)
            if decode_state is not None:
                y, new_state["mem"] = self.cross_attn(h, kv=memory, decode_state=decode_state["mem"])
                x = x + y
            else:
                x = x + self.cross_attn(h, kv=memory)
        x = self.mlp(x, self.ln_2)
        return x if new_state is None else (x, new_state)


class Transformer(nn.Module):
    """A stack of residual attention blocks (``resblocks``, CLIP's name).
    ``decode_state`` is one state per block; the call then returns
    ``(x, new_states)``. A QuickGELU stack (CLIP's) draws CLIP's
    depth-scaled init, an exact-GELU one (DeiT's) flax's lecun-normal, as
    the JAX module does."""

    def __init__(self, width: int, layers: int, heads: int, act: str = "quick_gelu",
                 cross_attn: bool = False, device=None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, act=act, n_layers=layers, cross_attn=cross_attn,
                                   clip_init=act == "quick_gelu", device=device)
            for _ in range(layers)
        )

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                memory: Optional[torch.Tensor] = None, decode_state=None):
        if decode_state is None:
            for block in self.resblocks:
                x = block(x, bias, memory)
            return x
        new_states = []
        for block, state in zip(self.resblocks, decode_state):
            x, state = block(x, bias, memory, decode_state=state)
            new_states.append(state)
        return x, tuple(new_states)


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
