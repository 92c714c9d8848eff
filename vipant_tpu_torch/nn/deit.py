"""The DeiT tower: a distilled ViT whose class and distillation tokens are
projected by twin heads and averaged.

Counterpart of ``vipant_tpu/nn/deit.py``: the patch embedding with its own
stride and a bias (the kernel's channel mean when the input has fewer
channels), the class and distillation tokens, a positional embedding over
both and the grid, twelve exact-GELU pre-LN blocks, the final ``norm``, and
``head`` / ``head_dist`` [width, embed_dim] averaged. The blocks are the
port's :class:`.layers.Transformer` with ``act="gelu"``, so every block runs
the attention and MLP sub-blocks on the hand-written kernels (the GELU and
GELU' epilogues of ``gemm_bias_act`` / ``gemm_dgrad``).

The LayerNorms keep the JAX package's eps of 1e-5, not timm's 1e-6: the
port follows the JAX package, which the CPU tests hold it to.

Parameter names: ``patch_embed.weight`` (OIHW) and ``patch_embed.bias``,
``cls_token``, ``dist_token``, ``pos_embed`` [N + 2, width],
``blocks.resblocks.{i}...`` (the port's block names), ``norm``, ``head``,
``head_dist``. :mod:`..ckpt.deit_port` loads a timm
``deit_base_distilled_patch16_224`` state dict into them.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.patches import patchify_embed
from .layers import LayerNorm, Transformer, lecun_normal_
from .stages import to_2tuple, vit_grid


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, width: int, patch_hw: Tuple[int, int], device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(width, in_channels, *patch_hw, device=device))
        self.bias = nn.Parameter(torch.zeros(width, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)


class DeiTTower(nn.Module):
    backbone = "deit"

    def __init__(self, width: int = 768, embed_dim: int = 512, resolution=224, patch_size=16,
                 stride=None, in_channels: int = 3, heads: int = 12, layers: int = 12,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.width, self.embed_dim, self.dtype = width, embed_dim, dtype
        self.resolution, self.in_channels = resolution, in_channels
        self.grid, self.patch_hw, self.stride_hw = vit_grid(resolution, patch_size, stride)
        n = self.grid[0] * self.grid[1]
        self.patch_embed = PatchEmbed(in_channels, width, self.patch_hw, device=device)
        self.cls_token = nn.Parameter(torch.empty(width, device=device))
        self.dist_token = nn.Parameter(torch.empty(width, device=device))
        self.pos_embed = nn.Parameter(torch.empty(n + 2, width, device=device))
        self.blocks = Transformer(width, layers, heads, act="gelu", device=device)
        self.norm = LayerNorm(width, device=device)
        self.head = nn.Parameter(torch.empty(width, embed_dim, device=device))
        self.head_dist = nn.Parameter(torch.empty(width, embed_dim, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        for p in (self.cls_token, self.dist_token, self.pos_embed):
            nn.init.normal_(p, std=0.02, generator=generator)
        for p in (self.head, self.head_dist):
            nn.init.normal_(p, std=self.width ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False, normalized: bool = False,
                require_feature: bool = False) -> torch.Tensor:
        from .heads import normalize

        if require_feature:
            raise NotImplementedError("require_feature is ViT-only")
        w = self.patch_embed.weight
        if x.shape[1] != w.shape[1]:  # channel collapse
            w = w.mean(dim=1, keepdim=True)
        h = patchify_embed(x.to(self.dtype), w.to(self.dtype), self.patch_hw, self.stride_hw)
        h = h + self.patch_embed.bias.to(self.dtype)
        B, _, D = h.shape
        prefix = torch.stack([self.cls_token, self.dist_token]).to(self.dtype)
        h = torch.cat([prefix.expand(B, 2, D), h], dim=1) + self.pos_embed.to(self.dtype)
        h = self.norm(self.blocks(h))
        out = 0.5 * (h[:, 0] @ self.head.to(h.dtype) + h[:, 1] @ self.head_dist.to(h.dtype))
        return normalize(out) if normalized else out


def deit_from_cfg(cfg, dtype=torch.float32, device=None) -> DeiTTower:
    """``model.image`` / ``model.audio`` of a DeiT head -> the tower; the
    patch, stride and channels from ``pre_encoder`` when there is one, else
    from the top level, where ``deit.yaml`` spells the channels
    ``in_channels`` and the reference's legacy file ``in_channel``."""
    resolution = cfg.resolution
    if isinstance(resolution, list):
        resolution = tuple(int(v) for v in resolution)
    pre = cfg.get("pre_encoder", None)
    src = pre if pre is not None else cfg
    in_ch = (pre.get("in_channels", 3) if pre is not None
             else cfg.get("in_channels", cfg.get("in_channel", 3)))
    stride = src.get("stride", None)
    return DeiTTower(
        width=int(cfg.width), embed_dim=int(cfg.embed_dim), resolution=resolution,
        patch_size=to_2tuple(src.get("patch_size", 16)),
        stride=None if stride is None else to_2tuple(stride), in_channels=int(in_ch),
        heads=int(cfg.get("heads", 12)),
        layers=int(cfg.encoder.layers if "encoder" in cfg else cfg.get("layers", 12)),
        dtype=dtype, device=device)
