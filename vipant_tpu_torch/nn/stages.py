"""MetaHead encoder stages: ``pre_encoder -> pre_addon -> encoder ->
post_addon -> post_encoder`` plus the ``misc`` parameter container.

Counterpart of ``vipant_tpu/nn/stages.py`` for the ViT and GPT towers. The
stage names are the parameter prefixes of the reference's MetaHead state
dicts (``misc.positional_embedding``, ``pre_encoder.conv1.weight``,
``encoder.resblocks.{i}...``, ``post_encoder.proj``), which
``ckpt/reference_export.py`` emits from the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.interp import interp_pos_grid
from ..ops.patches import patchify_embed
from .layers import LayerNorm, Transformer, causal_mask, lecun_normal_


def to_2tuple(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def vit_grid(resolution, patch_size, stride=None):
    """(grid_hw, patch_hw, stride_hw) for a (possibly rectangular) ViT input.

    A square int resolution with a square, non-overlapping patch divides
    evenly (CLIP); anything else, including a non-square patch or a custom
    stride on a square input, uses the overlapping-stride formula of the
    reference's audio tower."""
    patch_hw = to_2tuple(patch_size)
    stride_hw = to_2tuple(stride) if stride is not None else patch_hw
    if isinstance(resolution, int) and stride_hw == patch_hw and patch_hw[0] == patch_hw[1]:
        n = resolution // patch_hw[0]
        return (n, n), patch_hw, stride_hw
    res = to_2tuple(resolution)
    nrow = (res[0] - patch_hw[0]) // stride_hw[0] + 1
    ncol = (res[1] - patch_hw[1]) // stride_hw[1] + 1
    return (nrow, ncol), patch_hw, stride_hw


class AddonEncoder(nn.Module):
    """Identity enhancement hook between stages."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class CLIPMisc(nn.Module):
    """Positional (+ class) embeddings. ``stored_grid`` is the grid the
    parameters are held at, ``target_grid`` the one the tower runs at; the
    embedding is re-gridded bilinearly when they differ. ``stored_grid=None``
    is sequence mode (text, ``seq_len`` positions, no class embedding)."""

    def __init__(self, width: int, stored_grid: Optional[Tuple[int, int]] = None,
                 target_grid: Optional[Tuple[int, int]] = None, seq_len: int = 0,
                 device=None):
        super().__init__()
        self.width, self.stored_grid = width, stored_grid
        self.target_grid = target_grid or stored_grid
        n = seq_len if stored_grid is None else stored_grid[0] * stored_grid[1] + 1
        self.positional_embedding = nn.Parameter(torch.empty(n, width, device=device))
        if stored_grid is not None:
            self.class_embedding = nn.Parameter(torch.empty(width, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        for p in self.parameters(recurse=False):
            nn.init.normal_(p, std=self.width ** -0.5, generator=generator)

    def forward(self):
        if self.stored_grid is None:
            return self.positional_embedding, None
        pos = interp_pos_grid(self.positional_embedding, self.stored_grid, self.target_grid)
        return pos, self.class_embedding


class ViTPreEncoder(nn.Module):
    """Patchify (conv without bias, as im2col + matmul) + class token +
    positional embedding + ln. A 1-channel log-mel input against the
    3-channel kernel uses the kernel's channel mean, taken at every forward
    (the reference's visual-knowledge-transfer trick)."""

    def __init__(self, width: int, patch_size, stride, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.width, self.dtype = width, dtype
        self.patch_hw, self.stride_hw = to_2tuple(patch_size), to_2tuple(stride)
        self.conv1 = nn.Conv2d(in_channels, width, self.patch_hw, self.stride_hw,
                               bias=False, device=device)
        self.ln = LayerNorm(width, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.conv1.weight, self.conv1.weight[0].numel(), generator)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
        """x: [B, C, H, W] -> [B, 1 + grid, width]."""
        if x.dim() != 4:
            raise ValueError(f"expected a 4-d input, got {tuple(x.shape)}")
        w = self.conv1.weight
        if x.shape[1] != w.shape[1]:  # channel mismatch -> mean-collapse
            w = w.mean(dim=1, keepdim=True)
        h = patchify_embed(x.to(self.dtype), w.to(self.dtype), self.patch_hw, self.stride_hw)
        B = h.shape[0]
        c = cls.to(self.dtype).expand(B, 1, self.width)
        h = torch.cat([c, h], dim=1)
        h = h + pos[: h.shape[1]].to(self.dtype)
        return self.ln(h)


class ViTPostEncoder(nn.Module):
    """ln on the class token + projection to the joint space. With
    ``require_feature`` the ln runs over all tokens and the call returns
    ``(embedding, feature)``, the patch tokens as [B, grid_h, grid_w, width]
    when ``grid`` is given: the captioning decoder's memory."""

    def __init__(self, width: int, embed_dim: int, device=None):
        super().__init__()
        self.width = width
        self.ln = LayerNorm(width, device=device)
        self.proj = nn.Parameter(torch.empty(width, embed_dim, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.proj, std=self.width ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor, require_feature: bool = False,
                grid: Optional[Tuple[int, int]] = None):
        if require_feature:
            x = self.ln(x)
            emb = x[:, 0, :] @ self.proj.to(x.dtype)
            feature = x[:, 1:]
            if grid is not None:
                feature = feature.reshape(x.shape[0], grid[0], grid[1], x.shape[-1])
            return emb, feature
        x = self.ln(x[:, 0, :])
        return x @ self.proj.to(x.dtype)


class GPTPreEncoder(nn.Module):
    """Token + positional embedding; also returns the EOT index (argmax of
    the ids: EOT is the largest token id)."""

    def __init__(self, vocab_size: int, width: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, width, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.token_embedding.weight, std=0.02, generator=generator)

    def forward(self, ids: torch.Tensor, pos: torch.Tensor):
        eot_idx = torch.argmax(ids, dim=-1)
        x = self.token_embedding(ids).to(self.dtype)
        x = x + pos[: x.shape[1]].to(self.dtype)
        return x, eot_idx


class GPTPostEncoder(nn.Module):
    """Final ln over all tokens, gather the EOT position, project."""

    def __init__(self, width: int, embed_dim: int, device=None):
        super().__init__()
        self.width = width
        self.ln = LayerNorm(width, device=device)
        self.proj = nn.Parameter(torch.empty(width, embed_dim, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.proj, std=self.width ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor, eot_idx: torch.Tensor) -> torch.Tensor:
        x = self.ln(x)
        x = x[torch.arange(x.shape[0], device=x.device), eot_idx]
        return x @ self.proj.to(x.dtype)


class TransformerBackbone(Transformer):
    """The shared transformer trunk; ``use_attn_mask`` adds the causal text
    mask, which composes with an ``attn_bias`` (token packing) by addition."""

    def __init__(self, layers: int, width: int, heads: int, use_attn_mask: bool = False,
                 device=None):
        super().__init__(width, layers, heads, device=device)
        self.use_attn_mask = use_attn_mask

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        mask = causal_mask(x.shape[1], device=x.device) if self.use_attn_mask else None
        if attn_bias is not None:
            mask = attn_bias if mask is None else mask + attn_bias
        return super().forward(x, mask)
