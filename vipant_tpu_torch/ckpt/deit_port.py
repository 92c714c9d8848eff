"""timm DeiT ("meme") state dict -> the port's :class:`..nn.deit.DeiTTower`.

Counterpart of ``vipant_tpu/ckpt/deit_port.py``: a timm
``deit_base_distilled_patch16_224`` state dict (the reference's torch.hub
load, `reference/cvap/model/helper.py:52-63`) renamed to the tower's
parameters. Three tensors change on the way: the positional embedding is
re-gridded bilinearly from timm's square grid to the tower's (the class and
distillation rows pass through, no slice); the patch kernel is resized to
the tower's patch and, for a 1-channel tower, replaced by its channel mean;
the classification heads map only when their width is the tower's
``embed_dim``, else they take the JAX porter's seeded draw
(``np.random.default_rng(0)``, ``head`` then ``head_dist``), so both
packages port a file to the same weights. Every other tensor is the file's,
bitwise.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..ops.interp import interp_conv_kernel_spatial, slice_or_interp_pos_grid
from .clip_port import StateDict, as_tensor

# timm's names inside a block -> the port's (nn/layers.py)
_BLOCK = {
    "attn.qkv.weight": "attn.in_proj_weight", "attn.qkv.bias": "attn.in_proj_bias",
    "attn.proj.weight": "attn.out_proj.weight", "attn.proj.bias": "attn.out_proj.bias",
    "norm1.weight": "ln_1.weight", "norm1.bias": "ln_1.bias",
    "norm2.weight": "ln_2.weight", "norm2.bias": "ln_2.bias",
    "mlp.fc1.weight": "mlp.c_fc.weight", "mlp.fc1.bias": "mlp.c_fc.bias",
    "mlp.fc2.weight": "mlp.c_proj.weight", "mlp.fc2.bias": "mlp.c_proj.bias",
}
_BLOCK_RE = re.compile(r"^blocks\.(\d+)\.(.+)$")


def port_deit(sd: Mapping[str, Any], tower) -> StateDict:
    """A timm DeiT state dict -> the state dict of ``tower``."""
    sd = {k: as_tensor(v) for k, v in sd.items()}
    out: StateDict = {}
    for k, v in sd.items():
        m = _BLOCK_RE.match(k)
        if m is not None and m.group(2) in _BLOCK:
            out[f"blocks.resblocks.{int(m.group(1))}.{_BLOCK[m.group(2)]}"] = v
    pos = sd["pos_embed"]
    pos = pos[0] if pos.dim() == 3 else pos
    s = int(round(np.sqrt(pos.shape[0] - 2)))
    out["pos_embed"] = slice_or_interp_pos_grid(pos, (s, s), tower.grid, n_prefix=2, use_slice=False)
    kernel = interp_conv_kernel_spatial(sd["patch_embed.proj.weight"], tower.patch_hw)
    if kernel.shape[1] != tower.in_channels:
        if tower.in_channels != 1:
            raise ValueError(f"a {kernel.shape[1]}-channel patch kernel into a "
                             f"{tower.in_channels}-channel tower")
        kernel = kernel.mean(dim=1, keepdim=True)  # the log-mel "image": one channel
    out["patch_embed.weight"] = kernel
    out["patch_embed.bias"] = sd["patch_embed.proj.bias"]
    out["cls_token"] = sd["cls_token"].reshape(-1)
    out["dist_token"] = sd["dist_token"].reshape(-1)
    out["norm.weight"], out["norm.bias"] = sd["norm.weight"], sd["norm.bias"]
    head = sd.get("head.weight")
    if head is not None and head.shape[0] == tower.embed_dim:
        out["head"], out["head_dist"] = head.t(), sd["head_dist.weight"].t()
    else:  # timm's 1000-class heads do not fit: the JAX porter's seeded init
        rng, scale = np.random.default_rng(0), tower.width ** -0.5
        for name in ("head", "head_dist"):
            draw = scale * rng.standard_normal((tower.width, tower.embed_dim))
            out[name] = torch.from_numpy(draw.astype(np.float32))
    return out
