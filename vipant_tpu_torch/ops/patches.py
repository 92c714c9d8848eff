"""ViT patch embedding as im2col plus one matrix product.

Counterpart of ``vipant_tpu/ops/patches.py::patchify_embed`` (an XLA
dot_general on the TPU, not a Pallas kernel): ``F.unfold`` cuts the
(possibly overlapping) patches, and one product with the flattened conv
weight embeds them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def patchify_embed(
    x: torch.Tensor,
    weight: torch.Tensor,
    patch_hw: Tuple[int, int],
    stride_hw: Tuple[int, int],
) -> torch.Tensor:
    """x [B, Cin, H, W] . weight [D, Cin, ph, pw] (OIHW) -> [B, nrow*ncol, D],
    patches in row-major grid order.

    ``F.unfold`` flattens each patch in (c, h, w) order, which is the order
    of an OIHW weight reshaped to [D, Cin*ph*pw]; the JAX package flattens
    (h, w, c) against an HWIO kernel, and the weight bridge
    (``ckpt.from_jax``) does the reordering, so the data is never permuted.
    """
    cols = F.unfold(x, kernel_size=patch_hw, stride=stride_hw)  # [B, Cin*ph*pw, L]
    return torch.matmul(cols.transpose(1, 2), weight.reshape(weight.shape[0], -1).t())
