"""ViT patch embedding as one patch gather plus one matrix product.

Counterpart of ``vipant_tpu/ops/patches.py::patchify_embed`` (an XLA
dot_general on the TPU, not a Pallas kernel): ``kernels.patch_gather`` cuts
the (possibly overlapping) patches in the weight's dtype, in ``F.unfold``'s
layout, and one product with the flattened conv weight embeds them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import kernels


def patchify_embed(
    x: torch.Tensor,
    weight: torch.Tensor,
    patch_hw: Tuple[int, int],
    stride_hw: Tuple[int, int],
) -> torch.Tensor:
    """x [B, Cin, H, W] . weight [D, Cin, ph, pw] (OIHW) -> [B, nrow*ncol, D],
    patches in row-major grid order, x rounded to the weight's dtype.

    The patches are flattened in (c, h, w) order, which is the order of an
    OIHW weight reshaped to [D, Cin*ph*pw]; the JAX package flattens (h, w,
    c) against an HWIO kernel, and the weight bridge (``ckpt.from_jax``)
    does the reordering, so the data is never permuted. The product takes
    the patches through their transposed view, as it took ``F.unfold``'s
    output: cuBLAS then picks the same algorithm and gives the same bits.
    """
    cols = kernels.patch_gather(x, patch_hw, stride_hw, weight.dtype)  # [B, Cin*ph*pw, L]
    return torch.matmul(cols.transpose(1, 2), weight.reshape(weight.shape[0], -1).t())
