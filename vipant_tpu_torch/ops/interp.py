"""Positional-embedding and patch-kernel grid retargets.

Counterpart of ``vipant_tpu/ops/interp.py``: the JAX package uses
``jax.image.resize(bilinear, antialias=False)``, which is the half-pixel
sampling of torch's ``F.interpolate(mode="bilinear", align_corners=False)``
used here. :func:`interp_pos_grid` runs inside the tower's forward;
:func:`slice_or_interp_pos_grid` and :func:`interp_conv_kernel_spatial` run
once, at checkpoint load time, on CPU tensors (:mod:`..ckpt.clip_port`).
The two resizes agree to fp32 rounding, not bitwise (max |d| about 1e-6
on a 7x7 -> 61x5 grid, 7e-6 on a 32x32 -> 40x40 kernel).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def interp_pos_grid(
    pos: torch.Tensor, old_hw: Tuple[int, int], new_hw: Tuple[int, int], n_prefix: int = 1
) -> torch.Tensor:
    """pos: [n_prefix + old_h*old_w, D] -> [n_prefix + new_h*new_w, D]; the
    leading ``n_prefix`` rows (class token) pass through. Identity when the
    grids match."""
    if tuple(old_hw) == tuple(new_hw):
        return pos
    prefix, grid = pos[:n_prefix], pos[n_prefix:]
    d = grid.shape[-1]
    grid = grid.reshape(1, old_hw[0], old_hw[1], d).permute(0, 3, 1, 2)  # [1, D, H, W]
    grid = F.interpolate(grid, size=tuple(new_hw), mode="bilinear", align_corners=False)
    grid = grid[0].permute(1, 2, 0).reshape(new_hw[0] * new_hw[1], d)
    return torch.cat([prefix, grid], dim=0)


def slice_or_interp_pos_grid(
    pos: torch.Tensor,
    old_hw: Tuple[int, int],
    new_hw: Tuple[int, int],
    n_prefix: int = 1,
    use_slice: bool = True,
    time_offset_rows: int = 6,
) -> torch.Tensor:
    """Load-time retarget with the reference's slice-first policy
    (``vipant_tpu/ops/interp.py:45-71``): when only the time axis shrinks
    and the freq axis matches, take a window of rows starting
    ``time_offset_rows`` rows in; otherwise bilinear-interpolate."""
    if tuple(old_hw) == tuple(new_hw):
        return pos
    need = new_hw[0] * new_hw[1]
    if use_slice and new_hw[1] == old_hw[1] and need + n_prefix <= pos.shape[0]:
        if old_hw[0] == new_hw[0]:
            return pos[: need + n_prefix]
        start = time_offset_rows * old_hw[1] + n_prefix
        return torch.cat([pos[:n_prefix], pos[start : start + need]], dim=0)
    return interp_pos_grid(pos, old_hw, new_hw, n_prefix)


def interp_conv_kernel_spatial(kernel: torch.Tensor, new_hw: Tuple[int, int]) -> torch.Tensor:
    """kernel: [out_ch, in_ch, kh, kw] (torch's OIHW) -> its spatial resize
    to ``new_hw``; the channels are untouched."""
    if tuple(kernel.shape[2:]) == tuple(new_hw):
        return kernel
    return F.interpolate(kernel, size=tuple(new_hw), mode="bilinear", align_corners=False)
