"""Positional-embedding grid retarget.

Counterpart of ``vipant_tpu/ops/interp.py::interp_pos_grid``: the JAX
package uses ``jax.image.resize(bilinear, antialias=False)``, which is the
half-pixel sampling of torch's ``F.interpolate(mode="bilinear",
align_corners=False)`` used here.
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
