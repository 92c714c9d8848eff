"""The card's half of the shipping formats: uint8 frames to CLIP-normalised
fp32 (counterpart of ``vipant_tpu/data/transforms_image.py:
device_normalize_image``). The data layer's workers never import this
module (it imports torch); the trainer's device frontend does
(:meth:`vipant_tpu_torch.train.Trainer.device_frontend`, which also turns
int16 / bf16 fbanks and waveforms into features).
"""

from __future__ import annotations

import functools

import torch

from ..data.transforms_image import CLIP_MEAN, CLIP_STD


@functools.lru_cache(maxsize=8)
def _clip_consts(device: str):
    """(255, mean [1, 3, 1, 1], std [1, 3, 1, 1]) fp32 on ``device``."""
    as_t = lambda v, shape: torch.tensor(v, dtype=torch.float32).reshape(shape).to(device)
    return as_t(255.0, ()), as_t(CLIP_MEAN, (1, 3, 1, 1)), as_t(CLIP_STD, (1, 3, 1, 1))


def device_normalize_image(x: torch.Tensor) -> torch.Tensor:
    """uint8 [B, 3, H, W] -> ``(x / 255 - mean) / std`` fp32. The divisors
    are tensors on the device: CUDA divides by a Python scalar (or a CPU
    scalar) as a product with its reciprocal, an ulp off the division the
    JAX package does."""
    d255, mean, std = _clip_consts(str(x.device))
    return (x.float() / d255 - mean) / std
