"""SpecAugment masking as batched PyTorch ops on the features' device.

Counterpart of ``vipant_tpu/ops/specaugment.py`` (torchaudio's
``FrequencyMasking`` / ``TimeMasking`` as the reference configures them,
`reference/configs/running/audio/default.yaml:17-20`): per item, a width is
drawn uniformly from [0, param), a start uniformly from [0, len - width),
and the band ``start <= pos < start + width`` is filled with
``mask_value``.

The draw is split from the mask arithmetic: :func:`axis_uniforms` draws
the two uniforms of one mask per item from an explicit ``torch.Generator``
(the JAX package draws them from a PRNG key), and :func:`_axis_mask` turns
given uniforms into the mask exactly as the JAX package does
(``width = u * param``, ``start = u' * (len - width)``, in fp32), so the
same uniforms give the same masks in both.

Under data parallelism every rank draws the uniforms of the global batch
from its copy of the train state's generator (the copies are equal) and
masks its own rows with its slice (``shard``), so a step on several ranks
masks as the step on one rank over the same global batch does.
"""

from __future__ import annotations

from typing import Tuple

import torch

Uniforms = Tuple[torch.Tensor, torch.Tensor]


def axis_uniforms(generator: torch.Generator, batch: int) -> Uniforms:
    """(width, start) uniforms in [0, 1), each [batch, 1] fp32, drawn on
    the generator's device."""
    u = torch.rand((2, batch, 1), generator=generator, device=generator.device)
    return u[0], u[1]


def _rows(uniforms: Uniforms, shard: Tuple[int, int], batch: int) -> Uniforms:
    """Shard ``(i, n)``'s ``batch`` rows of uniforms drawn for ``batch * n``."""
    i = shard[0]
    return tuple(u[i * batch:(i + 1) * batch] for u in uniforms)


def _axis_mask(u_width: torch.Tensor, u_start: torch.Tensor, axis_len: int,
               mask_param: int) -> torch.Tensor:
    """[B, axis_len] bool, True where masked."""
    width = u_width * float(mask_param)
    start = u_start * (axis_len - width)
    pos = torch.arange(axis_len, dtype=torch.float32, device=u_width.device)[None, :]
    return (pos >= start) & (pos < start + width)


def freq_mask(feats: torch.Tensor, mask_param: int, uniforms: Uniforms,
              mask_value: float = 0.0) -> torch.Tensor:
    """feats [B, T, M]: one mel band per item masked."""
    m = _axis_mask(*uniforms, feats.shape[2], mask_param)
    return feats.masked_fill(m[:, None, :], mask_value)


def time_mask(feats: torch.Tensor, mask_param: int, uniforms: Uniforms,
              mask_value: float = 0.0) -> torch.Tensor:
    """feats [B, T, M]: one run of frames per item masked."""
    m = _axis_mask(*uniforms, feats.shape[1], mask_param)
    return feats.masked_fill(m[:, :, None], mask_value)


def spec_augment(feats: torch.Tensor, generator: torch.Generator, freq_param: int = 32,
                 time_param: int = 200, mask_value: float = 0.0,
                 shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """A frequency mask, then a time mask, each with its own draws (a
    param of 0 masks nothing and draws nothing); ``shard``: (rank, ranks)
    of these rows in the global batch."""
    B, n = feats.shape[0], shard[1]
    if freq_param:
        u = _rows(axis_uniforms(generator, B * n), shard, B)
        feats = freq_mask(feats, freq_param, u, mask_value)
    if time_param:
        u = _rows(axis_uniforms(generator, B * n), shard, B)
        feats = time_mask(feats, time_param, u, mask_value)
    return feats
