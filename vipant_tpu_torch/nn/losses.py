"""Loss heads, forward only.

Counterpart of ``vipant_tpu/nn/losses.py:39-89``: the symmetric InfoNCE
``CELossHead`` with its learnable temperature ``logit_scale`` (initialised
at log 1/0.07, clamped at ``scale_max`` after the exp).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import Registry

LOSS_HEADS = Registry("LOSS_HEADS")

LOGIT_SCALE_INIT = math.log(1.0 / 0.07)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


@LOSS_HEADS.register()
class CELossHead(nn.Module):
    """CE(logits) + CE(logits^T) over the similarity matrix, with
    ``logits = min(exp(logit_scale), scale_max) * x1 . x2^T``."""

    def __init__(self, scaling: bool = True, scale_max: Optional[float] = 100.0, device=None):
        super().__init__()
        self.scale_max = scale_max
        self.logit_scale = (
            nn.Parameter(torch.tensor(LOGIT_SCALE_INIT, device=device)) if scaling else None
        )

    def init_weights(self, generator: torch.Generator) -> None:
        if self.logit_scale is not None:
            nn.init.constant_(self.logit_scale, LOGIT_SCALE_INIT)

    def scale(self) -> torch.Tensor:
        s = self.logit_scale if self.logit_scale is not None else torch.zeros(())
        s = torch.exp(s.float())
        if self.scale_max is not None:
            s = torch.clamp(s, max=self.scale_max)
        return s

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, normalized: bool = False) -> torch.Tensor:
        if not normalized:
            x1, x2 = l2_normalize(x1), l2_normalize(x2)
        logits = self.scale().to(x1.device) * torch.matmul(x1.float(), x2.float().t())
        labels = torch.arange(x1.shape[0], device=x1.device)
        return F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels)


def build_loss_head(cfg, device=None) -> nn.Module:
    if cfg.name != "CELossHead":
        raise NotImplementedError(f"loss head {cfg.name!r} is not ported yet (CELossHead only)")
    scale_max = cfg.get("scale_max")
    return LOSS_HEADS.get(cfg.name)(
        scaling=bool(cfg.get("scaling", True)),
        scale_max=None if scale_max is None else float(scale_max),
        device=device,
    )
