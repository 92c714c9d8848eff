"""Loss heads.

Counterpart of ``vipant_tpu/nn/losses.py``: the symmetric InfoNCE
``CELossHead`` (``:39-89``) with its learnable temperature ``logit_scale``
(initialised at log 1/0.07, clamped at ``scale_max`` after the exp), and the
captioning ``LMLossHead`` (``:416-434``), cross-entropy over the decoder's
logits with the same learnable scale, not clamped.
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


@LOSS_HEADS.register()
class LMLossHead(nn.Module):
    """Captioning cross-entropy over decoder logits [B, T, V] against
    targets [B, T], pad (id 0) ignored: the mean over the non-pad targets
    (over 1 when there is none). With ``scaling`` the logits are multiplied
    by ``exp(logit_scale)`` (initialised at log 1/0.07, never clamped) before
    the fp32 log-softmax."""

    def __init__(self, scaling: bool = True, device=None):
        super().__init__()
        self.logit_scale = (
            nn.Parameter(torch.tensor(LOGIT_SCALE_INIT, device=device)) if scaling else None
        )

    def init_weights(self, generator: torch.Generator) -> None:
        if self.logit_scale is not None:
            nn.init.constant_(self.logit_scale, LOGIT_SCALE_INIT)

    def forward(self, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        logits = logits.float()
        if self.logit_scale is not None:
            logits = torch.exp(self.logit_scale.float()) * logits
        nll = F.cross_entropy(logits.flatten(0, -2), targets.flatten(), reduction="none")
        mask = (targets.flatten() != 0).float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def build_loss_head(cfg, device=None) -> nn.Module:
    if cfg.name == "LMLossHead":
        return LMLossHead(scaling=bool(cfg.get("scaling", True)), device=device)
    if cfg.name != "CELossHead":
        raise NotImplementedError(
            f"loss head {cfg.name!r} is not ported yet (CELossHead, LMLossHead)")
    scale_max = cfg.get("scale_max")
    return LOSS_HEADS.get(cfg.name)(
        scaling=bool(cfg.get("scaling", True)),
        scale_max=None if scale_max is None else float(scale_max),
        device=device,
    )
