"""Task models: compositions of encoder towers and a loss head.

Counterpart of ``vipant_tpu/models/tasks.py`` for CVAP (image-audio) and
CLAP (audio-text retrieval; the captioning decoder is not ported).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..utils import Registry

from ..nn.heads import normalize

MODELS = Registry("MODELS")


def _encode(tower: nn.Module, x: torch.Tensor, train: bool):
    """Float rank-2 inputs are precomputed embeddings and are only
    (re-)normalised; token ids (integer rank-2) go through the tower. A
    tower whose params are all frozen runs without autograd."""
    if x.dim() == 2 and x.is_floating_point():
        return normalize(x)
    frozen = not any(p.requires_grad for p in tower.parameters())
    with torch.no_grad() if frozen else contextlib.nullcontext():
        return tower(x, train=train, normalized=True)


@MODELS.register()
class CVAP(nn.Module):
    """Image <-> audio contrastive model."""

    def __init__(self, image: nn.Module, audio: nn.Module, loss: nn.Module):
        super().__init__()
        self.image, self.audio, self.loss = image, audio, loss

    def encode_image(self, images, train: bool = False):
        return _encode(self.image, images, train)

    def encode_audio(self, audios, train: bool = False):
        return _encode(self.audio, audios, train)

    def forward(self, images, audios, train: bool = True):
        v = self.encode_image(images, train)
        a = self.encode_audio(audios, train)
        return self.loss(v, a, normalized=True)


@MODELS.register()
class CLAP(nn.Module):
    """Audio <-> text retrieval model."""

    def __init__(self, audio: nn.Module, text: nn.Module, loss: nn.Module):
        super().__init__()
        self.audio, self.text, self.loss = audio, text, loss

    def encode_audio(self, audios, train: bool = False):
        return _encode(self.audio, audios, train)

    def encode_text(self, text, train: bool = False):
        return _encode(self.text, text, train)

    def forward(self, audios, text, train: bool = True):
        a = self.encode_audio(audios, train)
        t = self.encode_text(text, train)
        return self.loss(a, t, normalized=True)
