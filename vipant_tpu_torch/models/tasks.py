"""Task models: compositions of encoder towers and a loss head.

Counterpart of ``vipant_tpu/models/tasks.py`` for CVAP (image-audio) and
CLAP (audio-text retrieval, or audio captioning with a
``SeqGenerationHead`` decoder and its ``LMLossHead``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from ..utils import Registry

from ..nn.heads import normalize

MODELS = Registry("MODELS")


def _encode(tower: nn.Module, x: torch.Tensor, train: bool, require_feature: bool = False):
    """Float rank-2 inputs are precomputed embeddings and are only
    (re-)normalised; token ids (integer rank-2) go through the tower. A
    tower whose params are all frozen runs without autograd. With
    ``require_feature`` the tower returns ``(embedding, feature grid)``."""
    if x.dim() == 2 and x.is_floating_point():
        return normalize(x)
    frozen = not any(p.requires_grad for p in tower.parameters())
    kw = {"require_feature": True} if require_feature else {}
    with torch.no_grad() if frozen else contextlib.nullcontext():
        return tower(x, train=train, normalized=True, **kw)


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

    def features(self, images, audios, train: bool = False):
        return self.encode_image(images, train), self.encode_audio(audios, train)

    def forward(self, images, audios, train: bool = True):
        v = self.encode_image(images, train)
        a = self.encode_audio(audios, train)
        return self.loss(v, a, normalized=True)


@MODELS.register()
class CLAP(nn.Module):
    """Audio <-> text retrieval, or captioning: ``decoder`` is the
    SeqGenerationHead of the captioning branch and ``lm_loss`` its loss; a
    captioning model has no text tower (``text=None``) and no contrastive
    loss."""

    def __init__(self, audio: nn.Module, text: Optional[nn.Module], loss: Optional[nn.Module],
                 decoder: Optional[nn.Module] = None, lm_loss: Optional[nn.Module] = None):
        super().__init__()
        self.audio, self.text, self.loss = audio, text, loss
        self.decoder, self.lm_loss = decoder, lm_loss

    def encode_audio(self, audios, train: bool = False):
        return _encode(self.audio, audios, train)

    def encode_text(self, text, train: bool = False):
        return _encode(self.text, text, train)

    def forward_retrieval(self, audios, text, train: bool = True):
        a = self.encode_audio(audios, train)
        t = self.encode_text(text, train)
        return self.loss(a, t, normalized=True)

    def forward_caption(self, audios, text, train: bool = True):
        if self.decoder is None or self.lm_loss is None:
            raise ValueError("forward_caption needs a decoder and its lm_loss")
        _, feat = _encode(self.audio, audios, train, require_feature=True)
        _, logits = self.decoder(text, feat, time_first=True)
        return self.lm_loss(logits, text[:, 1:])

    def forward(self, audios, text, retrieval: Optional[bool] = None, train: bool = True):
        if retrieval is None:  # a captioning config has no dual text tower
            retrieval = self.text is not None
        if retrieval:
            return self.forward_retrieval(audios, text, train)
        return self.forward_caption(audios, text, train)

    def decode(self, audios, beam: int = 0):
        """KV-cached decode: greedy, or beam search with ``beam`` > 1
        hypotheses. Returns ``(ids [B, max_len_dec + 1], per-step logits)``
        or, for a beam, ``(ids, log-prob of the best beam)``."""
        _, feat = _encode(self.audio, audios, False, require_feature=True)
        if beam and beam > 1:
            return self.decoder.beam_decode_kv(feat, beam=beam)
        return self.decoder.greedy_decode_kv(feat)
