"""Task models: compositions of encoder towers and a loss head.

Counterpart of ``vipant_tpu/models/tasks.py`` for CVAP (image-audio),
CLAP (audio-text retrieval, or audio captioning with a
``SeqGenerationHead`` decoder and its ``LMLossHead``), and the classifiers
``ASClassifier`` (AudioSet multi-label, with the imagination branch) and
``ESClassifier`` (ESC-50 / US8K x-fold), whose text towers serve zero-shot;
the trimodal ``CVALP`` (image-audio-text), the multi-view siamese ``CVASP``
(a pivot image tower, a view image tower, the audio tower) and the
image-text ``CLVP``. Siamese parameter ties are made on the built model
(:mod:`..nn.tying`), outside these modules.

Under data parallelism the trainer sets ``data_group`` (the data mesh,
:mod:`..parallel.mesh`) and every loss sees the global batch, as the JAX
package's one SPMD program does (``vipant_tpu/train/step.py:1-7``): each
task gathers its embeddings (and labels) over the ranks, with gradient,
before its loss head (:func:`..parallel.gather_batch`), and the captioning
loss normalises by the global token count. Eval paths (``features``,
``encode_*``) stay local.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from ..utils import Registry

from ..nn.heads import normalize
from ..parallel.collectives import gather_batch

MODELS = Registry("MODELS")


class _Task(nn.Module):
    """A task model; ``data_group`` is the data mesh whose ranks' rows the
    loss gathers (None: one device)."""

    data_group = None

    def _global(self, *xs, train: bool = True):
        """Each of ``xs`` (None passes) gathered over the ranks in training;
        as given in eval, which stays local."""
        return tuple(gather_batch(x, self.data_group) if train else x for x in xs)


def _run(tower: nn.Module, x: torch.Tensor, train: bool, **kw):
    """The tower's forward; a tower whose params are all frozen runs
    without autograd."""
    frozen = not any(p.requires_grad for p in tower.parameters())
    with torch.no_grad() if frozen else contextlib.nullcontext():
        return tower(x, train=train, **kw)


def _encode(tower: nn.Module, x: torch.Tensor, train: bool, require_feature: bool = False):
    """Float rank-2 inputs are precomputed embeddings and are only
    (re-)normalised; token ids (integer rank-2) go through the tower. With
    ``require_feature`` the tower returns ``(embedding, feature grid)``."""
    if x.dim() == 2 and x.is_floating_point():
        return normalize(x)
    kw = {"require_feature": True} if require_feature else {}
    return _run(tower, x, train, normalized=True, **kw)


@MODELS.register()
class CVAP(_Task):
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
        v, a = self._global(self.encode_image(images, train), self.encode_audio(audios, train),
                            train=train)
        return self.loss(v, a, normalized=True)


@MODELS.register()
class CLAP(_Task):
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

    def features(self, audios, text, train: bool = False):
        return self.encode_audio(audios, train), self.encode_text(text, train)

    def forward_retrieval(self, audios, text, train: bool = True):
        a, t = self._global(self.encode_audio(audios, train), self.encode_text(text, train),
                            train=train)
        return self.loss(a, t, normalized=True)

    def forward_caption(self, audios, text, train: bool = True):
        if self.decoder is None or self.lm_loss is None:
            raise ValueError("forward_caption needs a decoder and its lm_loss")
        _, feat = _encode(self.audio, audios, train, require_feature=True)
        _, logits = self.decoder(text, feat, time_first=True)
        return self.lm_loss(logits, text[:, 1:], mesh=self.data_group if train else None)

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


@MODELS.register()
class ASClassifier(_Task):
    """AudioSet multi-label classification, with the "imagination" CE
    branch against the image embedding when the loss is an
    ``ImagineAndClassifyLossHead`` and the model has an image tower. The
    loss takes the audio tower's raw (unnormalised) embedding; the image
    tower runs only on that branch; the text tower serves zero-shot."""

    def __init__(self, audio: nn.Module, loss: nn.Module, text: Optional[nn.Module] = None,
                 image: Optional[nn.Module] = None):
        super().__init__()
        self.audio, self.loss, self.text, self.image = audio, loss, text, image

    def encode_audio(self, audios, train: bool = False):
        return _encode(self.audio, audios, train)

    def encode_text(self, text, train: bool = False):
        return _encode(self.text, text, train)

    def forward(self, images, audios, labels, train: bool = True):
        from ..nn.losses import ImagineAndClassifyLossHead

        a = _run(self.audio, audios, train)
        if images is not None and self.image is not None and isinstance(
                self.loss, ImagineAndClassifyLossHead):
            a, labels, v = self._global(a, labels, _encode(self.image, images, train), train=train)
            return self.loss(a, labels, v, train=train)
        a, labels = self._global(a, labels, train=train)
        return self.loss(a, labels, train=train)


@MODELS.register()
class ESClassifier(_Task):
    """ESC-50 / US8K classification on the audio tower's raw embedding; the
    text tower serves zero-shot. ``predictions`` is the argmax of the eval
    logits."""

    def __init__(self, audio: nn.Module, loss: nn.Module, text: Optional[nn.Module] = None):
        super().__init__()
        self.audio, self.loss, self.text = audio, loss, text

    def encode_audio(self, audios, train: bool = False):
        return _encode(self.audio, audios, train)

    def encode_text(self, text, train: bool = False):
        return _encode(self.text, text, train)

    def forward(self, audios, labels, train: bool = True):
        a, labels = self._global(_run(self.audio, audios, train), labels, train=train)
        return self.loss(a, labels, train=train)

    def predictions(self, audios):
        return torch.argmax(self.loss(_run(self.audio, audios, False), train=False), dim=-1)


@MODELS.register()
class CVALP(_Task):
    """Trimodal vision-audio-language training
    (parity: `reference/cvap/model/cvalp.py`): each tower's normalised
    embedding into ``VALCELossHead``."""

    def __init__(self, image: nn.Module, audio: nn.Module, text: nn.Module, loss: nn.Module):
        super().__init__()
        self.image, self.audio, self.text, self.loss = image, audio, text, loss

    def encode_image(self, x, train: bool = False):
        return _encode(self.image, x, train)

    def encode_audio(self, x, train: bool = False):
        return _encode(self.audio, x, train)

    def encode_text(self, x, train: bool = False):
        return _encode(self.text, x, train)

    def features(self, images, audios, text, train: bool = False):
        return (self.encode_image(images, train), self.encode_audio(audios, train),
                self.encode_text(text, train))

    def forward(self, images, audios, text, train: bool = True):
        v, a, l = self._global(*self.features(images, audios, text, train), train=train)
        return self.loss(v, a, l, normalized=True)


@MODELS.register()
class CVASP(_Task):
    """Multi-view siamese VA training
    (parity: `reference/cvap/model/siamese_va.py`): the pivot image through
    ``image``, the augmented image views through ``image_v`` (tied whole to
    ``image``), the audio views through ``audio``, into ``VACELossHead``; a
    view that is off is None."""

    def __init__(self, image: nn.Module, image_v: nn.Module, audio: nn.Module, loss: nn.Module):
        super().__init__()
        self.image, self.image_v, self.audio, self.loss = image, image_v, audio, loss

    def encode_pivot_image(self, images, train: bool = False):
        return _encode(self.image, images, train)

    def encode_audio_view(self, audios, train: bool = False):
        return _encode(self.audio, audios, train)

    def features(self, images, images_v1, audios_v1, images_v2=None, audios_v2=None,
                 train: bool = False):
        """The pivot and audio-view embeddings, the eval's retrieval pair."""
        return self.encode_pivot_image(images, train), self.encode_audio_view(audios_v1, train)

    def forward(self, images, images_v1, audios_v1, images_v2=None, audios_v2=None,
                train: bool = True):
        vp = _encode(self.image, images, train)
        v1 = _encode(self.image_v, images_v1, train)
        a1 = _encode(self.audio, audios_v1, train)
        v2 = _encode(self.image_v, images_v2, train) if images_v2 is not None else None
        a2 = _encode(self.audio, audios_v2, train) if audios_v2 is not None else None
        return self.loss(*self._global(vp, v1, a1, v2, a2, train=train), normalized=True)


@MODELS.register()
class CLVP(_Task):
    """Image <-> text retrieval (parity: `reference/cvap/model/clvp.py`)."""

    def __init__(self, image: nn.Module, text: nn.Module, loss: nn.Module):
        super().__init__()
        self.image, self.text, self.loss = image, text, loss

    def encode_image(self, images, train: bool = False):
        return _encode(self.image, images, train)

    def encode_text(self, text, train: bool = False):
        return _encode(self.text, text, train)

    def features(self, images, text, train: bool = False):
        return self.encode_image(images, train), self.encode_text(text, train)

    def forward(self, images, text, train: bool = True):
        v, t = self._global(*self.features(images, text, train), train=train)
        return self.loss(v, t, normalized=True)
