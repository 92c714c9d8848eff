"""Host-side image preprocessing (PIL + NumPy).

The port's own copy of the CLIP eval pipeline of
``vipant_tpu/data/transforms_image.py`` (bicubic resize → center crop →
CLIP mean/std, `reference/cvap/data/image/transform.py:11-18`), the item
path of the VA datasets. Outputs are CHW float32 — checkpoint-parity-critical
for the CLIP towers — or, from :func:`clip_preprocess_uint8`, CHW uint8
whose normalisation runs on the card
(:func:`vipant_tpu_torch.ops.frontend.device_normalize_image`); and the
BYOL/Barlow-style multi-view train augmentations of the siamese dataset
(random resized crop, flip, colour jitter, grayscale, blur, solarisation,
`reference/cvap/data/image/transform.py:20-200`), which draw from Python's
``random`` as the JAX package's do, so that one seed gives both packages the
same views. PIL is imported where an image is decoded, so the package
imports without it.
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _to_chw(img: "Image.Image") -> np.ndarray:
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    # materialize contiguous in the (parallel) item worker: np.stack over
    # transposed HWC *views* pays a large strided-copy penalty in the
    # (serial) collate thread
    return np.ascontiguousarray(arr.transpose(2, 0, 1))


def _resize_crop(img: "Image.Image", size: int) -> "Image.Image":
    """Bicubic resize of the short side to ``size``, then the center crop."""
    from PIL import Image

    w, h = img.size
    scale = size / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def clip_preprocess(img: "Image.Image", size: int = 224) -> np.ndarray:
    """CLIP eval preprocessing: bicubic resize of the short side + center
    crop + normalize (parity: `reference/cvap/data/image/transform.py:11-18`)."""
    return _to_chw(_resize_crop(img, size))


def clip_preprocess_uint8(img: "Image.Image", size: int = 224) -> np.ndarray:
    """The resize and crop of :func:`clip_preprocess` only, CHW uint8: the
    normalisation runs on the card (a quarter of the bytes to copy)."""
    # contiguous here, not in the collator: see _to_chw
    return np.ascontiguousarray(
        np.asarray(_resize_crop(img, size).convert("RGB"), np.uint8).transpose(2, 0, 1))


class GaussianBlur:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img: "Image.Image") -> "Image.Image":
        from PIL import ImageFilter

        if random.random() <= self.p:
            sigma = random.random() * 1.9 + 0.1
            return img.filter(ImageFilter.GaussianBlur(sigma))
        return img


class Solarization:
    def __init__(self, p: float = 0.0):
        self.p = p

    def __call__(self, img: "Image.Image") -> "Image.Image":
        from PIL import ImageOps

        if random.random() <= self.p:
            return ImageOps.solarize(img)
        return img


def _random_resized_crop(
    img: "Image.Image", size: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)
) -> "Image.Image":
    from PIL import Image

    w, h = img.size
    area = w * h
    for _ in range(10):
        target = random.uniform(*scale) * area
        ar = np.exp(random.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            left = random.randint(0, w - cw)
            top = random.randint(0, h - ch)
            return img.crop((left, top, left + cw, top + ch)).resize(
                (size, size), Image.BICUBIC
            )
    return img.resize((size, size), Image.BICUBIC)


def _color_jitter(img: "Image.Image") -> "Image.Image":
    from PIL import ImageEnhance

    for enhancer, rng in (
        (ImageEnhance.Brightness, 0.4),
        (ImageEnhance.Contrast, 0.4),
        (ImageEnhance.Color, 0.2),
    ):
        img = enhancer(img).enhance(1.0 + random.uniform(-rng, rng))
    return img


class TrainImageTransform:
    """Single-view train augmentation: random resized crop + flip
    (the reference's CLIPImageTransform train branch)."""

    def __init__(self, size: int = 224):
        self.size = size

    def __call__(self, img: "Image.Image") -> np.ndarray:
        from PIL import Image

        img = _random_resized_crop(img, self.size, scale=(0.6, 1.0))
        if random.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return _to_chw(img)


class SharedImageTransform:
    """Two-view BYOL/Barlow augmentation
    (parity: `reference/cvap/data/image/transform.py:146-198`
    ``BarlowImageTransform``, the siamese dataset's default): each view is
    RandomResizedCrop + flip + color jitter + grayscale; view 1 is the
    *prime* branch (blur p=0.1, solarize p=0.2), view 2 the heavy branch
    (blur p=1.0, no solarize) and exists only when the ``vv`` loss is on;
    eval returns the deterministic CLIP preprocessing with a sentinel
    second view."""

    def __init__(self, size: int = 224):
        self.size = size

    def _view(self, img: "Image.Image", blur_p: float, solar_p: float) -> np.ndarray:
        from PIL import Image

        img = _random_resized_crop(img, self.size)
        if random.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if random.random() < 0.8:
            img = _color_jitter(img)
        if random.random() < 0.2:
            img = img.convert("L").convert("RGB")
        img = GaussianBlur(blur_p)(img)
        img = Solarization(solar_p)(img)
        return _to_chw(img)

    def __call__(
        self, img: "Image.Image", both: bool = True, train: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        sentinel = np.ones((1, 1, 1), np.float32)
        if not train:
            return clip_preprocess(img, self.size), sentinel
        y1 = self._view(img, 0.1, 0.2)
        y2 = self._view(img, 1.0, 0.0) if both else sentinel
        return y1, y2


class AuthenticImageViews:
    """Both views are the deterministic CLIP eval preprocessing — no
    augmentation at all (parity:
    `reference/cvap/data/image/transform.py:73-96`
    ``AuthenticCLIPImageTransform``, selected by ``running.clip_tf``)."""

    def __init__(self, size: int = 224):
        self.size = size

    def __call__(
        self, img: "Image.Image", both: bool = True, train: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        sentinel = np.ones((1, 1, 1), np.float32)
        y1 = clip_preprocess(img, self.size)
        if not train or not both:
            return y1, sentinel
        return y1, y1.copy()
