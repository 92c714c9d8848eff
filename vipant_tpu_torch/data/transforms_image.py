"""Host-side image preprocessing (PIL + NumPy).

The port's own copy of the CLIP eval pipeline of
``vipant_tpu/data/transforms_image.py`` (bicubic resize → center crop →
CLIP mean/std, `reference/cvap/data/image/transform.py:11-18`), the item
path of the VA datasets. Outputs are CHW float32 — checkpoint-parity-critical
for the CLIP towers. Not here: the uint8 path and its on-device
normalisation (A8 of ROADMAP.md's queue A) and the siamese multi-view
augmentations (A12). PIL is imported where an image is decoded, so the
package imports without it.
"""

from __future__ import annotations

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


def clip_preprocess(img: "Image.Image", size: int = 224) -> np.ndarray:
    """CLIP eval preprocessing: bicubic resize of the short side + center
    crop + normalize (parity: `reference/cvap/data/image/transform.py:11-18`)."""
    from PIL import Image

    w, h = img.size
    scale = size / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return _to_chw(img)
