"""Host-side audio transforms (NumPy) and the per-clip frontend.

The port's own copy of ``vipant_tpu/data/transforms_audio.py``, less the
siamese two-view fbank (``FbankViews``; A12 of ROADMAP.md's queue A), with
the fbank always the NumPy one (:mod:`vipant_tpu_torch.ops.fbank_np`; the
JAX package dispatches to its C++ frontend when that is built, which agrees
with the NumPy fbank to ~1e-4, not bitwise).

Capability parity with the reference's waveform/fbank transform stack
(`reference/cvap/data/audio/transform.py`): variance-guarded
random/center crop, flip, linear-resample scale, pad, SNR-targeted noise,
SpecAugment-style masking, and the full
``decode → crop → fbank → pad → normalize → mask`` item path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.fbank_np import FbankParams, fbank as host_fbank
from .wav import read_wav


# ---------------------------------------------------------------------------
# waveform transforms
# ---------------------------------------------------------------------------


def random_crop(x: np.ndarray, output_len: int, train: bool, rng=np.random) -> np.ndarray:
    """Variance-guarded crop: prefer the random/center window, but fall back
    to the head (then tail) window if the chosen crop is too quiet
    (parity: `reference/cvap/data/audio/transform.py:122-141`)."""
    if x.shape[-1] <= output_len:
        return x
    if train:
        left = int(rng.randint(0, x.shape[-1] - output_len))
    else:
        left = int(round(0.5 * (x.shape[-1] - output_len)))
    old_std = float(x.std()) * 0.5
    cropped = x[..., left : left + output_len]
    new_std = float(cropped.std())
    if new_std < old_std:
        cropped = x[..., :output_len]
    out_std = float(cropped.std())
    if old_std > new_std > out_std:
        cropped = x[..., -output_len:]
    return cropped


class RandomFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if np.random.rand() <= self.p:
            x = x[..., ::-1].copy()
        return x


class RandomScale:
    """Random time-stretch by linear interpolation
    (parity: `reference/cvap/data/audio/transform.py:93-114`)."""

    def __init__(self, scale: float = 1.5, keep_len: bool = False):
        self.scale = scale
        self.keep_len = keep_len

    def __call__(self, x: np.ndarray) -> np.ndarray:
        scaling = np.power(self.scale, np.random.uniform(-1, 1))
        out_len = int(x.shape[-1] * scaling)
        base = np.arange(out_len, dtype=np.float64) / scaling
        ref1 = base.astype(np.int64)
        ref2 = np.minimum(ref1 + 1, x.shape[-1] - 1)
        r = (base - ref1).astype(x.dtype)
        y = (1 - r) * x[..., ref1] + r * x[..., ref2]
        if self.keep_len:
            y = random_crop(y, x.shape[-1], True)
        return y


class RandomCrop:
    def __init__(self, output_len: int = 44100, train: bool = True):
        self.output_len = output_len
        self.train = train

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return random_crop(x, self.output_len, self.train)


class RandomPad:
    """Pad to length with edge-mean values, random/center placement
    (parity: `reference/cvap/data/audio/transform.py:146-176`)."""

    def __init__(self, output_len: int = 88200, train: bool = True, padding_value=None):
        self.output_len = output_len
        self.train = train
        self.padding_value = padding_value

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if x.shape[-1] >= self.output_len:
            return x
        gap = self.output_len - x.shape[-1]
        left = int(np.random.randint(0, gap)) if self.train else int(round(0.5 * gap))
        right = gap - left
        if self.padding_value is not None:
            lv = rv = self.padding_value
        else:
            lv = float(x[..., 0].mean())
            rv = float(x[..., -1].mean())
        shape = x.shape[:-1]
        return np.concatenate(
            [
                np.full(shape + (left,), lv, dtype=x.dtype),
                x,
                np.full(shape + (right,), rv, dtype=x.dtype),
            ],
            axis=-1,
        )


class RandomNoise:
    """Additive gaussian noise at a random SNR
    (parity: `reference/cvap/data/audio/transform.py:178-202`)."""

    def __init__(self, snr_min_db: float = 10.0, snr_max_db: float = 120.0, p: float = 0.25):
        self.snr_min_db = snr_min_db
        self.snr_max_db = snr_max_db
        self.p = p

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if np.random.rand() > self.p:
            return x
        target_snr = np.random.rand() * (self.snr_max_db - self.snr_min_db + 1.0) + self.snr_min_db
        x_watts = float(np.mean(x ** 2))
        x_db = 10 * np.log10(max(x_watts, 1e-12))
        noise_watts = 10 ** ((x_db - target_snr) / 10) + 1e-7
        return x + np.random.normal(0.0, noise_watts ** 0.5, x.shape).astype(x.dtype)


class SimpleRandomNoise:
    def __init__(self, scale: float = 10.0, shift: int = 10, p: float = 0.25):
        self.scale = scale
        self.shift = shift
        self.p = p

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if np.random.rand() > self.p:
            return x
        y = x + np.random.rand(*x.shape).astype(x.dtype) * np.random.rand() / self.scale
        return np.roll(y, np.random.randint(-self.shift, self.shift), axis=-1)


# ---------------------------------------------------------------------------
# fbank-level masks (host path; the on-device path is ops.specaugment)
# ---------------------------------------------------------------------------


class FrequencyMasking:
    def __init__(self, mask_param: int):
        self.mask_param = mask_param

    def __call__(self, feats: np.ndarray) -> np.ndarray:
        """feats: [T, M]."""
        m = feats.shape[1]
        width = np.random.uniform(0.0, self.mask_param)
        start = np.random.uniform(0.0, max(m - width, 0))
        lo, hi = int(start), int(start + width)
        feats = feats.copy()
        feats[:, lo:hi] = 0.0
        return feats


class TimeMasking:
    def __init__(self, mask_param: int):
        self.mask_param = mask_param

    def __call__(self, feats: np.ndarray) -> np.ndarray:
        t = feats.shape[0]
        width = np.random.uniform(0.0, self.mask_param)
        start = np.random.uniform(0.0, max(t - width, 0))
        lo, hi = int(start), int(start + width)
        feats = feats.copy()
        feats[lo:hi, :] = 0.0
        return feats


_TRANSFORMS = {
    "RandomFlip": RandomFlip,
    "RandomScale": RandomScale,
    "RandomCrop": RandomCrop,
    "RandomPad": RandomPad,
    "RandomNoise": RandomNoise,
    "SimpleRandomNoise": SimpleRandomNoise,
    "FrequencyMasking": FrequencyMasking,
    "TimeMasking": TimeMasking,
}


def make_transform(cfg) -> Tuple[Optional[List], Optional[List]]:
    """Build (waveform transforms, fbank transforms) from the audio config's
    ``[name, params]`` lists (parity:
    `reference/cvap/data/audio/transform.py:37-59`, without eval())."""

    def build(items):
        out = []
        for entry in items or []:
            name, params = entry[0], entry[1] if len(entry) > 1 else []
            cls = _TRANSFORMS[name]
            if isinstance(params, dict):
                out.append(cls(**params))
            else:
                out.append(cls(*params))
        return out or None

    wf = build(cfg.get("audio_transforms")) if cfg.get("transform_audio", False) else None
    fb = build(cfg.get("fbank_transforms")) if cfg.get("transform_fbank", False) else None
    return wf, fb


# ---------------------------------------------------------------------------
# the per-clip frontend (item path of SURVEY.md §3.5)
# ---------------------------------------------------------------------------


def extract_fbank_features(
    path_or_wav,
    params: FbankParams,
    max_audio_len: int = 1000,
    train: bool = True,
    mean_channel: bool = False,
    zero_mean_wf: bool = True,
    tile_audio: bool = False,
    transform_audio: Optional[Sequence] = None,
    norms: Optional[Tuple[float, float]] = None,
    transform_fbank: Optional[Sequence] = None,
) -> np.ndarray:
    """wav → [max_audio_len, num_mel_bins] float32
    (parity: `reference/cvap/data/audio/transform.py:12-35` + the
    dataset-side pad/normalize/mask of
    `reference/cvap/data/image_audio.py:183-207`)."""
    if isinstance(path_or_wav, str):
        wav, sr = read_wav(path_or_wav)
    else:
        wav, sr = path_or_wav
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None]
    if mean_channel:
        wav = wav.mean(axis=0, keepdims=True)
    else:
        wav = wav[:1]

    desired = int((max_audio_len / 100) * sr)
    if tile_audio and desired > wav.shape[-1]:
        ntile = int(np.ceil(desired / wav.shape[-1]))
        wav = np.tile(wav, (1, ntile))[:, :desired]
    for t in transform_audio or []:
        wav = t(wav)
    wav = random_crop(wav, int((max_audio_len / 100 + 0.05) * sr), train=train)
    if zero_mean_wf:
        wav = wav - wav.mean()

    feats = host_fbank(wav[0], params)[:max_audio_len]
    if feats.shape[0] < max_audio_len:
        feats = np.pad(feats, ((0, max_audio_len - feats.shape[0]), (0, 0)))
    if norms is not None and len(norms) == 2:
        feats = (feats - norms[0]) / norms[1]
    if train:
        for t in transform_fbank or []:
            feats = t(feats)
    return feats.astype(np.float32)
