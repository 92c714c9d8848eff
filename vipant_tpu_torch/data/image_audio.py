"""Vision-audio (VA) pre-training datasets, their collator and their loader.

The port's own copy of ``vipant_tpu/data/image_audio.py`` for the raw
wav + frame ("src") and precomputed-fbank ("npz") datasets. Index
convention parity with the reference
(`reference/cvap/data/image_audio.py`): JSONL records
``{"id", "dir", "aclip": [ext], <frame_key>: ext | [exts]}``; media at
``{data_root}/{dir}/{aclip|frame_key}/{id}.{ext}``. Supports precomputed
frame embeddings, the random-frame-at-train / middle-frame-at-eval policy,
a zero image for a record without a frame, and graceful degradation to a
random image on corrupt files.

Shipping formats for the device frontend (the trainer's
``device_frontend``): ``running.audio.on_device`` stops the audio item at a
fixed-length cropped waveform (fp32, or int16 PCM with
``running.audio.wav_int16``), which the card turns into the fbank
(:mod:`vipant_tpu_torch.ops.fbank`); ``running.image_uint8`` ships the
resized and cropped frame as uint8, normalised on the card; the npz
dataset's ``running.audio.ship_int16`` and ``ship_bf16`` ship the
normalised fbank as int16 codes (:data:`FBANK_INT16_SCALE`) or as bf16 (its
bits as uint16: this package does not need ``ml_dtypes``).

The two-view siamese dataset (``running.multi_view``,
:class:`ImageAudioDatasetSiameseSrc`) and the packed ``pak*`` datasets
(:mod:`.packed`) are routed by :func:`build_image_audio_dataloader`. A
siamese record without a frame gets a zero pivot and zero views, as the
single-view path gives a zero image (the JAX package's siamese item opens
``None`` there and falls back to a random image drawn from the global RNG).

Refused by :func:`refuse_unported`: ``on_device`` with ``dither`` or
``use_energy``, which the device fbank does not compute.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..ops.fbank_np import FbankParams
from .indexfile import eval_sample_limit, load_jsonl, shard_for_host
from .loader import DataLoader
from .transforms_audio import (AUDIOSET_FBANK_MEAN, AUDIOSET_FBANK_STD, VIEW_SENTINEL, FbankViews,
                               extract_fbank_features, make_transform)
from .transforms_image import (AuthenticImageViews, SharedImageTransform, clip_preprocess,
                               clip_preprocess_uint8)


def refuse_unported(run) -> None:
    """Raise ``NotImplementedError`` for a ``running`` config that asks for
    what the device fbank would compute otherwise than the host one."""
    audio = run.get("audio", None) or {}
    if bool(audio.get("on_device", False)):
        if float(audio.get("dither", 0.0)) != 0.0:
            raise NotImplementedError(
                f"running.audio.on_device with running.audio.dither={audio.get('dither')}: the "
                "device fbank applies no dither while the host fbank does (the JAX package's "
                "device fbank ignores it silently); set dither=0 or on_device=False")
        if bool(audio.get("use_energy", False)):
            raise NotImplementedError(
                "running.audio.on_device with running.audio.use_energy: the device fbank "
                "computes no energy term")


def fbank_params_from_cfg(acfg, sample_rate: int = 16000) -> FbankParams:
    return FbankParams(
        sample_rate=int(acfg.get("sample_rate", sample_rate)),
        frame_shift_ms=float(acfg.get("frame_shift", 10)),
        frame_length_ms=float(acfg.get("frame_length", 25)),
        num_mel_bins=int(acfg.get("num_mel_bins", 128)),
        window_type=str(acfg.get("window_type", "hanning")),
        dither=float(acfg.get("dither", 0.0)),
        htk_compat=bool(acfg.get("htk_compat", True)),
        use_energy=bool(acfg.get("use_energy", False)),
    )


class ImageAudioDatasetSrc:
    """Raw wav + frame dataset
    (parity: `reference/cvap/data/image_audio.py:104-219`)."""

    def __init__(self, cfg, data_name: str, train: bool):
        self.cfg = cfg
        self.train = train
        index = os.path.join(cfg.data_root, f"{data_name}.jsonl")
        limit = None if train else eval_sample_limit(cfg.get("eval_samples"))
        self.records = load_jsonl(index, limit=limit)
        if train and 0.0 < float(cfg.get("train_samples", 1.0)) < 1.0:
            k = int(len(self.records) * float(cfg.train_samples))
            order = np.random.permutation(len(self.records))[:k]
            self.records = [self.records[i] for i in order]
        if not self.records:
            raise ValueError(
                f"no records in `{index}` (empty or fully-filtered index)"
            )
        self.aclip_key = "clip" if "clip" in self.records[0] else "aclip"
        self.frame_key = cfg.get("frame_key", "frame")
        acfg = cfg.audio
        self.params = fbank_params_from_cfg(acfg)
        self.norms = tuple(acfg.get("norms", []) or []) or None
        self.transform_audio, self.transform_fbank = make_transform(acfg)
        self.acfg = acfg
        # the featurisation runs on the card: the item stops at a cropped waveform
        self.on_device = bool(acfg.get("on_device", False))
        # ship uint8 frames; the CLIP normalisation runs on the card
        self.image_uint8 = bool(cfg.get("image_uint8", False))

    def __len__(self) -> int:
        return len(self.records)

    def _paths(self, index: int):
        rec = self.records[index]
        sub = rec.get("dir", "")
        sub = f"{sub}/" if sub else ""
        name = rec["id"]
        aclip = rec[self.aclip_key]
        aclip = aclip[0] if isinstance(aclip, list) else aclip
        aclip_file = f"{self.cfg.data_root}/{sub}{self.aclip_key}/{name}.{aclip}"

        frame = rec.get(self.frame_key)
        frame_emb_file = None
        if frame is None:
            frame_file = None
        elif isinstance(frame, str):
            frame_file = f"{self.cfg.data_root}/{sub}{self.frame_key}/{name}.{frame}"
            if self.cfg.get("frame_emb") is not None:
                stem = frame.rsplit(".", 1)[0]
                frame_emb_file = f"{self.cfg.data_root}/{self.cfg.frame_emb}/{name}.{stem}.npz"
        else:
            idx = (
                int(np.random.choice(len(frame)))
                if self.train
                else int(np.ceil(len(frame) / 2)) - 1
            )
            frame_file = f"{self.cfg.data_root}/{sub}{self.frame_key}/{name}.{frame[idx]}"
            if self.cfg.get("frame_emb") is not None:
                stem = frame[idx].rsplit(".", 1)[0]
                frame_emb_file = f"{self.cfg.data_root}/{self.cfg.frame_emb}/{name}.{stem}.npz"
        return name, aclip_file, frame_file, frame_emb_file

    def _open_image(self, fname: str):
        """Fully-decoded PIL image with the corrupt-file → random-image
        fallback (``load()`` forces the decode — PIL ``open`` only reads the
        header, so truncation errors would otherwise surface later, outside
        this fallback)."""
        from PIL import Image as PILImage

        res = int(self.cfg.get("resolution", 224))
        try:
            img = PILImage.open(fname)
            img.load()
            return img
        except Exception as e:  # corrupt → random image, keep training
            warnings.warn(f"use random image because `{e}` {fname}")
            return PILImage.fromarray(
                (np.random.rand(res, res, 3) * 256).astype(np.uint8)
            )

    def _image(self, fname: Optional[str], img=None) -> np.ndarray:
        """The frame ``fname`` (or the decoded ``img``) preprocessed; zeros
        when there is neither."""
        res = int(self.cfg.get("resolution", 224))
        if fname is None and img is None:
            return np.zeros((3, res, res), np.uint8 if self.image_uint8 else np.float32)
        pre = clip_preprocess_uint8 if self.image_uint8 else clip_preprocess
        return pre(self._open_image(fname) if img is None else img, res)

    def _image_emb(self, fname: str) -> np.ndarray:
        try:
            return np.load(fname)["v"].astype(np.float32)
        except Exception as e:
            warnings.warn(f"use random embedding because `{e}` {fname}")
            return np.random.rand(int(self.cfg.embed_dim)).astype(np.float32)

    def _audio(self, fname: str) -> np.ndarray:
        return extract_fbank_features(
            fname,
            self.params,
            max_audio_len=int(self.cfg.max_audio_len),
            train=self.train,
            zero_mean_wf=bool(self.acfg.get("zero_mean_wf", True)),
            tile_audio=bool(self.acfg.get("tile_audio", False)),
            transform_audio=self.transform_audio if self.train else None,
            norms=self.norms,
            transform_fbank=self.transform_fbank if self.train else None,
        )

    def _audio_waveform(self, fname: str) -> Tuple[np.ndarray, int]:
        """Decode, tile (``audio.tile_audio``), augment, crop and zero-mean
        as the host path does, then zero-pad to ``int((max_audio_len / 100 +
        0.05) * sr)`` samples: (the waveform, its true length). The fbank
        runs on the card, which zeroes the frames past the true length as
        the host path's padding does.

        With ``audio.wav_int16`` (and no waveform augmentation run) the
        clip is zero-meaned over its true length before the padding and the
        quantisation, and ships as int16 PCM (half the bytes); the card
        rescales it and removes the sub-LSB DC the rounding leaves. An
        augmented clip may leave [-1, 1] and ships as fp32, since the
        quantisation would clip it."""
        from .transforms_audio import random_crop
        from .wav import read_wav

        wav, sr = read_wav(fname)
        wav = wav[:1]
        max_len = float(self.cfg.max_audio_len)
        tile_to = int((max_len / 100) * sr)
        if bool(self.acfg.get("tile_audio", False)) and tile_to > wav.shape[-1]:
            wav = np.tile(wav, (1, int(np.ceil(tile_to / wav.shape[-1]))))[:, :tile_to]
        if self.train:
            for t in self.transform_audio or []:
                wav = t(wav)
        desired = int((max_len / 100 + 0.05) * sr)
        wav = random_crop(wav, desired, train=self.train)
        if bool(self.acfg.get("zero_mean_wf", True)):
            wav = wav - wav.mean()  # over the true length: a mean over the padding would scale it
        n = min(desired, wav.shape[-1])
        augmented = self.train and bool(self.transform_audio)
        if bool(self.acfg.get("wav_int16", False)) and not augmented:
            out = np.zeros((desired,), np.int16)
            out[:n] = np.clip(np.round(wav[0, :n] * 32767.0), -32768, 32767).astype(np.int16)
        else:
            out = np.zeros((desired,), np.float32)
            out[:n] = wav[0, :n]
        return out, n

    def __getitem__(self, index: int) -> Dict[str, Any]:
        name, aclip_file, frame_file, frame_emb_file = self._paths(index)
        image = (
            self._image_emb(frame_emb_file)
            if frame_emb_file is not None
            else self._image(frame_file)
        )
        item = {"image": image, "name": name}
        if self.on_device:
            item["audio"], item["audio_len"] = self._audio_waveform(aclip_file)
        else:
            item["audio"] = self._audio(aclip_file)
        return item


# int16 scale of the normalised fbanks the npz dataset ships with
# ``ship_int16`` (~N(0, 1) after mean/std): a step of 1/256 ~ 0.004 sigma,
# a range of +-128 sigma; the card multiplies the codes by 1/256
FBANK_INT16_SCALE = 256.0

# what ships to the card as it is and is converted there (uint8 frames,
# int16 waveforms or fbank codes, bf16 fbanks as their uint16 bits)
_SHIP_DTYPES = (np.dtype(np.uint8), np.dtype(np.int16), np.dtype(np.uint16))


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """fp32 -> the bits of its bf16 rounding (to nearest, ties to even) as
    uint16; a NaN becomes the quiet NaN of its sign. The card views them as
    ``torch.bfloat16``."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = ((u + (((u >> 16) & 1) + np.uint32(0x7FFF))) >> 16).astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        bits[nan] = (((u[nan] >> 16) & 0x8000) | 0x7FC0).astype(np.uint16)
    return bits


class ImageAudioDatasetNpz(ImageAudioDatasetSrc):
    """Precomputed-fbank npz dataset (the reference's throughput path,
    `reference/cvap/data/image_audio.py:27-88`): each record's audio
    npz holds the log-mel matrix under "flag"/"feat" keys.

    ``running.audio.ship_bf16``: the normalised fbank ships as bf16 (half
    the bytes; the towers compute in bf16, so nothing is lost there), as its
    uint16 bits. ``running.audio.ship_int16``: as int16 codes of scale
    :data:`FBANK_INT16_SCALE` (half the bytes, a step of 1/256). The card
    converts either to fp32. With ``on_device`` the fbank ships as it is
    (the device frontend passes it), as in the JAX package."""

    def __init__(self, cfg, data_name: str, train: bool):
        super().__init__(cfg, data_name, train)
        self.on_device = False  # the items are precomputed fbanks

    def _audio(self, fname: str) -> np.ndarray:
        stem = fname.rsplit(".", 1)[0]
        data = np.load(stem + ".npz")
        key = "feat" if "feat" in data.files else data.files[0]
        # the npz decompress buffer is freshly owned — convert/normalize
        # without extra copies
        feats = data[key].astype(np.float32, copy=False)
        max_len = int(self.cfg.max_audio_len)
        if self.train and feats.shape[0] > max_len:
            start = np.random.randint(0, feats.shape[0] - max_len + 1)
            feats = feats[start : start + max_len]
        feats = feats[:max_len]
        if feats.shape[0] < max_len:
            feats = np.pad(feats, ((0, max_len - feats.shape[0]), (0, 0)))
        if self.norms is not None:
            np.subtract(feats, np.float32(self.norms[0]), out=feats)
            np.divide(feats, np.float32(self.norms[1]), out=feats)
        if self.train and self.transform_fbank:
            for t in self.transform_fbank:
                feats = t(feats)
        if bool(self.acfg.get("ship_bf16", False)):
            return bf16_bits(feats)
        if bool(self.acfg.get("ship_int16", False)):
            np.multiply(feats, np.float32(FBANK_INT16_SCALE), out=feats)
            np.rint(feats, out=feats)
            np.clip(feats, -32768, 32767, out=feats)
            return feats.astype(np.int16)
        return feats.astype(np.float32, copy=False)


class ImageAudioDatasetSiameseSrc(ImageAudioDatasetSrc):
    """Two views of image and audio for siamese training
    (``vipant_tpu/data/image_audio.py:271-366``; parity:
    `reference/cvap/data/image_audio.py:224-305`): both audio views come
    from ONE fbank extraction (same crop and waveform augmentations) through
    :class:`.transforms_audio.FbankViews` (the hardcoded AudioSet
    normalisation and asymmetric SpecAugment masks), and the second image /
    audio view is made only when the ``vv`` / ``aa`` loss flag is on
    (otherwise the [1, 1, 1] :data:`.transforms_audio.VIEW_SENTINEL` ships,
    as in the reference). The image views draw from Python's ``random``,
    which the loader's process workers seed per item beside NumPy.

    A record without a frame gets a zero pivot (as :meth:`_image` gives)
    and zero views; the JAX package opens ``None`` there and takes a random
    image from the global RNG."""

    def __init__(self, cfg, data_name: str, train: bool, loss_flags=None):
        super().__init__(cfg, data_name, train)
        # running.clip_tf selects the un-augmented CLIP two-view path, like
        # the reference (`reference/cvap/data/image_audio.py:232-237`)
        res = int(self.cfg.get("resolution", 224))
        self.two_view_image = (
            AuthenticImageViews(res)
            if bool(self.cfg.get("clip_tf", False))
            else SharedImageTransform(res)
        )
        self.fbank_views = FbankViews()
        flags = loss_flags or {}
        self.use_vv = bool(flags.get("vv", True))
        self.use_aa = bool(flags.get("aa", False))
        if self.on_device and self.norms is None:
            # the host path's FbankViews hardcodes the reference's AudioSet
            # norms; the device frontend normalizes only from cfg — unset
            # norms would silently train the trunk on raw log-mels. The
            # per-view mask asymmetry (32/200 vs 48/300) also collapses to
            # the cfg-defined sizes under on_device.
            warnings.warn(
                "siamese on_device=True with running.audio.norms unset: the "
                "host two-view path normalizes with the hardcoded AudioSet "
                f"stats — set norms=[{AUDIOSET_FBANK_MEAN},{AUDIOSET_FBANK_STD}] "
                "for parity",
                UserWarning,
            )

    def _audio_views(self, fname: str):
        """(view 1, view 2, the waveforms' true length or None)."""
        if self.on_device:
            # waveforms ship and the fbank runs on the card; two independent
            # crops stand in for the host two-view path. The inactive second
            # view ships the (rank-3) sentinel, which the device frontend
            # passes untouched
            a1, n = self._audio_waveform(fname)
            a2 = self._audio_waveform(fname)[0] if (self.train and self.use_aa) else VIEW_SENTINEL
            return a1, a2, n
        fb = extract_fbank_features(
            fname,
            self.params,
            max_audio_len=int(self.cfg.max_audio_len),
            train=self.train,
            zero_mean_wf=bool(self.acfg.get("zero_mean_wf", True)),
            tile_audio=bool(self.acfg.get("tile_audio", False)),
            transform_audio=self.transform_audio if self.train else None,
            norms=None,  # FbankViews owns the (reference-hardcoded) norms
            transform_fbank=None,  # masks are per-view, below
        )
        return (*self.fbank_views(fb, both=self.use_aa, train=self.train), None)

    def _views(self, img):
        """The two image views of the decoded frame ``img``; zeros (and the
        sentinel where a view is off) when there is no frame."""
        if img is not None:
            return self.two_view_image(img, both=self.use_vv, train=self.train)
        res = int(self.cfg.get("resolution", 224))
        zeros = np.zeros((3, res, res), np.float32)
        return zeros, (zeros.copy() if self.train and self.use_vv else VIEW_SENTINEL)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        name, aclip_file, frame_file, frame_emb_file = self._paths(index)
        # decode the frame jpeg ONCE for pivot and both views (a corrupt
        # frame falls back to the SAME random image for all three)
        img = self._open_image(frame_file) if frame_file is not None else None
        pivot = (
            self._image_emb(frame_emb_file)
            if frame_emb_file is not None
            else self._image(frame_file, img=img)
        )
        v1, v2 = self._views(img)
        a1, a2, n = self._audio_views(aclip_file)
        item = {
            "image": pivot,
            "image_v1": v1,
            "image_v2": v2,
            "audio_v1": a1,
            "audio_v2": a2,
            "name": name,
        }
        if n is not None:
            item["audio_len"] = n
        return item


class ImageAudioCollator:
    """Stack to [B, ...] with the channel axis the towers expect, fp32 but
    for the shipping formats (:data:`_SHIP_DTYPES`), which the card
    converts (parity: `reference/cvap/data/image_audio.py:307-331`);
    ``siamese``: the pivot and the view keys (a view that is off is the
    stacked sentinel [B, 1, 1, 1])."""

    def __init__(self, siamese: bool = False):
        self.siamese = siamese

    def __call__(self, items: List[Dict]) -> Dict[str, np.ndarray]:
        out: Dict[str, Any] = {"name": [it["name"] for it in items]}
        keys = (
            ("image", "image_v1", "image_v2", "audio_v1", "audio_v2")
            if self.siamese
            else ("image", "audio")
        )
        for key in keys:
            arr = np.stack([it[key] for it in items])
            if arr.dtype not in _SHIP_DTYPES:
                # copy=False — a second full-batch copy costs a full pass over
                # the batch on the (serial) collate thread
                arr = arr.astype(np.float32, copy=False)
            if key.startswith("audio") and arr.ndim == 3:
                arr = arr[:, None]  # [B, 1, T, M]
            out[key] = arr
        if "audio_len" in items[0]:  # waveforms: each clip's true length
            out["audio_len"] = np.asarray([it["audio_len"] for it in items], np.int64)
        return out


def build_image_audio_dataloader(
    cfg, data_name: str, train: bool, process_id: int = 0, num_processes: int = 1,
    device_put_fn=None,
):
    """``running.multi_view`` -> the siamese dataset, else the name's prefix:
    ``pak`` (:mod:`.packed`), ``npz`` or src; then the host-sharded loader
    (parity: `reference/cvap/data/image_audio.py:333-375`). The batches
    are host arrays unless ``device_put_fn`` places them
    (:class:`vipant_tpu_torch.data.device_put.PinnedDevicePut`)."""
    run = cfg.running
    refuse_unported(run)
    siamese = bool(run.get("multi_view", False))
    if siamese:
        # view production follows the active loss flags (the reference
        # dataset reads cfg.model.loss directly,
        # `reference/cvap/data/image_audio.py:230`)
        loss_cfg = cfg.get("model", None)
        loss_cfg = loss_cfg.get("loss", None) if loss_cfg is not None else None
        flags = (
            {k: loss_cfg.get(k, None) for k in ("vv", "aa") if loss_cfg.get(k, None) is not None}
            if loss_cfg is not None
            else {}
        )
        ds = ImageAudioDatasetSiameseSrc(run, data_name, train, loss_flags=flags)
    elif data_name.startswith("pak"):
        from .packed import ImageAudioDatasetPak

        ds = ImageAudioDatasetPak(run, data_name, train)
    elif data_name.startswith("npz"):
        ds = ImageAudioDatasetNpz(run, data_name, train)
    else:
        ds = ImageAudioDatasetSrc(run, data_name, train)
    ds.records = shard_for_host(ds.records, process_id, num_processes, train)
    return DataLoader(
        ds,
        batch_size=int(run.batch_size) // max(num_processes, 1),
        collate_fn=ImageAudioCollator(siamese=siamese),
        shuffle=train,
        drop_last=train,
        num_workers=int(cfg.get("num_proc", 4)),
        backend=str(cfg.get("loader_backend", "thread")),
        seed=int(cfg.get("seed", 0)),
        device_put_fn=device_put_fn,
        pad_last=not train,  # fixed eval shapes
    )
