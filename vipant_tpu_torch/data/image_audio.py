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

Refused by :func:`refuse_unported` (ROADMAP.md's queue A names the item
that ports each): the on-device frontend and its int16 / bf16 / uint8
shipping (A8), the two-view siamese dataset (``running.multi_view``, A12)
and the packed ``pak*`` datasets (A11).
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, List, Optional

import numpy as np

from ..ops.fbank_np import FbankParams
from .indexfile import eval_sample_limit, load_jsonl, shard_for_host
from .loader import DataLoader
from .transforms_audio import extract_fbank_features, make_transform
from .transforms_image import clip_preprocess


def refuse_unported(run, data_name: str = "") -> None:
    """Raise ``NotImplementedError`` for a ``running`` config (and dataset
    name) that asks for what the port's VA data layer does not do yet."""
    audio = run.get("audio", None) or {}
    for key in ("on_device", "ship_int16", "ship_bf16"):
        if bool(audio.get(key, False)):
            raise NotImplementedError(
                f"running.audio.{key}: the on-device frontend and its shipping formats are not "
                "ported yet (ROADMAP.md queue A, A8)")
    if bool(run.get("image_uint8", False)):
        raise NotImplementedError(
            "running.image_uint8: uint8 images normalised on the device are not ported yet "
            "(ROADMAP.md queue A, A8)")
    if bool(run.get("multi_view", False)):
        raise NotImplementedError(
            "running.multi_view: the siamese two-view dataset is not ported yet "
            "(ROADMAP.md queue A, A12)")
    if str(data_name).startswith("pak"):
        raise NotImplementedError(
            f"data_name {data_name!r}: the packed datasets (data/packed.py) are not ported yet "
            "(ROADMAP.md queue A, A11)")


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

    def _image(self, fname: Optional[str]) -> np.ndarray:
        res = int(self.cfg.get("resolution", 224))
        if fname is None:
            return np.zeros((3, res, res), np.float32)
        return clip_preprocess(self._open_image(fname), res)

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

    def __getitem__(self, index: int) -> Dict[str, Any]:
        name, aclip_file, frame_file, frame_emb_file = self._paths(index)
        image = (
            self._image_emb(frame_emb_file)
            if frame_emb_file is not None
            else self._image(frame_file)
        )
        audio = self._audio(aclip_file)
        return {"image": image, "audio": audio, "name": name}


class ImageAudioDatasetNpz(ImageAudioDatasetSrc):
    """Precomputed-fbank npz dataset (the reference's throughput path,
    `reference/cvap/data/image_audio.py:27-88`): each record's audio
    npz holds the log-mel matrix under "flag"/"feat" keys."""

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
        return feats.astype(np.float32, copy=False)


class ImageAudioCollator:
    """Stack to [B, ...] fp32 with the channel axis the towers expect
    (parity: `reference/cvap/data/image_audio.py:307-331`)."""

    def __call__(self, items: List[Dict]) -> Dict[str, np.ndarray]:
        out: Dict[str, Any] = {"name": [it["name"] for it in items]}
        for key in ("image", "audio"):
            # copy=False — a second full-batch copy costs a full pass over
            # the batch on the (serial) collate thread
            arr = np.stack([it[key] for it in items]).astype(np.float32, copy=False)
            if key == "audio" and arr.ndim == 3:
                arr = arr[:, None]  # [B, 1, T, M]
            out[key] = arr
        return out


def build_image_audio_dataloader(
    cfg, data_name: str, train: bool, process_id: int = 0, num_processes: int = 1,
    device_put_fn=None,
):
    """Name-prefix dispatch src/npz + host-sharded loader
    (parity: `reference/cvap/data/image_audio.py:333-375`). The batches
    are host arrays unless ``device_put_fn`` places them
    (:class:`vipant_tpu_torch.data.device_put.PinnedDevicePut`)."""
    run = cfg.running
    refuse_unported(run, data_name)
    if data_name.startswith("npz"):
        ds = ImageAudioDatasetNpz(run, data_name, train)
    else:
        ds = ImageAudioDatasetSrc(run, data_name, train)
    ds.records = shard_for_host(ds.records, process_id, num_processes, train)
    return DataLoader(
        ds,
        batch_size=int(run.batch_size) // max(num_processes, 1),
        collate_fn=ImageAudioCollator(),
        shuffle=train,
        drop_last=train,
        num_workers=int(cfg.get("num_proc", 4)),
        backend=str(cfg.get("loader_backend", "thread")),
        seed=int(cfg.get("seed", 0)),
        device_put_fn=device_put_fn,
        pad_last=not train,  # fixed eval shapes
    )
